"""Cluster manager (ZooKeeper stand-in): membership, failure detection,
epochs, subtree->chain mapping, and the root of lease delegation.

Single object standing in for a replicated coordination service; its own
state changes are journaled to a file so a "cluster-manager restart" test
can recover it. Heartbeats use an injected clock so tests control time.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.obs import MetricsRegistry

HEARTBEAT_TIMEOUT = 1.0  # paper: 1s heartbeat
MANAGER_TTL = 5.0  # paper: lease management expires every 5s


@dataclass
class NodeInfo:
    node_id: str
    last_heartbeat: float = 0.0
    alive: bool = True


class ClusterManager:
    def __init__(self, journal_path: Optional[str] = None,
                 clock=time.monotonic):
        self.nodes: Dict[str, NodeInfo] = {}
        self.epoch = 0
        # per-epoch dirty-path sets (the paper's per-epoch inode bitmaps)
        self.epoch_dirty: Dict[int, set] = {0: set()}
        # subtree -> ordered replica chain [node ids], reserve replicas
        self.subtree_chains: Dict[str, List[str]] = {}
        self.reserves: Dict[str, List[str]] = {}
        # lease manager assignment: subtree -> (node_id, assigned_at)
        self.managers: Dict[str, tuple] = {}
        # nodes whose failure has already been handled this life: a dead
        # node reported by two watchers must not bump the epoch twice
        self._failed_handled: set = set()
        # proc_id -> epoch at which a successor was promoted for it: an
        # old writer incarnation that outlives a partition uses this to
        # fail-stop instead of dueling its own successor (§3.5 fencing)
        self.promotions: Dict[str, int] = {}
        # union of dirty sets for all *closed* epochs >= the cached key
        # (only the current epoch's set still grows — see dirty_since)
        self._dirty_suffix_cache: Dict[int, set] = {}
        self.clock = clock
        self.journal_path = journal_path
        self.metrics = MetricsRegistry("cm")
        self._watchers = []
        if journal_path and os.path.exists(journal_path):
            self._recover()

    # -- journal -------------------------------------------------------------
    def _journal(self, rec: dict) -> None:
        if not self.journal_path:
            return
        os.makedirs(os.path.dirname(self.journal_path), exist_ok=True)
        with open(self.journal_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def _recover(self) -> None:
        with open(self.journal_path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    break  # prefix semantics for the journal too
                if rec["t"] == "chain":
                    self.subtree_chains[rec["subtree"]] = rec["chain"]
                    self.reserves[rec["subtree"]] = rec.get("reserve", [])
                elif rec["t"] == "epoch":
                    self.epoch = rec["epoch"]
                    self.epoch_dirty.setdefault(self.epoch, set())
                elif rec["t"] == "promo":
                    self.promotions[rec["proc"]] = rec["epoch"]
                elif rec["t"] == "mgr":
                    if rec["node"] is None:
                        self.managers.pop(rec["subtree"], None)
                    else:
                        self.managers[rec["subtree"]] = (rec["node"],
                                                         rec["at"])
        # replayed delegations older than the TTL have expired while the
        # manager was down: drop them so the next requester wins afresh
        now = self.clock()
        self.managers = {st: (m, at) for st, (m, at) in
                         self.managers.items() if now - at <= MANAGER_TTL}

    # -- membership ------------------------------------------------------------
    def register(self, node_id: str) -> None:
        self.nodes[node_id] = NodeInfo(node_id, self.clock(), True)

    def watch(self, cb) -> None:
        """cb(event:str, payload) on membership/epoch changes."""
        self._watchers.append(cb)

    def unwatch(self, cb) -> None:
        try:
            self._watchers.remove(cb)
        except ValueError:
            pass

    def _notify(self, event: str, payload) -> None:
        for cb in self._watchers:
            cb(event, payload)

    def heartbeat(self, node_id: str) -> int:
        """Record a heartbeat; the ack carries the current view epoch,
        so a node whose link to the manager works learns of membership
        changes within one heartbeat interval."""
        info = self.nodes.get(node_id)
        if info:
            info.last_heartbeat = self.clock()
        self.metrics.inc("cm.heartbeats")
        return self.epoch

    def check_heartbeats(self,
                         timeout: float = HEARTBEAT_TIMEOUT) -> List[str]:
        """One suspicion sweep on the cluster clock: every node whose
        last heartbeat is older than ``timeout`` is declared failed, and
        the whole batch is handled as ONE membership change (one epoch
        bump) — two nodes lost to the same partition must not cost two
        rounds of invalidation."""
        now = self.clock()
        failed = []
        for info in self.nodes.values():
            if info.alive and now - info.last_heartbeat > timeout:
                info.alive = False
                failed.append(info.node_id)
        if failed:
            self.on_nodes_failed(failed)
        return failed

    # historical name used throughout tests/benches
    check_failures = check_heartbeats

    def alive_nodes(self) -> List[str]:
        return [n for n, i in self.nodes.items() if i.alive]

    # -- epochs (paper §3.4) -----------------------------------------------------
    def bump_epoch(self) -> int:
        self.epoch += 1
        self.metrics.inc("cm.epoch_bumps")
        self.epoch_dirty[self.epoch] = set()
        # the just-closed epoch's set is frozen now: cached suffix
        # unions built before the bump would miss it
        self._dirty_suffix_cache.clear()
        self._journal({"t": "epoch", "epoch": self.epoch})
        self._notify("epoch", self.epoch)
        return self.epoch

    def mark_dirty(self, path: str) -> None:
        self.epoch_dirty[self.epoch].add(path)

    def dirty_since(self, epoch: int) -> set:
        """Paths dirtied in any epoch >= ``epoch``. The union over
        *closed* epochs (everything but the current one) is immutable
        until the next bump/gc, so it is computed once per (epoch, bump)
        and cached — repeated rejoin/invalidation calls cost one set
        union with the live epoch's set, not a rescan of every retained
        epoch."""
        base = self._dirty_suffix_cache.get(epoch)
        if base is None:
            base = set()
            for e, paths in self.epoch_dirty.items():
                if epoch <= e < self.epoch:
                    base |= paths
            self._dirty_suffix_cache[epoch] = base
        return base | self.epoch_dirty.get(self.epoch, set())

    def gc_epochs(self, all_recovered_through: int) -> None:
        for e in [e for e in self.epoch_dirty if e < all_recovered_through]:
            del self.epoch_dirty[e]
        self._dirty_suffix_cache.clear()

    # -- chains / reserves ----------------------------------------------------------
    def set_chain(self, subtree: str, chain: List[str],
                  reserve: Optional[List[str]] = None) -> None:
        self.subtree_chains[subtree] = list(chain)
        self.reserves[subtree] = list(reserve or [])
        self._journal({"t": "chain", "subtree": subtree, "chain": chain,
                       "reserve": reserve or []})

    def chain_for(self, path: str) -> List[str]:
        best = "/"
        for st in self.subtree_chains:
            if path.startswith(st.rstrip("/") + "/") or path == st:
                if len(st) > len(best):
                    best = st
        return self.subtree_chains.get(best,
                                       self.subtree_chains.get("/", []))

    def on_node_failed(self, node_id: str) -> None:
        """Single-failure entry point; see ``on_nodes_failed``."""
        self.on_nodes_failed([node_id])

    def on_nodes_failed(self, node_ids: List[str]) -> None:
        """Epoch bump + chain repair for a *batch* of deaths reported in
        one sweep: ONE epoch bump covers them all (two nodes lost to the
        same partition must not trigger two rounds of cluster-wide
        invalidation), then every affected chain sheds all its dead
        members and promotes warm reserves (§3.5), one per vacancy,
        bounded by the pool. Idempotent per node: a death reported by
        several watchers (or a detection tick racing an explicit report)
        is handled exactly once — the handled mark clears on rejoin so a
        later genuine re-failure is processed again."""
        fresh = [n for n in node_ids if n not in self._failed_handled]
        if not fresh:
            return
        self.metrics.inc("cm.node_failures", len(fresh))
        dead = set(fresh)
        for nid in fresh:
            self._failed_handled.add(nid)
            info = self.nodes.get(nid)
            if info:
                info.alive = False
        self.bump_epoch()
        for st, chain in self.subtree_chains.items():
            lost = [n for n in chain if n in dead]
            if not lost:
                continue
            for nid in lost:
                chain.remove(nid)
            pool = self.reserves.get(st, [])
            # a dead reserve must never be promoted later
            pool[:] = [n for n in pool if n not in dead]
            for _ in lost:
                if not pool:
                    break
                promoted = pool.pop(0)
                chain.append(promoted)
                self._notify("promote", (st, promoted))
            self._journal({"t": "chain", "subtree": st, "chain": chain,
                           "reserve": pool})
        # lease management held by dead nodes expires immediately
        for st, (mgr, _) in list(self.managers.items()):
            if mgr in dead:
                del self.managers[st]
                self._journal({"t": "mgr", "subtree": st, "node": None,
                               "at": self.clock()})
        for nid in fresh:
            self._notify("failed", nid)

    def recruit(self, subtree: str, target: int) -> Optional[str]:
        """Pick a replacement replica for an under-replicated chain and
        append it (at a bumped epoch, so every writer refreshes its
        chain view). Returns the recruited node id, or None when the
        chain is already at ``target``, no candidate exists, or the
        chain is *empty* — a recruiter must never conjure a chain out of
        zero survivors, because an empty-state successor accepting
        writes is exactly the split-brain that loses acked data. The
        caller is responsible for catching the recruit up (delta resync)
        before counting it toward durability."""
        chain = self.subtree_chains.get(subtree)
        if not chain or len(chain) >= target:
            return None
        taken = set(chain) | set(self.reserves.get(subtree, []))
        cand = [n for n, i in self.nodes.items()
                if i.alive and n not in taken]
        if not cand:
            return None
        recruit = cand[0]
        self.metrics.inc("cm.recruits")
        chain.append(recruit)
        self._journal({"t": "chain", "subtree": subtree, "chain": chain,
                       "reserve": self.reserves.get(subtree, [])})
        self.bump_epoch()
        self._notify("recruit", (subtree, recruit))
        return recruit

    def record_promotion(self, proc_id: str) -> None:
        """Journal that a successor was promoted for ``proc_id`` at the
        current epoch. An old incarnation of the same process that later
        observes this epoch (e.g. after a partition heals) must fence
        itself instead of resuming writes beside its successor."""
        self.promotions[proc_id] = self.epoch
        self.metrics.inc("cm.promotions")
        self._journal({"t": "promo", "proc": proc_id, "epoch": self.epoch})

    def on_node_recovered(self, node_id: str) -> None:
        info = self.nodes.get(node_id)
        if info:
            info.alive = True
            info.last_heartbeat = self.clock()
        self._failed_handled.discard(node_id)
        self._notify("recovered", node_id)

    # -- lease-manager delegation (root of the hierarchy) ------------------------------
    def manager_for(self, subtree: str, requester: str) -> str:
        """Assign (or return) the lease manager for a subtree. First
        requester wins locality; assignment expires after MANAGER_TTL so
        management migrates toward current users (paper §3.3)."""
        now = self.clock()
        cur = self.managers.get(subtree)
        if cur is not None:
            mgr, at = cur
            if now - at <= MANAGER_TTL and self.nodes.get(
                    mgr, NodeInfo("x", 0, False)).alive:
                return mgr
        self.managers[subtree] = (requester, now)
        # journaled: a cluster-manager restart must not silently forget
        # delegation — a second node would be handed the same subtree
        # while the first keeps serving leases from its table
        self._journal({"t": "mgr", "subtree": subtree, "node": requester,
                       "at": now})
        return requester

"""AssiseCluster: wires nodes, SharedFS daemons, cluster manager, and
chains into a runnable simulated cluster (used by tests, benchmarks,
and examples).

Failure injection:
  kill_process(ls)          — process crash; NVM log + replica slots live
  kill_node(id)             — node loss (heartbeat timeout -> epoch bump,
                              chain repair, reserve promotion)
  restart_node(id)          — rejoin: epoch-bitmap invalidation + resync
  failover_process(..)      — promote an app onto a warm cache replica
  inject_faults(..)         — install a seeded FaultInjector on the
                              transport (drops/dups/delays/stale handles
                              + named crash points; see faults.py)
"""
from __future__ import annotations

import os
import shutil
import time
from typing import Dict, List, Optional

from repro_torch.core.cluster import ClusterManager
from repro_torch.core.faults import BitRot, FaultInjector
from repro_torch.core.obs import Tracer
from repro_torch.core.sharedfs import SharedFS
from repro_torch.core.store import LibState, recover_process
from repro_torch.core.transport import Transport, with_retries


class AssiseCluster:
    def __init__(self, root_dir: str, *, n_nodes: int = 3,
                 replication: int = 2, n_reserve: int = 0,
                 mode: str = "pessimistic", hot_capacity: int = 1 << 30,
                 log_capacity: int = 1 << 30,
                 dram_capacity: int = 2 << 30,
                 fsync_data: bool = False, clock=time.monotonic,
                 group_commit: bool = False, group_window_s: float = 0.0,
                 digest_workers: int = 1, digest_shards: int = 1,
                 min_replicas: int = 1, degraded_writes: bool = True,
                 auto_rereplicate: bool = False,
                 repl_deadline_s: Optional[float] = None,
                 trace_sampling: float = 1 / 64):
        assert replication + n_reserve <= n_nodes
        self.root = root_dir
        self.mode = mode
        self.replication = replication
        self.log_capacity = log_capacity
        self.dram_capacity = dram_capacity
        self.fsync_data = fsync_data
        self.group_commit = group_commit
        self.group_window_s = group_window_s
        self.digest_workers = digest_workers
        self.digest_shards = digest_shards
        self.min_replicas = min_replicas
        self.degraded_writes = degraded_writes
        # restore the replication factor in the background after chain
        # shrink (recruit + delta resync). Off by default: single-kill
        # tests expect the shrunken chain to persist.
        self.auto_rereplicate = auto_rereplicate
        self.repl_deadline_s = repl_deadline_s
        os.makedirs(root_dir, exist_ok=True)
        self.transport = Transport()
        # op-granular tracing (DESIGN.md §5.5): the tracer ticks on the
        # cluster clock so span timestamps line up with sim time;
        # sampling=0 disables, 1.0 traces every op (tests)
        self.transport.tracer = Tracer(clock=clock,
                                       sampling=trace_sampling)
        self.cm = ClusterManager(os.path.join(root_dir, "cm.journal"),
                                 clock=clock)
        # the manager is reachable only over the transport ("cm"
        # endpoint): heartbeats and lease delegation share fate with the
        # data links, so partitions drive real suspicion
        self.transport.register_endpoint("cm", self.cm)
        self.node_ids = [f"node{i}" for i in range(n_nodes)]
        self.hot_capacity = hot_capacity
        self.sharedfs: Dict[str, SharedFS] = {}
        for i, nid in enumerate(self.node_ids):
            self.cm.register(nid)
            self.sharedfs[nid] = SharedFS(
                nid, os.path.join(root_dir, nid), self.cm, self.transport,
                hot_capacity=hot_capacity,
                is_reserve=(replication <= i < replication + n_reserve),
                fsync_data=fsync_data, group_commit=group_commit,
                group_window_s=group_window_s,
                digest_workers=digest_workers,
                digest_shards=digest_shards)
        chain = self.node_ids[:replication]
        reserve = self.node_ids[replication:replication + n_reserve]
        self.cm.set_chain("/", chain, reserve)
        self.procs: Dict[str, LibState] = {}
        self.dead_nodes = set()
        # crash faults kill the node mid-protocol (see Transport.crashpoint)
        self.transport.on_crash = self.kill_node

    # -- fault injection -------------------------------------------------------
    def inject_faults(self, faults=(), **kw) -> FaultInjector:
        """Install a fault injector on the cluster transport (scheduled
        faults and/or a seeded random adversary — see faults.py) and
        return it for assertions. Replaces any previous injector."""
        inj = FaultInjector(faults, **kw)
        self.transport.install_faults(inj)
        return inj

    def clear_faults(self) -> None:
        self.transport.install_faults(None)

    # -- integrity: at-rest corruption, scrub, counters ------------------------
    def corrupt_at_rest(self, node_id: str, path: str, *,
                        tier: str = "hot", rot: Optional[BitRot] = None,
                        seed: Optional[int] = None) -> bool:
        """Flip one bit of ``path``'s persisted needle in ``node_id``'s
        hot or cold area (seeded; see faults.BitRot). Returns False if
        the path has no needle there."""
        rot = rot or BitRot(seed)
        sfs = self.sharedfs[node_id]
        store = sfs.hot if tier == "hot" else sfs.cold
        return rot.flip_in_store(store, path)

    def corrupt_slot(self, node_id: str, proc_id: str, path: str, *,
                     rot: Optional[BitRot] = None,
                     seed: Optional[int] = None) -> bool:
        """Flip one bit of ``path``'s needle in the replica-slot region
        that ``node_id`` mirrors for ``proc_id``."""
        rot = rot or BitRot(seed)
        slot = self.sharedfs[node_id].slot_for(proc_id)
        return rot.flip_in_slot(slot, path)

    def scrub_all(self, **kw) -> Dict[str, int]:
        """Run one synchronous scrub pass on every alive node; returns
        summed counters (scanned/errors/repaired/disagreements)."""
        total: Dict[str, int] = {}
        for nid in self.node_ids:
            if nid in self.dead_nodes:
                continue
            for k, v in self.sharedfs[nid].scrub_now(**kw).items():
                total[k] = total.get(k, 0) + v
        return total

    def integrity_stats(self) -> Dict[str, int]:
        """Cluster-wide integrity counters: client-side detections and
        verified reads, server-side repairs/scrub results, quarantines."""
        out = {"verified_reads": 0, "corrupt_extents": 0, "repairs": 0,
               "repair_failures": 0, "scrub_repairs": 0, "scrub_errors": 0,
               "scrub_disagreements": 0, "checksum_exchanges": 0,
               "quarantined_segments": 0, "store_repairs": 0}
        for ls in self.procs.values():
            out["verified_reads"] += ls.stats.get("verified_reads", 0)
            out["corrupt_extents"] += ls.stats.get("corrupt_extents", 0)
        for nid, sfs in self.sharedfs.items():
            if nid in self.dead_nodes:
                continue
            for k in ("repairs", "repair_failures", "scrub_repairs",
                      "scrub_errors", "scrub_disagreements",
                      "checksum_exchanges"):
                out[k] += sfs.stats.get(k, 0)
            for area in (sfs.hot, sfs.cold):
                out["quarantined_segments"] += area.quarantined_segments
                out["store_repairs"] += area.repairs
        return out

    # -- processes -------------------------------------------------------------
    def open_process(self, proc_id: str, node_id: Optional[str] = None,
                     subtree: str = "/", chain: Optional[List[str]] = None,
                     **kw) -> LibState:
        node_id = node_id or self.cm.chain_for(subtree + "/x")[0]
        reserves = self.cm.reserves.get("/", [])
        # reserve replicas sit at the chain tail: they receive every
        # update via chain replication (paper S3.5)
        chain = chain or (self.cm.chain_for(subtree + "/x") + reserves)
        ls = LibState(proc_id, self.sharedfs[node_id], chain, reserves,
                      mode=kw.pop("mode", self.mode),
                      log_capacity=kw.pop("log_capacity", self.log_capacity),
                      dram_capacity=kw.pop("dram_capacity",
                                           self.dram_capacity),
                      min_replicas=kw.pop("min_replicas",
                                          self.min_replicas),
                      degraded_writes=kw.pop("degraded_writes",
                                             self.degraded_writes),
                      repl_deadline_s=kw.pop("repl_deadline_s",
                                             self.repl_deadline_s),
                      subtree=subtree, fsync_data=self.fsync_data, **kw)
        self.procs[proc_id] = ls
        return ls

    def kill_process(self, ls: LibState) -> None:
        ls.crash()
        self.procs.pop(ls.proc_id, None)

    def recover_process_local(self, proc_id: str, node_id: str,
                              subtree: str = "/") -> LibState:
        """Process restart on the same node (paper: LibFS recovery)."""
        chain = self.cm.chain_for(subtree + "/x") + \
            self.cm.reserves.get("/", [])
        ls = recover_process(proc_id, self.sharedfs[node_id], chain,
                             mode=self.mode, subtree=subtree)
        self.procs[proc_id] = ls
        return ls

    # -- partitions ---------------------------------------------------------------
    def partition(self, a, b=None, mode: str = "both") -> None:
        """Partition node set ``a`` from ``b`` (default: everything
        else, including the cluster manager — the classic minority
        cut). See ``Transport.partition`` for asymmetric modes."""
        a = [a] if isinstance(a, str) else list(a)
        if b is None:
            b = [n for n in self.node_ids if n not in a] + ["cm"]
        self.transport.partition(a, b, mode=mode)

    def heal_partition(self, a=None, b=None) -> None:
        self.transport.heal(a, b)

    # -- node failure / recovery --------------------------------------------------
    def heartbeat_all(self) -> None:
        """One heartbeat round, over the transport: a node partitioned
        away from the manager cannot refresh its liveness (suspicion
        builds), and a *suspected* node whose heartbeat gets through
        again (partition healed) rejoins — per-epoch invalidation first,
        exactly like a node restart."""
        for nid in self.node_ids:
            if nid in self.dead_nodes:
                continue
            sfs = self.sharedfs[nid]
            try:
                with self.transport.act_as(nid):
                    ep = self.transport.rpc("cm", "heartbeat", nid)
            except Exception:
                continue  # unreachable: the manager's sweep times it out
            info = self.cm.nodes.get(nid)
            if info is not None and not info.alive:
                # suspected-then-healed: everything dirtied since the
                # view it last held must be invalidated before it serves
                sfs.invalidate_since(sfs.view_epoch)
                self.cm.on_node_recovered(nid)
            sfs.observe_epoch(ep)

    def kill_node(self, node_id: str) -> None:
        """Node dies (power loss): DRAM gone, NVM + SSD files survive.
        The node's digest worker dies with it — queued sealed-region
        jobs are abandoned, not run (a dead node must not keep
        digesting into the cluster)."""
        self.sharedfs[node_id].recorder.record("kill", node_id)
        self.dead_nodes.add(node_id)
        self.transport.set_down(node_id)
        for pid, ls in list(self.procs.items()):
            if ls.sfs.node_id == node_id:
                ls.dram.clear()
                self.procs.pop(pid)
        self.sharedfs[node_id].shutdown(abandon=True)

    def detect_failures(self, timeout: float = 1.0) -> List[str]:
        failed = self.cm.check_failures(timeout)
        if self.auto_rereplicate:
            self._rereplicate()
        return failed

    def detect_failures_now(self) -> List[str]:
        """Deterministically time out exactly the injected-dead nodes
        (test/bench convenience; production uses the 1s heartbeat loop).
        Simultaneous deaths are handled as ONE membership change: one
        epoch bump covers the whole batch."""
        self.heartbeat_all()
        failed = [n for n in self.node_ids
                  if n in self.dead_nodes and self.cm.nodes[n].alive]
        if failed:
            self.cm.on_nodes_failed(failed)  # idempotent per death
        if self.auto_rereplicate:
            # every sweep, not only failure sweeps: a chain left short
            # when no candidate was alive refills once nodes rejoin
            self._rereplicate()
        return failed

    # -- background re-replication ------------------------------------------------
    def _rereplicate(self) -> List[str]:
        """Restore the replication factor after membership shrank: for
        each under-replicated chain, recruit one alive spare, then ship
        the catch-up (slot suffixes + namespace delta) from a surviving
        replica on *its digest worker* — off every writer's hot path."""
        recruited: List[str] = []
        for st, chain in list(self.cm.subtree_chains.items()):
            alive = [n for n in chain if n not in self.dead_nodes]
            if not alive or len(chain) >= self.replication:
                continue
            r = self.cm.recruit(st, self.replication)
            if r is None:
                continue
            recruited.append(r)
            rsfs = self.sharedfs[r]
            # the recruit may hold arbitrarily stale cached state from a
            # previous chain life: same rule as a node restart
            rsfs.invalidate_since(rsfs.recovered_epoch)
            src = next(n for n in alive if n != r)
            src_sfs = self.sharedfs[src]
            src_sfs.submit_digest(
                lambda s=src_sfs, t=r: s.rereplicate_to(t),
                key=f"rerepl/{r}")
        return recruited

    def rereplication_settle(self) -> None:
        """Block until queued catch-up shipments have drained."""
        for nid, sfs in self.sharedfs.items():
            if nid not in self.dead_nodes:
                sfs.drain_digests()

    def failover_process(self, proc_id: str, subtree: str = "/", *,
                         fast: bool = True) -> LibState:
        """Restart the app on the first *alive* cache replica.

        ``fast=True`` (the paper's §3.5 promotion, fig15's measured
        path): the replica serves immediately off its slot mirror +
        SharedFS tiers — the undigested slot suffix replays on the
        *background* digest worker, so the critical path is
        O(dirty-since-last-digest) bookkeeping, not O(total state). The
        successor's seqnos continue past the slot's chain-acked
        watermark (max across alive replicas), and its first inline
        digest settles behind the queued slot replay (FIFO), so nothing
        newer can be overwritten by the replay. Leases migrate via the
        epoch bump failure detection already performed: every surviving
        process re-acquires from the new manager on its next op (see
        ``LibState._check_epoch``).

        ``fast=False`` is the legacy synchronous path — drain + digest
        the whole slot before serving — kept as the same-run comparison
        toggle (fig15's "recover-inline" row)."""
        reserves = self.cm.reserves.get("/", [])
        chain = self.cm.chain_for(subtree + "/x") + reserves
        target = next(n for n in chain if n not in self.dead_nodes)
        sfs = self.sharedfs[target]
        # fail-overs are rare: always trace them (not sampled)
        tracer = self.transport.tracer
        ctx = tracer.start("op.failover", target)
        ctx.annotate("failover.target", node=target, proc=proc_id)
        tok = tracer.push(ctx)
        try:
            ls = self._failover_process(proc_id, subtree, fast, chain,
                                        reserves, target, sfs, ctx)
        finally:
            tracer.pop(tok)
        self.procs[proc_id] = ls
        return ls

    def _failover_process(self, proc_id, subtree, fast, chain, reserves,
                          target, sfs, ctx) -> LibState:
        if fast:
            survivors = [n for n in chain
                         if n != target and n not in self.dead_nodes]
            # a replica further down the chain may have acked more than
            # the target if the writer died mid-chain: continue past all
            acked_local = sfs.slot_acked(proc_id)
            acked, best = acked_local, None
            for nid in survivors:
                try:
                    # retried: a transiently dropped probe would
                    # under-report the watermark and collide seqnos
                    a = with_retries(lambda n=nid: self.transport.rpc(
                        n, "slot_acked", proc_id), deadline_s=0.5)
                except Exception:
                    continue
                if a > acked:
                    acked, best = a, nid
            if best is not None:
                # pull the entries that further replica acked but this
                # one never received, so the promoted cut is the maximum
                # acked prefix (O(dirty-since-last-digest) bytes)
                try:
                    data = with_retries(
                        lambda: self.transport.rpc(
                            best, "slot_suffix", proc_id, acked_local),
                        deadline_s=0.5)
                    if data:
                        sfs.slot_for(proc_id).write(None, data)
                except Exception:
                    pass
            sfs.promote_dead_process(proc_id, peers=survivors)
            # journal the succession: any fenced-off predecessor
            # incarnation that later observes this epoch must fail-stop
            # rather than dual-write (see LibState._check_epoch)
            self.cm.record_promotion(proc_id)
            ctx.annotate("failover.lease_migrate", node=target,
                         proc=proc_id)
            ls = LibState(proc_id, sfs, chain, reserves, mode=self.mode,
                          subtree=subtree, fsync_data=self.fsync_data,
                          start_seqno=acked, settle_before_digest=True,
                          min_replicas=self.min_replicas,
                          degraded_writes=self.degraded_writes,
                          repl_deadline_s=self.repl_deadline_s)
        else:
            sfs.recover_dead_process(proc_id)
            self.cm.record_promotion(proc_id)
            ctx.annotate("failover.lease_migrate", node=target,
                         proc=proc_id)
            acked = sfs.slot_acked(proc_id)
            ls = LibState(proc_id, sfs, chain, reserves, mode=self.mode,
                          subtree=subtree, fsync_data=self.fsync_data,
                          start_seqno=acked,
                          min_replicas=self.min_replicas,
                          degraded_writes=self.degraded_writes,
                          repl_deadline_s=self.repl_deadline_s)
        return ls

    # -- observability accessors (DESIGN.md §5.5) -------------------------------
    def set_trace_sampling(self, sampling: float) -> None:
        self.transport.tracer.set_sampling(sampling)

    def flight_recording(self, node_id: str, kind: Optional[str] = None):
        """The node's flight-recorder ring, oldest first — readable
        even after ``kill_node`` (the ring lives in the daemon object,
        which survives for exactly this post-mortem)."""
        return self.sharedfs[node_id].recorder.events(kind)

    def metrics_dump(self) -> Dict[str, dict]:
        """One JSON-able snapshot of every registry on the cluster:
        per-node SharedFS registries (which the node's LibFS processes
        and group-commit coordinator scope into), the transport's wire
        registry, and the cluster manager's."""
        out = {nid: sfs.metrics.to_dict()
               for nid, sfs in self.sharedfs.items()}
        out["transport"] = self.transport.metrics.to_dict()
        out["cm"] = self.cm.metrics.to_dict()
        return out

    def restart_node(self, node_id: str) -> SharedFS:
        """Rejoin after failure: rebuild SharedFS from its persistent
        areas, then invalidate everything written since its epoch."""
        epoch_at_death = self.sharedfs[node_id].recovered_epoch
        self.dead_nodes.discard(node_id)
        self.transport.set_down(node_id, False)
        sfs = SharedFS(node_id, os.path.join(self.root, node_id), self.cm,
                       self.transport, hot_capacity=self.hot_capacity,
                       fsync_data=self.fsync_data,
                       group_commit=self.group_commit,
                       group_window_s=self.group_window_s,
                       digest_workers=self.digest_workers,
                       digest_shards=self.digest_shards)
        self.sharedfs[node_id] = sfs
        sfs.invalidate_since(epoch_at_death)
        self.cm.on_node_recovered(node_id)
        return sfs

    def close(self) -> None:
        for ls in list(self.procs.values()):
            try:
                ls.close()
            except Exception:
                pass
        for nid, sfs in self.sharedfs.items():
            sfs.shutdown(abandon=(nid in self.dead_nodes))

    def destroy(self) -> None:
        self.close()
        shutil.rmtree(self.root, ignore_errors=True)

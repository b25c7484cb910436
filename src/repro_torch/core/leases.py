"""Hierarchical leases (paper §3.3): linearizable sharing with locality.

Read leases are shared; write leases are exclusive; a *subtree* lease on
``/a/b`` covers everything under it. Leases expire (fault tolerance) and
can be revoked with a grace callback that lets the holder flush+digest
before handing off (exactly the paper's revocation protocol).

Delegation is hierarchical: the ClusterManager assigns a *lease manager*
(a SharedFS) per subtree; LibState processes acquire from their local
SharedFS, which forwards to the manager only on first contact — so
node-local sharing synchronizes without any network traffic.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

READ = "r"
WRITE = "w"

LEASE_TTL = 5.0  # seconds (logical); matches the paper's 5s migration tick
_ids = itertools.count(1)


def covers(lease_path: str, path: str) -> bool:
    """Subtree semantics: /a/b covers /a/b and /a/b/c."""
    if lease_path == path:
        return True
    pre = lease_path.rstrip("/") + "/"
    return path.startswith(pre)


def conflicts(a_path: str, a_mode: str, b_path: str, b_mode: str) -> bool:
    if a_mode == READ and b_mode == READ:
        return False
    return covers(a_path, b_path) or covers(b_path, a_path)


@dataclass
class Lease:
    id: int
    path: str
    mode: str
    holder: str  # process or node id
    expires_at: float
    # view epoch at grant time: grants stamped before a membership
    # change are dropped wholesale when the manager's view advances
    # (clients invalidate their caches on the same bump, so nobody
    # keeps operating on a grant the new epoch never saw)
    epoch: int = 0

    def valid(self, now: float) -> bool:
        return now < self.expires_at


@dataclass
class LeaseTable:
    """Grant table with conflict detection + expiry.

    Every hot-path query is indexed — a busy writer grants one lease
    per path it touches, so the table reaches tens of thousands of live
    grants and anything that scans them all turns the put path O(n²)
    over a run:

    - ``find``/``conflicting`` probe the exact path plus its ancestors
      in ``by_path`` (O(depth), not O(grants));
    - descendants come from ``children``, a directory-tree index that
      visits only the lease paths actually under the probe point, not
      every distinct lease path in the table;
    - expiry sweeps are throttled to one full scan per ``_SCAN_EVERY``
      of lease-clock time — queries filter on ``valid()`` themselves,
      so the sweep is garbage collection, not correctness.
    """

    leases: Dict[int, Lease] = field(default_factory=dict)
    by_holder: Dict[str, Dict[int, Lease]] = field(default_factory=dict)
    by_path: Dict[str, Dict[int, Lease]] = field(default_factory=dict)
    # directory index: node path -> child node paths that lead to (or
    # are) live lease paths. Lets the descendant probe walk just the
    # subtree under a path.
    children: Dict[str, set] = field(default_factory=dict)
    _next_scan: float = float("-inf")

    _SCAN_EVERY = 1.0

    @staticmethod
    def _parent(path: str) -> Optional[str]:
        if path == "/":
            return None
        return path.rsplit("/", 1)[0] or "/"

    def _index(self, l: Lease) -> None:
        self.by_holder.setdefault(l.holder, {})[l.id] = l
        self.by_path.setdefault(l.path, {})[l.id] = l
        node, parent = l.path, self._parent(l.path)
        while parent is not None:
            kids = self.children.setdefault(parent, set())
            if node in kids:
                break  # the rest of the chain is already linked
            kids.add(node)
            node, parent = parent, self._parent(parent)

    def _unindex(self, l: Lease) -> None:
        for m, key in ((self.by_holder, l.holder), (self.by_path, l.path)):
            d = m.get(key)
            if d is not None:
                d.pop(l.id, None)
                if not d:
                    del m[key]
        # prune now-empty branches of the directory index
        node = l.path
        while node != "/" and node not in self.by_path \
                and not self.children.get(node):
            self.children.pop(node, None)
            parent = self._parent(node)
            if parent is None:
                break
            kids = self.children.get(parent)
            if kids is not None:
                kids.discard(node)
            node = parent

    def _drop(self, l: Lease) -> None:
        self.leases.pop(l.id, None)
        self._unindex(l)

    def expire(self, now: float) -> List[Lease]:
        dead = [l for l in self.leases.values() if not l.valid(now)]
        for l in dead:
            self._drop(l)
        return dead

    def _maybe_expire(self, now: float) -> None:
        if now >= self._next_scan:
            self._next_scan = now + self._SCAN_EVERY
            self.expire(now)

    def conflicting(self, path: str, mode: str, now: float,
                    exclude_holder: Optional[str] = None) -> List[Lease]:
        self._maybe_expire(now)
        cands: Dict[int, Lease] = {}
        probe = path  # leases whose path covers ours: exact + ancestors
        while True:
            cands.update(self.by_path.get(probe, {}))
            if probe == "/":
                break
            probe = probe.rsplit("/", 1)[0] or "/"
        # leases we would cover: walk only the subtree under path
        stack = list(self.children.get(path, ()))
        while stack:
            node = stack.pop()
            cands.update(self.by_path.get(node, {}))
            stack.extend(self.children.get(node, ()))
        return [l for l in cands.values()
                if l.holder != exclude_holder and l.valid(now)
                and conflicts(l.path, l.mode, path, mode)]

    def find(self, holder: str, path: str, mode: str, now: float):
        probe = path  # a covering lease must sit at path or an ancestor
        while True:
            for l in self.by_path.get(probe, {}).values():
                if (l.holder == holder and l.valid(now)
                        and (l.mode == WRITE or mode == READ)):
                    return l
            if probe == "/":
                return None
            probe = probe.rsplit("/", 1)[0] or "/"

    def grant(self, path: str, mode: str, holder: str, now: float,
              ttl: float = LEASE_TTL, epoch: int = 0) -> Lease:
        l = Lease(next(_ids), path, mode, holder, now + ttl, epoch)
        self.leases[l.id] = l
        self._index(l)
        return l

    def drop_epochs_before(self, epoch: int) -> int:
        """Drop every grant stamped with an older view epoch. No grace
        revocation: holders observe the same epoch bump and clear their
        caches themselves — this is the manager-side half of the same
        invalidation."""
        dead = [l for l in self.leases.values() if l.epoch < epoch]
        for l in dead:
            self._drop(l)
        return len(dead)

    def release(self, lease_id: int) -> None:
        l = self.leases.get(lease_id)
        if l is not None:
            self._drop(l)

    def release_holder(self, holder: str) -> int:
        dead = list(self.by_holder.get(holder, {}).values())
        for l in dead:
            self._drop(l)
        return len(dead)


class LeaseManager:
    """Per-SharedFS lease manager for the subtrees it has been delegated.

    ``revoke_cb(holder, path)`` is invoked to make a holder flush
    (replicate + digest) and drop leases before a conflicting grant — the
    paper's grace-period handoff.
    """

    def __init__(self, owner_id: str,
                 revoke_cb: Callable[[str, str], None]):
        self.owner_id = owner_id
        self.table = LeaseTable()
        self.revoke_cb = revoke_cb
        self.transfers = 0  # lease handoffs (logged; paper: replicated)

    def acquire(self, holder: str, path: str, mode: str, now: float,
                ttl: float = LEASE_TTL, subtree: str = "/",
                epoch: int = 0) -> Lease:
        existing = self.table.find(holder, path, mode, now)
        if existing is not None:
            existing.expires_at = now + ttl  # refresh
            existing.epoch = max(existing.epoch, epoch)
            return existing
        target = path
        if mode == WRITE and subtree not in ("", "/") \
                and covers(subtree, path) \
                and not self.table.conflicting(subtree, mode, now,
                                               exclude_holder=holder):
            # subtree widening (paper §3.3 hierarchical leases): the
            # holder declared this subtree as its working set and nobody
            # else holds anything under it — grant the whole subtree so
            # every further path below it is a holder-side cache hit
            # instead of a manager round trip per path. Contention
            # later revokes the wide grant like any other lease.
            target = subtree
        for l in self.table.conflicting(target, mode, now,
                                        exclude_holder=holder):
            self.revoke_cb(l.holder, l.path)  # grace: flush + handoff
            self.table.release(l.id)
            self.transfers += 1
        return self.table.grant(target, mode, holder, now, ttl, epoch)

    def drop_stale(self, epoch: int) -> int:
        """Membership changed: drop grants from older view epochs."""
        return self.table.drop_epochs_before(epoch)

    def release_all(self, holder: str) -> int:
        return self.table.release_holder(holder)

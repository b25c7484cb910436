"""LibState (the LibFS analogue): process-linked client of CC-NVM.

All IO is function calls against process-local state (kernel-bypass
analogue): writes append to the private update log in "NVM"; reads hit
the log hashtable, then the process DRAM cache, then the node's SharedFS
hot area, then remote replicas (reserve first), then cold storage.

``write(path, data, offset)`` is the byte-range write: only the range
is logged/replicated/digested, and reads assemble latest-wins extents
from the log overlay over whichever tier holds the base value.
``put`` remains the whole-value degenerate case.

The read side is extent-granular too (paper §3.1, Fig. 2b): every tier
serves exact ranges (``get_range``), the remote tier resolves a
``locate`` handle once and then pulls just the requested bytes with an
rkey-guarded one-sided read (no per-read server work, no whole-blob
transfer), ``multiget``/``readahead`` batch cold-path resolution into
one ``locate_batch`` RPC per peer per ``remote_batch`` paths, full
misses park in a negative-lookup cache (epoch/lease invalidated), and
the DRAM cache is a scan-resistant 2Q (see ``DramCache``).

Crash-consistency modes (paper §3):
  pessimistic — fsync() chain-replicates synchronously; acked writes
                survive any single chain-node loss.
  optimistic  — fsync() only persists locally; dsync() coalesces (drops
                superseded updates) and replicates, wrapped in a TXN
                barrier so replicated batches apply atomically.

Digest pipeline (paper §3.1): when the log crosses its threshold the
writer *seals* the active region and hands it to the node's SharedFS
digest worker, then keeps appending — replicate/apply/fan-out/truncate
all happen off the put/write critical path. The writer blocks only when
a second seal arrives before the first digest finished (backpressure).
Leases are cached process-side until they expire or are revoked, so the
steady-state per-op lease cost is one dict probe.
"""
from __future__ import annotations

import threading
import time
import zlib
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from repro_torch.core import log as L
from repro_torch.core.extents import ExtentOverlay
from repro_torch.core.leases import READ, WRITE, covers
from repro_torch.core.log import SealedRegion, UpdateLog
from repro_torch.core.replication import ChainClient
from repro_torch.core.sharedfs import SharedFS
from repro_torch.core.transport import (RpcTimeout, StaleEpoch, StaleHandle,
                                  with_retries)


class WriterFenced(RuntimeError):
    """This writer incarnation is permanently fenced: a receiver
    rejected its epoch (``StaleEpoch``) or the cluster promoted a
    successor for its proc_id while it was unreachable. Every further
    mutation fails — the process must be reopened (a fresh incarnation
    continuing from the chain-acked watermark). Acked data is safe: an
    op that would have acked under the superseded view never acked."""


class DramCache:
    """Scan-resistant process DRAM read cache (2Q / segmented-LRU).

    The seed cache was a plain LRU: one streaming scan (sort spill,
    fileserver sweep) flushed the entire point-read working set, and a
    single value larger than capacity evicted *everything* on ``put``.
    This cache fixes both:

    - two queues: new fills land in a **probationary** queue; only a
      re-reference promotes to the **protected** queue (default 3/4 of
      capacity). A scan's once-touched values churn through probation
      and never displace the re-referenced working set.
    - protected overflow **demotes** its LRU tail back to probation
      (segmented LRU) rather than evicting outright — a demoted entry
      gets one more chance before leaving DRAM.
    - **admission filter**: a value larger than ``admit_frac`` of
      capacity is refused outright (the tiers below serve it ranged);
      refusing admission still drops any stale cached value under the
      same path.
    - hit/miss counting happens in exactly one place (``get``) so
      callers never have to re-adjust counters (the old ``get_range``
      recount hack).

    ``policy="lru"`` restores the seed's single-queue admit-everything
    behavior — the fig14 same-run comparison toggle.
    """

    def __init__(self, capacity_bytes: int, *, protected_frac: float = 0.75,
                 admit_frac: float = 1 / 8, policy: str = "2q"):
        assert policy in ("2q", "lru")
        self.capacity = capacity_bytes
        self.policy = policy
        self.protected_cap = int(capacity_bytes * protected_frac)
        self.admit_limit = (int(capacity_bytes * admit_frac)
                            if policy == "2q" else None)
        self.probation = OrderedDict()
        self.protected = OrderedDict()
        self.bytes = 0
        self.protected_bytes = 0
        self.hits = 0
        self.misses = 0
        self.admit_rejects = 0
        self.promotions = 0
        self.demotions = 0

    def __contains__(self, path: str) -> bool:
        return path in self.protected or path in self.probation

    def paths(self):
        return list(self.protected) + list(self.probation)

    def get(self, path: str) -> Optional[bytes]:
        v = self.protected.get(path)
        if v is not None:
            self.protected.move_to_end(path)
            self.hits += 1
            return v
        v = self.probation.get(path)
        if v is None:
            self.misses += 1
            return None
        self.hits += 1
        if self.policy == "lru":
            self.probation.move_to_end(path)
            return v
        # second reference: promote out of probation (2Q)
        del self.probation[path]
        self.protected[path] = v
        self.protected_bytes += len(v)
        self.promotions += 1
        self._rebalance()
        return v

    def _rebalance(self) -> None:
        """Demote the protected LRU tail into probation MRU until the
        protected queue fits its share of capacity."""
        while self.protected_bytes > self.protected_cap \
                and len(self.protected) > 1:
            p, v = self.protected.popitem(last=False)
            self.protected_bytes -= len(v)
            self.probation[p] = v
            self.demotions += 1

    def put(self, path: str, data: bytes) -> None:
        self.invalidate(path)  # stale value must go even if not admitted
        if self.admit_limit is not None and len(data) > self.admit_limit:
            self.admit_rejects += 1
            return
        self.probation[path] = data
        self.bytes += len(data)
        while self.bytes > self.capacity:
            if self.probation:
                _, v = self.probation.popitem(last=False)
            elif self.protected:
                _, v = self.protected.popitem(last=False)
                self.protected_bytes -= len(v)
            else:
                break
            self.bytes -= len(v)

    def invalidate(self, path: str) -> None:
        v = self.probation.pop(path, None)
        if v is None:
            v = self.protected.pop(path, None)
            if v is not None:
                self.protected_bytes -= len(v)
        if v is not None:
            self.bytes -= len(v)

    def clear(self) -> None:
        self.probation.clear()
        self.protected.clear()
        self.bytes = 0
        self.protected_bytes = 0


class _DigestJob:
    """One sealed region in flight on the SharedFS digest worker.

    Completion is a condition variable, not a polled flag: a writer
    blocked on backpressure (hard-full log waiting out the previous
    digest) sleeps on ``cv`` and is woken by ``finish`` from the digest
    worker — no sleep/poll loop anywhere on the wait path."""

    __slots__ = ("region", "cv", "done", "error", "ctx")

    def __init__(self, region: SealedRegion, ctx=None):
        self.region = region
        self.cv = threading.Condition()
        self.done = False
        self.error: Optional[BaseException] = None
        # trace context riding the writer->digest-worker thread handoff
        # (the in-process analogue of copying the _trace RPC header)
        self.ctx = ctx

    def finish(self, error: Optional[BaseException] = None) -> None:
        with self.cv:
            if error is not None and self.error is None:
                self.error = error
            self.done = True
            self.cv.notify_all()

    def wait(self, timeout: Optional[float] = None) -> bool:
        with self.cv:
            if timeout is None:
                while not self.done:
                    self.cv.wait()
            elif not self.done:
                self.cv.wait(timeout)
            return self.done


class LibState:
    def __init__(self, proc_id: str, sharedfs: SharedFS, chain: List[str],
                 reserves: Optional[List[str]] = None, *,
                 mode: str = "pessimistic", log_capacity: int = 1 << 30,
                 dram_capacity: int = 2 << 30, subtree: str = "/",
                 fsync_data: bool = False, pipeline_digests: bool = True,
                 one_sided_reads: bool = True, remote_batch: int = 32,
                 start_seqno: int = 0, settle_before_digest: bool = False,
                 group_commit: bool = True, verify_reads: bool = True,
                 min_replicas: int = 1, degraded_writes: bool = True,
                 repl_deadline_s: Optional[float] = None):
        assert mode in ("pessimistic", "optimistic")
        self.proc_id = proc_id
        self.sfs = sharedfs
        self.cluster = sharedfs.cluster
        self.transport = sharedfs.transport
        self.mode = mode
        self.subtree = subtree
        # start_seqno: failover continuation — the successor's seqnos
        # must start past every replica slot's acked watermark, or the
        # slots' seqno dedup would silently drop all its replication
        self.log = UpdateLog(
            f"{sharedfs.root}/nvm/proc/{proc_id}.log", log_capacity,
            fsync_data, start_seqno=start_seqno)
        self.dram = DramCache(dram_capacity)
        peers = [n for n in chain if n != sharedfs.node_id]
        # every ship carries the node's current view epoch (fencing) and
        # partition-era retries are bounded by a total-elapsed deadline
        self.chain = ChainClient(proc_id, peers, sharedfs.transport,
                                 owner=sharedfs.node_id,
                                 epoch_fn=lambda: sharedfs.view_epoch,
                                 deadline_s=repl_deadline_s)
        # under-replication policy: a write needs min_replicas copies
        # (the local log counts as one); degraded_writes=True acks
        # degraded and counts it, False blocks with bounded retries
        self.min_replicas = min_replicas
        self.degraded_writes = degraded_writes
        self._repl_deadline_s = repl_deadline_s
        # non-None once this incarnation is fenced (see WriterFenced)
        self._fenced: Optional[str] = None
        # one-shot barrier for fast promotion: the predecessor's slot
        # suffix is replaying on the node's digest worker, and the first
        # inline digest must not apply *newer* entries to the areas
        # before that older suffix lands (see promote_dead_process)
        self._settle_before_digest = settle_before_digest
        # epoch watermark for lease/chain migration (see _check_epoch) —
        # tracks the NODE's view, not the manager's global epoch: a
        # partitioned node can only act on what it actually observed
        self._epoch_seen = sharedfs.view_epoch
        self._start_epoch = sharedfs.view_epoch
        self.reserves = [n for n in (reserves or [])
                         if n != sharedfs.node_id]
        # remote read tier: reserves first (paper §3.5 — their NVM holds
        # colder state by design), then chain replicas; deduped and
        # never the local node (its tiers were already walked)
        seen = set()
        self.read_peers = [n for n in self.reserves + self.chain.chain
                           if n != sharedfs.node_id
                           and not (n in seen or seen.add(n))]
        # one_sided_reads=False restores the pre-fig14 whole-blob
        # read_remote RPC per peer (the same-run comparison toggle)
        self.one_sided_reads = one_sided_reads
        # verify_reads=False trusts one-sided payloads as pulled (the
        # fig18 overhead-comparison toggle); on, every pull with a
        # checksum descriptor is verified client-side before a byte of
        # it is returned or cached
        self.verify_reads = verify_reads
        self.remote_batch = remote_batch
        # negative-lookup cache: paths known absent below L1 at a given
        # cluster epoch. An entry short-circuits the remote peer walk;
        # it is dropped on any local mutation of the path, on any fresh
        # (non-cached) lease grant covering it — a lease handoff is how
        # another writer's new data becomes visible — on revocation, and
        # implicitly by an epoch bump (membership change).
        self._neg: Dict[str, int] = {}
        for n in peers:
            sharedfs._rpc(n, "ensure_slot", proc_id, fenced=True)
        sharedfs.local_procs[proc_id] = self
        self.digest_threshold = 0.75
        # pipeline state: threshold digests run on the SharedFS worker
        # (pipeline_digests=False restores the old inline behavior —
        # the fig13 same-run comparison toggle)
        self.pipeline_digests = pipeline_digests
        # group commit: route fsync/dsync through the node coordinator
        # when the SharedFS runs one (opt-in at cluster construction);
        # per-process opt-out keeps the legacy path for comparisons
        self._group_commit = group_commit
        self._inflight: Optional[_DigestJob] = None
        # serializes chain replication (writer fsync/dsync vs the digest
        # worker) so the replicated stream stays a seqno-ordered prefix
        self._repl_lock = threading.RLock()
        # lease cache: lease_path -> (mode, expires_at); consulted per
        # op, dropped on revocation/expiry (paper §3.3)
        self._lease_cache: Dict[str, Tuple[str, float]] = {}
        # per-process counters live in the NODE's metrics registry
        # (``node.metrics``) under a proc-scoped prefix; this mapping
        # view keeps the legacy dict API at every increment site
        self.metrics = sharedfs.metrics
        self.tracer = sharedfs.transport.tracer
        self._optrace = None  # pending write trace: put..fsync..digest
        self.stats = self.metrics.scoped(
            f"proc.{proc_id}.",
            seed=("puts", "range_writes", "gets",
                  "l1_hits", "l2_hits", "remote_hits",
                  "neg_hits", "stale_handles", "multigets",
                  "digests", "inline_digests", "bg_digests",
                  "seals", "backpressure_waits", "seal_deferrals",
                  "coalesced_out", "lease_cache_hits", "lease_acquires",
                  "verified_reads", "corrupt_extents",
                  "degraded_acks", "replica_waits",
                  "epoch_invalidations"))

    # -- epoch migration (paper §3.4: leases migrate via the epoch bump) ------
    def _check_epoch(self) -> None:
        """Two int compares on the no-change fast path. On an epoch bump
        (membership changed): drop cached leases — the manager that
        granted them may be dead, and the new manager has no record of
        them, so every grant must be re-acquired (this IS the lease
        migration; revocation-based invalidation cannot reach us from a
        dead manager's table) — drop DRAM/negative caches that could
        hide a failed-over writer's changes, and re-resolve the replica
        chain so replication targets the repaired membership instead of
        raising NodeDown at a dead replica forever.

        The watermark is the NODE's view epoch — advanced only by
        channels that reached it (heartbeat acks, epoch headers, a
        reachable manager watch) — so a partitioned writer keeps its old
        view and is fenced by receivers, never silently 'migrated'. On
        observing a bump, a promotion recorded for this proc_id at a
        newer epoch than this incarnation started at means a successor
        took over while we were unreachable: fail-stop permanently."""
        self._fence_check()
        ep = self.sfs.view_epoch
        if ep == self._epoch_seen:
            return
        self._epoch_seen = ep
        promo = self.cluster.promotions.get(self.proc_id)
        if promo is not None and promo > self._start_epoch:
            self._fence(f"superseded: successor promoted at epoch "
                        f"{promo} (this incarnation started at "
                        f"{self._start_epoch})")
        # membership changed: caches are *invalidated*, and the bump is
        # counted — hit/miss denominators are never zeroed, so hit-rate
        # math stays honest across epoch changes
        self.stats["epoch_invalidations"] += 1
        self._lease_cache.clear()
        self._neg.clear()
        self.dram.clear()
        self._refresh_chain()

    def _fence(self, why: str) -> None:
        self._fenced = why
        self._lease_cache.clear()
        raise WriterFenced(f"{self.proc_id}: {why}")

    def _fence_check(self) -> None:
        if self._fenced is not None:
            raise WriterFenced(f"{self.proc_id}: {self._fenced}")

    def _refresh_chain(self) -> None:
        me = self.sfs.node_id
        chain = self.cluster.chain_for(self.subtree.rstrip("/") + "/x")
        reserves = self.cluster.reserves.get("/", [])
        seen = set()
        self.chain.chain = [n for n in list(chain) + list(reserves)
                            if n != me and not (n in seen or seen.add(n))]
        # drop any parked sender error and rewind the submitted
        # watermark: the unacked range re-ships to the repaired chain
        self.chain.reset()
        self.reserves = [n for n in reserves if n != me]
        seen = set()
        self.read_peers = [n for n in self.reserves + self.chain.chain
                           if n != me and not (n in seen or seen.add(n))]

    # -- leases ---------------------------------------------------------------
    def _lease(self, path: str, mode: str) -> None:
        self._check_epoch()
        now = self.cluster.clock()
        probe = path
        while True:  # exact path, then each ancestor (subtree leases)
            ent = self._lease_cache.get(probe)
            if ent is not None and now < ent[1] \
                    and (ent[0] == WRITE or mode == READ):
                self.stats["lease_cache_hits"] += 1
                return
            if probe == "/":
                break
            probe = probe.rsplit("/", 1)[0] or "/"
        lpath, lmode, exp = self.sfs.lease_acquire(
            self.proc_id, path, mode, self.subtree)
        self._lease_cache[lpath] = (lmode, exp)
        self.stats["lease_acquires"] += 1
        # a fresh grant may be a handoff from a writer whose flush just
        # made this path appear below: cached negative lookups under the
        # granted subtree are no longer trustworthy
        for p in [p for p in self._neg if covers(lpath, p)]:
            del self._neg[p]

    def lease_subtree(self, path: str) -> None:
        """Acquire an exclusive subtree (directory) lease — e.g. a
        Maildir before delivering into it (paper §3.3)."""
        self._lease(path, WRITE)

    def handle_revocation(self, path: str) -> None:
        """Manager-initiated revocation (grace period): drop every
        cached lease overlapping ``path``, drop DRAM-cached reads under
        it (the new holder is about to write — they would go stale),
        then flush + digest so the next holder sees our updates through
        its SharedFS."""
        for p in [p for p in self._lease_cache
                  if covers(p, path) or covers(path, p)]:
            del self._lease_cache[p]
        for p in self.dram.paths():
            if covers(path, p):
                self.dram.invalidate(p)
        for p in [p for p in self._neg if covers(path, p)]:
            del self._neg[p]
        self.flush_for_revocation()

    # -- tracing ----------------------------------------------------------------
    def _trace_write(self):
        """Sampling decision for the write path. One trace covers the
        whole durability lifecycle of an op: put (append) → fsync
        (replication + ack) → the digest that moves it below the log.
        The later stages attach via the stashed context even when they
        run on coordinator/worker threads; a new trace starts at the
        first append after the previous one acked."""
        tr = self.tracer
        if tr is None:
            return None
        ctx = self._optrace
        if ctx is None or ctx.acked:
            ctx = tr.maybe_trace("op.put", self.sfs.node_id)
            self._optrace = ctx
        return ctx

    def _span(self, name: str, **meta) -> None:
        """Annotate the currently-active trace, if any."""
        tr = self.tracer
        if tr is None:
            return
        ctx = tr.current()
        if ctx is not None:
            ctx.annotate(name, node=self.sfs.node_id, **meta)

    # -- write path -------------------------------------------------------------
    def put(self, path: str, data: bytes) -> None:
        t0 = time.perf_counter()
        self._lease(path, WRITE)
        ctx = self._trace_write()
        self.log.append(L.OP_PUT, path, data)
        self.stats["puts"] += 1
        if ctx is not None:
            ctx.annotate("append", node=self.sfs.node_id, path=path,
                         nbytes=len(data))
        self.dram.invalidate(path)
        self._neg.pop(path, None)
        if self.log.bytes >= self.digest_threshold * self.log.capacity:
            self._threshold_digest()
        self.metrics.observe("op.put.us",
                             (time.perf_counter() - t0) * 1e6)

    def write(self, path: str, data: bytes, offset: int = 0) -> None:
        """Byte-range write (paper §3: IO-operation granularity). Logs,
        replicates, and digests only ``len(data)`` bytes, wherever they
        land inside the object; gaps past the old end read as zeros."""
        t0 = time.perf_counter()
        self._lease(path, WRITE)
        ctx = self._trace_write()
        self.log.append(L.OP_WRITE, path, data, offset)
        self.stats["range_writes"] += 1
        if ctx is not None:
            ctx.annotate("append", node=self.sfs.node_id, path=path,
                         nbytes=len(data), offset=offset)
        self.dram.invalidate(path)
        self._neg.pop(path, None)
        if self.log.bytes >= self.digest_threshold * self.log.capacity:
            self._threshold_digest()
        self.metrics.observe("op.write.us",
                             (time.perf_counter() - t0) * 1e6)

    def _threshold_digest(self) -> None:
        if not self.pipeline_digests:
            self.digest()  # pre-pipeline behavior: digest inline
            return
        job = self._inflight
        if job is not None and not job.done \
                and self.log.bytes < self.log.capacity:
            # a digest is still in flight and the active region has
            # headroom: defer the seal instead of blocking — a slow
            # digest (IO stall) absorbs into headroom, and the next
            # threshold crossing seals a slightly larger region.
            # Hard-full (bytes >= capacity) is the true backpressure
            # point: seal_and_digest below then blocks on the reap.
            self.stats["seal_deferrals"] += 1
            return
        self.seal_and_digest()

    def delete(self, path: str) -> None:
        self._lease(path, WRITE)
        self.log.append(L.OP_DELETE, path)
        self.dram.invalidate(path)

    def rename(self, src: str, dst: str) -> None:
        self._lease(src, WRITE)
        self._lease(dst, WRITE)
        v = self.log.index.get(src, self._MISS)
        if isinstance(v, ExtentOverlay) or v is self._MISS \
                or self.log.sealed is not None:
            # materialize src into the log first: a partial overlay (or a
            # value living only below the log) would otherwise detach
            # from its base when the name moves — the replicated stream
            # then carries PUT(src) + RENAME, and read-your-writes holds
            # for renames of digested data too. A pending seal counts:
            # the reap will truncate the sealed region out from under a
            # rename appended to the active one, so the src value must
            # ride along in the active region.
            full = self.get(src)
            if full is not None:
                self.log.append(L.OP_PUT, src, full)
        self.log.append(L.OP_RENAME, src, dst.encode())
        self.dram.invalidate(src)
        self.dram.invalidate(dst)
        self._neg.pop(src, None)
        self._neg.pop(dst, None)

    def _require_replicas(self) -> None:
        """Enforce ``min_replicas`` before shipping: the local log is
        one copy, the chain supplies the rest. Degraded mode counts and
        proceeds (availability over redundancy — background
        re-replication restores the factor); blocking mode waits with
        bounded retries for the chain to be repaired/recruited, then
        surfaces ``RpcTimeout`` so the caller can decide."""
        need = self.min_replicas - 1
        if need <= 0 or len(self.chain.chain) >= need:
            return
        if self.degraded_writes:
            self.stats["degraded_acks"] += 1
            return
        deadline = self._repl_deadline_s or 0.5
        waited, step = 0.0, 0.01
        while waited < deadline:
            self.stats["replica_waits"] += 1
            time.sleep(step)
            waited += step
            self._check_epoch()  # a repair/recruit bump refreshes chain
            if len(self.chain.chain) >= need:
                return
        raise RpcTimeout(
            f"{self.proc_id}: under-replicated ({1 + len(self.chain.chain)}"
            f" < min_replicas={self.min_replicas}) after {waited:.2f}s")

    def fsync(self) -> None:
        t0 = time.perf_counter()
        self._check_epoch()
        tr = self.tracer
        ctx = self._optrace if tr is not None else None
        tok = tr.push(ctx) if tr is not None else None
        try:
            if self.mode == "pessimistic":
                self._require_replicas()
                gc = getattr(self.sfs, "group_commit", None)
                if gc is not None and self._group_commit:
                    # group path: the coordinator flushes the log to the
                    # OS, makes the batch durable with ONE journal fsync,
                    # and ships one framed chain slice for every co-
                    # committing process — this writer's per-op fsync is
                    # amortized away
                    gc.commit(self, coalesce=False)
                else:
                    self.log.persist()
                    with self._repl_lock:
                        self._replicate(coalesce=False)
            else:
                self.log.persist()
            if ctx is not None:
                ctx.annotate("ack", node=self.sfs.node_id)
                ctx.acked = True
        except StaleEpoch as e:
            self._fence(f"stale epoch on replicate: {e}")
        finally:
            if tr is not None:
                tr.pop(tok)
            self.metrics.observe("op.fsync.us",
                                 (time.perf_counter() - t0) * 1e6)

    def dsync(self) -> None:
        t0 = time.perf_counter()
        self._check_epoch()
        tr = self.tracer
        ctx = self._optrace if tr is not None else None
        tok = tr.push(ctx) if tr is not None else None
        try:
            self._require_replicas()
            gc = getattr(self.sfs, "group_commit", None)
            if gc is not None and self._group_commit:
                gc.commit(self, coalesce=(self.mode == "optimistic"))
            else:
                self.log.persist()
                with self._repl_lock:
                    self._replicate(coalesce=(self.mode == "optimistic"))
            if ctx is not None:
                ctx.annotate("ack", node=self.sfs.node_id)
                ctx.acked = True
        except StaleEpoch as e:
            self._fence(f"stale epoch on replicate: {e}")
        finally:
            if tr is not None:
                tr.pop(tok)
            self.metrics.observe("op.dsync.us",
                                 (time.perf_counter() - t0) * 1e6)

    def _replicate(self, coalesce: bool) -> None:
        """Replicate everything past the chain's watermark — spanning a
        seal boundary if one is pending. Caller holds ``_repl_lock``.
        Any pipelined sealed-region ship is settled first so the slice
        computed here starts exactly where the wire stream left off."""
        self.chain.wait_acked(self.chain.submitted_seqno)
        since = self.chain.submitted_seqno
        pending = self.log.entries_since(since)
        if not pending:
            return
        if coalesce:
            reduced = UpdateLog.coalesce(pending)
            self.stats["coalesced_out"] += len(pending) - len(reduced)
            self.chain.replicate(reduced)
            self.chain.mark_acked(pending[-1].seqno)
        else:
            # zero-copy: ship the log's pre-encoded byte range as-is
            self.chain.replicate(pending, self.log.encoded_since(since))

    # -- read path ------------------------------------------------------------
    _MISS = object()

    def get(self, path: str) -> Optional[bytes]:
        self._lease(path, READ)
        self.stats["gets"] += 1
        tr = self.tracer
        ctx = (tr.maybe_trace("op.get", self.sfs.node_id)
               if tr is not None else None)
        tok = tr.push(ctx) if ctx is not None else None
        try:
            v = self.log.index.get(path, self._MISS)  # L1a: log hashtable
            if v is not self._MISS:
                self.stats["l1_hits"] += 1
                if ctx is not None:
                    ctx.annotate("tier", node=self.sfs.node_id,
                                 tier="l1.log")
                return self._from_log_value(path, v)
            v = self.dram.get(path)  # L1b: process DRAM read cache
            if v is not None:
                self.stats["l1_hits"] += 1
                if ctx is not None:
                    ctx.annotate("tier", node=self.sfs.node_id,
                                 tier="l1.dram")
                return v
            return self._read_below(path)
        finally:
            if ctx is not None:
                tr.pop(tok)

    def _from_log_value(self, path: str, v) -> Optional[bytes]:
        """Materialize a log-hashtable hit (caller counted the L1 hit)."""
        if isinstance(v, ExtentOverlay):
            # extent assembly: undigested ranges over the base from
            # the tiers below (zeros base after a local tombstone).
            # The base is NOT dram-cached: it is stale the moment
            # the overlay digests.
            base = b"" if v.from_zero else (
                self._read_below(path, fill_cache=False) or b"")
            return v.apply_to(base)
        if isinstance(v, bytearray):  # in-place-patched: copy out
            return bytes(v)
        return v  # full value, or a tombstone (None): authoritative

    def _remote_fetch(self, nid: str, path: str, offset: int = 0,
                      length: Optional[int] = None):
        """One remote read: locate + rkey-guarded one-sided read of
        exactly the requested bytes (``length=None``: the whole value).
        With ``one_sided_reads`` off this is the legacy whole-blob
        ``read_remote`` RPC, sliced client-side. Bounded retries absorb
        transient drops — without them a lost locate would demote the
        read to a (possibly staler) next peer or a false miss."""
        def _attempt():
            with self.transport.act_as(self.sfs.node_id):
                return self._remote_fetch_once(nid, path, offset, length)

        return with_retries(_attempt, stats=self.transport.stats)

    def _remote_fetch_once(self, nid: str, path: str, offset: int = 0,
                           length: Optional[int] = None):
        if not self.one_sided_reads:
            found, v = self.transport.rpc(nid, "read_remote", path)
            if not found or v is None or length is None:
                return found, v
            return True, v[offset:offset + length]
        desc = self.transport.rpc(nid, "locate", path, offset, length)
        return self._resolve_desc(nid, path, desc, offset, length)

    def _resolve_desc(self, nid: str, path: str, desc, offset: int,
                      length: Optional[int]):
        """(found, value) from a locate descriptor (see
        ``SharedFS.locate``); stale one-sided handles fall back to the
        ranged read RPC.

        With ``verify_reads`` on and a checksum summary in the
        descriptor, the one-sided pull covers the chunk-aligned
        expansion of the range and is checked client-side with a single
        chained-CRC call before the requested slice is returned — a
        flipped bit at rest or in flight, or a torn payload, raises
        ``CorruptExtent`` internally and the read retries through
        ``read_verified`` (an RPC: its payload is not subject to
        one-sided payload faults, and the serving node read-repairs
        at-rest rot before answering). Corruption is therefore never
        visible to a caller, only to the counters."""
        kind = desc[0]
        if kind == "miss":
            return False, None
        if kind == "tomb":
            return True, None
        if kind == "inline":
            return True, desc[1]
        _, region, off, n, _total, rkey, vsum = desc
        if n == 0:
            return True, b""
        verify = self.verify_reads and vsum is not None
        try:
            if verify:
                head, ext, c0, c1 = vsum
                buf = self.transport.one_sided_read(
                    nid, region, off - head, ext, rkey=rkey)
                # inlined verify_range: this runs once per verified
                # one-sided read and is the fig18 <=1.1x p99 hot path
                if len(buf) != ext or zlib.adler32(buf, c0) != c1:
                    self.stats["corrupt_extents"] += 1
                    self._span("verify", ok=False, peer=nid)
                    return self.transport.rpc(nid, "read_verified",
                                              path, offset, length)
                self.stats["verified_reads"] += 1
                self._span("verify", ok=True, peer=nid)
                return True, bytes(buf[head:head + n])
            return True, self.transport.one_sided_read(nid, region, off,
                                                       n, rkey=rkey)
        except StaleHandle:
            # region memory was reused between locate and read
            # (compaction / slot truncation): re-read via RPC — still
            # ranged, never a whole-blob fallback
            self.stats["stale_handles"] += 1
            if length is None:
                return self.transport.rpc(nid, "read_remote", path)
            return self.transport.rpc(nid, "read_remote_range", path,
                                      offset, length)

    def _read_below(self, path: str,
                    fill_cache: bool = True) -> Optional[bytes]:
        """L2..L4: node-local SharedFS (slots, hot, cold), then remote
        replica NVM via locate + one-sided read. A *found* answer —
        including a tombstone — is authoritative: deleted data must
        never resurrect from a colder tier (see ``SharedFS.read_any``).
        A full miss is remembered in the negative-lookup cache until
        the epoch changes or a lease event invalidates it."""
        found, v = self.sfs.read_any(path)  # L2: node-local SharedFS
        if found:
            if v is not None:
                self.stats["l2_hits"] += 1
                if fill_cache:
                    self.dram.put(path, v)
            self._span("tier", tier="l2")
            return v
        if self._neg.get(path) == self.sfs.view_epoch:
            self.stats["neg_hits"] += 1
            self._span("tier", tier="neg")
            return None
        for nid in self.read_peers:  # L3: remote replica NVM
            try:
                found, v = self._remote_fetch(nid, path)
            except Exception:
                continue
            if found:
                if v is not None:
                    self.stats["remote_hits"] += 1
                    if fill_cache:
                        self.dram.put(path, v)
                self._span("tier", tier="remote", peer=nid)
                return v
        self._span("tier", tier="miss")
        self._neg[path] = self.sfs.view_epoch
        return None

    def _range_below(self, path: str, offset: int, length: int):
        """(found, window) for ``[offset, offset+length)`` from the
        tiers below L1, reading only the requested bytes at every tier
        (local slot/hot/cold preads, then remote ranged one-sided
        reads). Partial windows are NOT dram-cached."""
        found, v = self.sfs.read_range(path, offset, length)
        if found:
            if v is not None:
                self.stats["l2_hits"] += 1
            return True, v
        if self._neg.get(path) == self.sfs.view_epoch:
            self.stats["neg_hits"] += 1
            return False, None
        for nid in self.read_peers:
            try:
                found, v = self._remote_fetch(nid, path, offset, length)
            except Exception:
                continue
            if found:
                if v is not None:
                    self.stats["remote_hits"] += 1
                return True, v
        self._neg[path] = self.sfs.view_epoch
        return False, None

    def get_range(self, path: str, offset: int,
                  length: int) -> Optional[bytes]:
        """Exact-range read through *every* tier: a covering log
        overlay never touches the base, a partial overlay assembles
        over a ranged base window (not the whole value), local areas
        answer with one ``pread`` of the range, and a remote miss pulls
        just the range one-sided. Equivalent to
        ``get(path)[offset:offset+length]``."""
        self._lease(path, READ)
        self.stats["gets"] += 1
        v = self.log.index.get(path, self._MISS)
        if v is not self._MISS:
            self.stats["l1_hits"] += 1
            if isinstance(v, ExtentOverlay):
                r = v.read_range(offset, length)
                if r is not None:
                    return r
                base = b""
                if not v.from_zero:
                    _, win = self._range_below(path, offset, length)
                    base = win or b""
                return v.patch_range(base, offset, length)
            if v is None:
                return None  # tombstone: authoritative
            full = bytes(v) if isinstance(v, bytearray) else v
            return full[offset:offset + length]
        v = self.dram.get(path)
        if v is not None:
            self.stats["l1_hits"] += 1
            return v[offset:offset + length]
        found, win = self._range_below(path, offset, length)
        return win if found else None

    # -- batched reads ---------------------------------------------------------
    def multiget(self, paths: List[str]) -> Dict[str, Optional[bytes]]:
        """Read many paths with batched remote resolution: local tiers
        are walked per path (dict probes / preads), then all misses are
        resolved against each peer with ONE ``locate_batch`` RPC per
        ``remote_batch`` paths and grouped one-sided reads — N cold
        keys cost ``ceil(N / remote_batch)`` locate round-trips per
        peer instead of N. Result is keyed by path and equivalent to
        ``{p: get(p) for p in paths}`` (duplicates are read — and
        counted — once)."""
        out: Dict[str, Optional[bytes]] = {}
        misses: List[str] = []
        seen = set()
        for p in paths:
            if p in seen:
                continue
            seen.add(p)
            self._lease(p, READ)
            self.stats["gets"] += 1
            v = self.log.index.get(p, self._MISS)
            if v is not self._MISS:
                self.stats["l1_hits"] += 1
                out[p] = self._from_log_value(p, v)
                continue
            v = self.dram.get(p)
            if v is not None:
                self.stats["l1_hits"] += 1
                out[p] = v
                continue
            found, v = self.sfs.read_any(p)
            if found:
                if v is not None:
                    self.stats["l2_hits"] += 1
                    self.dram.put(p, v)
                out[p] = v
                continue
            if self._neg.get(p) == self.sfs.view_epoch:
                self.stats["neg_hits"] += 1
                out[p] = None
                continue
            misses.append(p)
        if misses:
            self.stats["multigets"] += 1
            remaining = misses
            for nid in self.read_peers:
                if not remaining:
                    break
                remaining = self._multiget_peer(nid, remaining, out)
            for p in remaining:  # absent everywhere: remember the miss
                out[p] = None
                self._neg[p] = self.sfs.view_epoch
        return {p: out[p] for p in paths}

    def _multiget_peer(self, nid: str, paths: List[str],
                       out: Dict[str, Optional[bytes]]) -> List[str]:
        """Resolve ``paths`` against one peer; returns the still-missing
        suffix for the next peer. Tombstones are authoritative."""
        still: List[str] = []
        me = self.sfs.node_id
        for i in range(0, len(paths), self.remote_batch):
            chunk = paths[i:i + self.remote_batch]
            try:
                if self.one_sided_reads:
                    def _locate():
                        with self.transport.act_as(me):
                            return self.transport.rpc(
                                nid, "locate_batch",
                                [(p, 0, None) for p in chunk])
                    descs = with_retries(_locate,
                                         stats=self.transport.stats)
                else:
                    descs = None  # legacy: per-path whole-blob RPC
            except Exception:
                still.extend(chunk)
                continue
            for j, p in enumerate(chunk):
                try:
                    if descs is None:
                        def _blob(p=p):
                            with self.transport.act_as(me):
                                return self.transport.rpc(
                                    nid, "read_remote", p)
                        found, v = with_retries(
                            _blob, stats=self.transport.stats)
                    else:
                        def _pull(p=p, j=j):
                            with self.transport.act_as(me):
                                return self._resolve_desc(
                                    nid, p, descs[j], 0, None)
                        found, v = with_retries(
                            _pull, stats=self.transport.stats)
                except Exception:
                    still.append(p)
                    continue
                if not found:
                    still.append(p)
                    continue
                out[p] = v
                if v is not None:
                    self.stats["remote_hits"] += 1
                    self.dram.put(p, v)
        return still

    def readahead(self, paths: List[str]) -> int:
        """Batch-prefetch into the DRAM cache (probationary queue);
        returns how many paths resolved to a value."""
        return sum(1 for v in self.multiget(paths).values()
                   if v is not None)

    # -- digest pipeline (seal -> background replicate+apply+fanout -> reap) -----
    def seal_and_digest(self) -> None:
        """Seal the active log region and hand it to the SharedFS digest
        worker; appends continue into a fresh active region while the
        worker replicates, applies, and fans out ``digest_slot`` down
        the chain. Blocks only when the previous seal has not finished
        digesting (backpressure), or — after a failed background digest
        — to retry it inline."""
        self.drain()
        region = self.log.seal()
        if region is None:
            return
        self.log.persist()
        # writer dies after sealing, before the worker takes the region:
        # the sealed suffix exists only in this node's NVM log
        self.transport.crashpoint("seal.mid", self.sfs.node_id)
        job = _DigestJob(region, ctx=self._optrace)
        self._inflight = job
        self.stats["seals"] += 1
        self.stats["digests"] += 1
        self.sfs.recorder.record("seal", self.proc_id)
        if job.ctx is not None:
            job.ctx.annotate("seal", node=self.sfs.node_id,
                             nbytes=region.nbytes)
        self.sfs.submit_digest(lambda: self._digest_region(job),
                               abort=lambda: self._abort_job(job),
                               key=self.proc_id)

    @staticmethod
    def _abort_job(job: _DigestJob) -> None:
        """Node died with the seal still queued: fail the job (the
        sealed region stays in the log for recovery) and release any
        waiter — crash()/drain() must not hang on a dead worker."""
        job.finish(RuntimeError("background digest abandoned: node down"))

    def _digest_region(self, job: _DigestJob) -> None:
        """Worker-side digest of one sealed region: ship the not-yet-
        replicated suffix, apply locally, fan the digest down the chain.
        Log truncation (the reap) stays writer-side.

        Pessimistic mode ships *pipelined*: the pre-encoded slice is
        handed to the chain sender (bounded in-flight window) and the
        local area apply overlaps the wire time; the fan-out below waits
        only on this region's own ack watermark. Optimistic mode keeps
        the synchronous replicate (the coalesced batch has no contiguous
        file range and must land atomically under its TXN barrier)."""
        region = job.region
        tr = self.tracer
        tok = tr.push(job.ctx) if tr is not None else None
        try:
            if job.ctx is not None:
                job.ctx.annotate("digest.region", node=self.sfs.node_id,
                                 upto=region.last_seqno)
            shipped = 0
            with self._repl_lock:
                self.chain.wait_acked(self.chain.submitted_seqno)
                since = self.chain.submitted_seqno
                pending = region.entries_since(since)
                if pending:
                    if self.mode == "optimistic":
                        reduced = UpdateLog.coalesce(pending)
                        self.stats["coalesced_out"] += \
                            len(pending) - len(reduced)
                        self.chain.replicate(reduced)
                        self.chain.mark_acked(pending[-1].seqno)
                    else:
                        shipped = pending[-1].seqno
                        self.chain.submit(shipped,
                                          region.encoded_since(since),
                                          ctx=job.ctx)
            # the apply overlaps the in-flight chain ship (pipelining)
            self.sfs.digest_entries(region.entries)
            if shipped:
                self.chain.wait_acked(shipped)
            # no repl lock here: fan-out truncation and concurrent fsync
            # appends serialize per slot (disjoint seqno ranges), and
            # holding the lock across the chain RPC would stall the
            # writer's fsync for the whole remote apply
            self.chain.digest_fanout(region.last_seqno)
            self.log.reap_files(region.last_seqno)  # file IO off-path
        except BaseException as e:  # surfaced at the next drain point
            job.finish(e)
        finally:
            if tr is not None:
                tr.pop(tok)
            job.finish()

    def _reap(self, wait: bool) -> None:
        """Writer-side completion of a background digest: drop the
        sealed region from the in-memory log view (the worker already
        rotated the file). On worker failure the sealed region stays in
        the log; the next synchronous digest retries inline."""
        job = self._inflight
        if job is None:
            return
        if not job.done:
            if not wait:
                return
            self.stats["backpressure_waits"] += 1
            job.wait()
        self._inflight = None
        if job.error is None:
            self.log.drop_sealed()
            self.stats["bg_digests"] += 1

    def drain(self) -> None:
        """Settle the pipeline: wait out any in-flight background digest
        and reap it; retry a failed one inline (raising its error)."""
        self._reap(wait=True)
        if self.log.sealed is not None:
            self.digest()

    # -- digest (synchronous: replicate + apply + truncate) ----------------------
    def digest(self) -> None:
        self._check_epoch()
        tr = self.tracer
        # inline digest runs on the caller thread: the pending write
        # trace (if any) activates so replicate/apply/fan-out spans
        # attach; when called from a revocation handler a reader's
        # already-active context wins (push(None) is a no-op)
        ctx = self._optrace if tr is not None else None
        tok = tr.push(ctx) if tr is not None else None
        try:
            if self._settle_before_digest:
                # fast promotion queued the predecessor's slot replay on
                # the node's FIFO digest worker: let that older suffix
                # land in the areas before this digest applies newer
                # entries over it
                self.sfs.drain_digests()
                self._settle_before_digest = False
            self._reap(wait=True)
            self.log.persist()
            with self._repl_lock:
                self._replicate(coalesce=(self.mode == "optimistic"))
            upto = self.log.last_seqno
            # every undigested entry has seqno <= last_seqno by
            # construction; apply the already-materialized list directly
            self.sfs.digest_entries(self.log.entries_since(0))
            self.chain.digest_fanout(upto)
            self.log.truncate_through(upto)
            self.stats["digests"] += 1
            self.stats["inline_digests"] += 1
        except StaleEpoch as e:
            self._fence(f"stale epoch on digest: {e}")
        finally:
            if tr is not None:
                tr.pop(tok)

    def flush_for_revocation(self) -> None:
        """Lease revocation grace: replicate + digest so the next holder
        sees all our updates via its SharedFS."""
        # holder dies mid-revocation, before the grace flush: the new
        # holder must see exactly the chain-acked prefix, nothing torn
        self.transport.crashpoint("lease.revoke", self.sfs.node_id)
        self.digest()

    # -- lifecycle ---------------------------------------------------------------
    def crash(self) -> None:
        """Simulate process death: volatile state is gone; the NVM log and
        the replicas' slots survive. A sealed region already handed to
        the SharedFS worker is the *daemon's* work — it completes (the
        daemon outlives the process) but the log file is never reaped,
        so recovery sees the full surviving log (re-digest is
        idempotent; ``chain_continue`` dedups via the slots' digested
        watermark)."""
        job = self._inflight
        if job is not None:
            job.wait()
            self._inflight = None
        self.chain.stop()
        self.dram.clear()
        self.log.close()

    def close(self) -> None:
        self.digest()
        self.chain.stop()
        self.sfs.lease_mgr.release_all(self.proc_id)
        self.sfs.local_procs.pop(self.proc_id, None)
        self._lease_cache.clear()
        self.log.close()


def recover_process(proc_id: str, sharedfs: SharedFS, chain: List[str],
                    **kwargs) -> LibState:
    """LibFS recovery (paper §3.4): digest the dead process's local log
    (idempotent), release its leases, and hand back a fresh LibState that
    sees all completed writes."""
    # settle the node's digest pipeline first: a sealed region the dead
    # process handed over must land before we re-read its log file
    sharedfs.drain_digests()
    log_path = f"{sharedfs.root}/nvm/proc/{proc_id}.log"
    tmp = UpdateLog(log_path, fsync_data=False)
    entries = tmp.entries_since(0)
    upto = tmp.last_seqno
    enc = tmp.encoded_since(0)
    # ship the surviving suffix to the chain BEFORE digesting: the dead
    # process may not have fsync'd its tail, and digesting (e.g.) an
    # unreplicated delete only locally would leave the replicas' hot
    # areas holding the stale value — which reads would then resurrect.
    # ``chain_continue`` appends idempotently (dedups by seqno).
    for nid in chain:
        if nid != sharedfs.node_id:
            try:
                # retried: a transiently dropped re-ship would leave one
                # replica's slot missing the tail — and serving stale
                # mirror state — while this node digests it
                sharedfs._rpc(nid, "ensure_slot", proc_id, fenced=True)
                sharedfs._rpc(nid, "chain_continue", proc_id, enc, [],
                              fenced=True)
            except Exception:
                pass  # dead replica: chain repair handles it
    if entries:
        sharedfs.digest_entries(entries)
    tmp.truncate_through(upto)
    tmp.close()
    # keep chain replicas in lockstep (their slots digest the same prefix)
    for nid in chain:
        if nid != sharedfs.node_id:
            try:
                sharedfs._rpc(nid, "digest_slot", proc_id, upto,
                              fenced=True)
            except Exception:
                pass  # dead replica: chain repair handles it
    sharedfs.lease_mgr.release_all(proc_id)
    return LibState(proc_id, sharedfs, chain, **kwargs)

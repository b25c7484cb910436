"""SharedFS: per-node daemon — second-level persistent cache, digest,
eviction, replica slots, lease management, permissions (paper §3).

Tiers on a node:
  hot shared area   nvm/shared/   (persistent; segment-log, see segstore)
  reserve area      nvm/reserve/  (only on reserve replicas)
  cold storage      ssd/cold/     (LRU eviction target; "disaggregatable")

Both persistent areas are `SegmentStore` segment logs (DESIGN.md §2):
puts are buffered appends and each digest batch is made durable by a
single ``commit()`` instead of a per-op manifest flush.
"""
from __future__ import annotations

import os
import queue
import threading
import zlib
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core import log as L
from repro_torch.core.cluster import ClusterManager, MANAGER_TTL
from repro_torch.core.extents import ExtentOverlay
from repro_torch.core.groupcommit import (GroupCommitCoordinator, GroupSlotSink,
                                    frame_batch)
from repro_torch.core.integrity import poison_sum, range_sum
from repro_torch.core.leases import LeaseManager, READ, WRITE
from repro_torch.core.obs import FlightRecorder, MetricsRegistry
from repro_torch.core.replication import ReplicaSlot
from repro_torch.core.segstore import (SegmentStore, ShardedSegmentStore,
                                 subtree_shard)
from repro_torch.core.transport import with_retries

# The segment-log engine is the Area now; the name survives for callers.
Area = SegmentStore


class SharedFS:
    """Per-node daemon. Registered as the node's transport endpoint."""

    def __init__(self, node_id: str, root_dir: str, cluster: ClusterManager,
                 transport, *, hot_capacity: int = 1 << 30,
                 is_reserve: bool = False, fsync_data: bool = False,
                 group_commit: bool = False, group_window_s: float = 0.0,
                 digest_workers: int = 1, digest_shards: int = 1):
        self.node_id = node_id
        self.root = root_dir
        self.cluster = cluster
        self.transport = transport
        # per-node observability (DESIGN.md §5.5): one registry every
        # subsystem on this node scopes into, plus the crash-surviving
        # flight recorder (registered with the transport so fault
        # injections and crash points land in it)
        self.metrics = MetricsRegistry(node_id)
        self.recorder = FlightRecorder(node_id, clock=cluster.clock)
        if hasattr(transport, "recorders"):
            transport.recorders[node_id] = self.recorder
        self.is_reserve = is_reserve
        self.fsync_data = fsync_data
        area_name = "reserve" if is_reserve else "shared"
        self._digest_shards = max(1, digest_shards)
        if self._digest_shards > 1:
            # parallel digest: the hot area splits into per-subtree
            # segment-log shards so workers append/compact concurrently
            self.hot = ShardedSegmentStore(
                os.path.join(root_dir, "nvm", area_name), hot_capacity,
                n_shards=self._digest_shards, fsync_data=fsync_data)
        else:
            self.hot = Area(os.path.join(root_dir, "nvm", area_name),
                            hot_capacity, fsync_data=fsync_data)
        self.cold = Area(os.path.join(root_dir, "ssd", "cold"),
                         fsync_data=fsync_data)
        self.slots: Dict[str, ReplicaSlot] = {}
        # path -> the slot holding its freshest undigested state (the
        # reverse index behind O(1) read_any/in_slot tier lookups)
        self.slot_index: Dict[str, ReplicaSlot] = {}
        self.lease_mgr = LeaseManager(node_id, self._revoke_holder)
        self.local_procs: Dict[str, object] = {}  # proc_id -> LibState
        self.permissions: Dict[str, tuple] = {}  # prefix -> (read, write)
        self.recovered_epoch = 0
        # this node's *view* of the membership epoch: advanced only by
        # channels that actually reached us (heartbeat acks, epoch
        # headers on incoming messages, a reachable manager watch) — a
        # partitioned node's view legitimately goes stale, which is
        # exactly what epoch fencing catches (DESIGN.md §5.4)
        self.view_epoch = cluster.epoch
        # cached lease-manager resolution (subtree -> (node, expires)):
        # steady state pays zero manager RPCs; the short TTL bounds how
        # long a partitioned node keeps trusting a stale delegation
        self._mgr_cache: Dict[str, tuple] = {}
        self.stats = self.metrics.scoped(
            "sharedfs.",
            seed=("digests", "evictions", "remote_reads", "remote_locates",
                  "invalidated", "bg_jobs", "promotions",
                  # integrity subsystem (DESIGN.md §5.3)
                  "repairs", "repair_failures", "checksum_exchanges",
                  "scrub_passes", "scrub_paths", "scrub_errors",
                  "scrub_repairs", "scrub_disagreements"))
        # background scrub daemon state (start_scrub/stop_scrub)
        self._scrub_thread: Optional[threading.Thread] = None
        self._scrub_stop: Optional[threading.Event] = None
        self._scrub_cursor = 0
        # persistent areas are one-sided readable: a remote LibFS
        # resolves a (path, range) to a physical extent via locate(),
        # then pulls exactly those bytes with Transport.one_sided_read —
        # no per-read server-side work, no whole-blob transfer
        if self._digest_shards > 1:
            for i, sh in enumerate(self.hot.shards):
                transport.register_region(node_id, f"area/hot/{i}", sh)
        else:
            transport.register_region(node_id, "area/hot", self.hot)
        transport.register_region(node_id, "area/cold", self.cold)
        # background digest workers (paper §3.1: SharedFS digests sealed
        # log regions while LibFS keeps appending). Per-key FIFO queues:
        # jobs sharing a routing key (e.g. one process's seals, or a
        # promotion replay keyed by the dead proc) stay ordered, while
        # different keys digest in parallel across the pool. Digest
        # *application* serializes per hot-area shard (_shard_locks),
        # with a node-wide _commit_lock around evict/commit.
        self._digest_workers = max(1, digest_workers)
        self._digest_qs: List["queue.Queue"] = [
            queue.Queue() for _ in range(self._digest_workers)]
        self._digest_threads: List[Optional[threading.Thread]] = \
            [None] * self._digest_workers
        self._shard_locks = [threading.RLock()
                             for _ in range(self._digest_shards)]
        self._commit_lock = threading.RLock()
        self._slot_digest_locks: Dict[str, threading.RLock] = {}
        self._locks_guard = threading.Lock()
        self._abandon = False  # node death: skip queued jobs
        # cross-process group commit (opt-in; see groupcommit.py)
        self.group_commit = (
            GroupCommitCoordinator(self, window_s=group_window_s)
            if group_commit else None)
        self._group_sinks: Dict[str, GroupSlotSink] = {}
        transport.register_endpoint(node_id, self)
        # the cluster manager is itself a transport endpoint ("cm"):
        # heartbeats and manager lookups travel the same partitionable
        # links as data, so suspicion comes from real reachability
        if not transport.has_endpoint("cm"):
            transport.register_endpoint("cm", cluster)
        cluster.watch(self._on_cluster_event)

    # -- view epochs (partition-honest membership, §5.4) ---------------------
    def _on_cluster_event(self, event: str, payload) -> None:
        """Manager-side watch push. Only honest channels advance the
        view: a node that is down, or whose link *from* the manager is
        partitioned, must not learn of a bump it could never have been
        told about."""
        if event != "epoch":
            return
        if self.transport.is_down(self.node_id) \
                or self.transport.link_blocked("cm", self.node_id):
            return
        self.observe_epoch(payload)

    def observe_epoch(self, epoch: int) -> int:
        """Adopt a (possibly newer) membership view. On advance, the
        lease manager drops grants stamped with older epochs and the
        manager-resolution cache clears — both halves of the paper's
        per-epoch invalidation. Returns the current view."""
        if epoch > self.view_epoch:
            self.view_epoch = epoch
            self.lease_mgr.drop_stale(epoch)
            self._mgr_cache.clear()
            self.recorder.record("epoch", str(epoch))
        return self.view_epoch

    def _rpc(self, dst: str, method: str, *args, deadline_s=None,
             fenced: bool = False, attempts: int = 4):
        """Peer RPC sent *as this node* (partition checks apply), with
        bounded retries. ``fenced=True`` stamps each attempt with the
        *current* view epoch — re-read per try, so a view refresh
        between retries is reflected."""
        tr = self.transport

        def _attempt():
            with tr.act_as(self.node_id):
                kw = {"_epoch": self.view_epoch} if fenced else {}
                return tr.rpc(dst, method, *args, **kw)

        return with_retries(_attempt, stats=tr.stats, attempts=attempts,
                            deadline_s=deadline_s)

    def _span(self, name: str, **meta) -> None:
        """Annotate the thread's active trace (no-op when untraced)."""
        tracer = getattr(self.transport, "tracer", None)
        if tracer is None:
            return
        ctx = tracer.current()
        if ctx is not None:
            ctx.annotate(name, node=self.node_id, **meta)

    # -- permissions (single administrative domain, paper §3.2) -------------
    def set_permission(self, prefix: str, read: bool = True,
                       write: bool = True) -> None:
        self.permissions[prefix] = (read, write)

    def check_permission(self, path: str, mode: str) -> bool:
        best, decision = -1, (True, True)
        for pre, rw in self.permissions.items():
            if (path == pre or path.startswith(pre.rstrip("/") + "/")) \
                    and len(pre) > best:
                best, decision = len(pre), rw
        return decision[0] if mode == READ else decision[1]

    # -- background digest workers (pipeline, paper §3.1) ---------------------
    def submit_digest(self, fn: Callable[[], None],
                      abort: Optional[Callable[[], None]] = None,
                      key: Optional[str] = None) -> None:
        """Queue background digest work; the writer returns immediately
        and keeps appending to its fresh active log region. ``abort``
        runs instead of ``fn`` if the node dies with the job still
        queued — so waiters on the job's completion never hang.
        ``key`` routes to a worker queue: jobs sharing a key run FIFO
        on one worker (ordering), distinct keys run in parallel."""
        i = (0 if key is None
             else zlib.crc32(key.encode()) % self._digest_workers)
        t = self._digest_threads[i]
        if t is None or not t.is_alive():
            t = threading.Thread(target=self._digest_loop, args=(i,),
                                 name=f"digest-{self.node_id}-{i}",
                                 daemon=True)
            self._digest_threads[i] = t
            t.start()
        self._digest_qs[i].put((fn, abort))

    def _digest_loop(self, i: int) -> None:
        q = self._digest_qs[i]
        # worker threads have no inherited sender identity: everything
        # a digest job sends (chain forwards, base fetches, re-
        # replication pushes) goes out as this node
        with self.transport.act_as(self.node_id):
            while True:
                item = q.get()
                try:
                    if item is None:
                        return
                    fn, abort = item
                    if not self._abandon:
                        fn()
                        self.stats["bg_jobs"] += 1
                    elif abort is not None:
                        abort()
                finally:
                    q.task_done()

    def drain_digests(self) -> None:
        """Barrier: block until every queued digest job has completed."""
        for q in self._digest_qs:
            q.join()

    def shutdown(self, abandon: bool = False) -> None:
        """Stop the digest workers. ``abandon=True`` models node death:
        queued jobs are skipped instead of run (a dead node must not
        keep digesting), and the join is best-effort."""
        self._abandon = abandon
        self.cluster.unwatch(self._on_cluster_event)
        self.stop_scrub()
        me = threading.current_thread()
        for i, t in enumerate(self._digest_threads):
            if t is not None and t.is_alive() and t is not me:
                # the current-thread guard matters for injected crashes:
                # a crash point firing ON a digest worker (kill_node ->
                # shutdown) must not try to join itself
                self._digest_qs[i].put(None)
                # abandon: best-effort join — a job wedged on dead-node
                # IO must not stall the failure path; it skips on wake
                t.join(timeout=None if not abandon else 0.25)
            self._digest_threads[i] = None
        if self.group_commit is not None:
            self.group_commit.close()
        for sink in self._group_sinks.values():
            sink.close()
        self._group_sinks.clear()

    # -- digest shard / per-proc lock helpers ---------------------------------
    def _shard_of(self, path: str) -> int:
        return subtree_shard(path, self._digest_shards)

    def _slot_digest_lock(self, proc_id: str) -> threading.RLock:
        with self._locks_guard:
            lk = self._slot_digest_locks.get(proc_id)
            if lk is None:
                lk = self._slot_digest_locks[proc_id] = threading.RLock()
            return lk

    # -- replica slots (chain replication target) ----------------------------
    def slot_for(self, proc_id: str) -> ReplicaSlot:
        if proc_id not in self.slots:
            slot = ReplicaSlot(os.path.join(self.root, "nvm", "repl",
                                            f"{proc_id}.log"),
                               self.fsync_data, index=self.slot_index)
            slot.region_id = f"slot/{proc_id}"
            self.slots[proc_id] = slot
            self.transport.register_region(self.node_id, slot.region_id,
                                           slot)
        return self.slots[proc_id]

    def ensure_slot(self, proc_id: str) -> None:
        self.slot_for(proc_id)

    def slot_suffix(self, proc_id: str, since_seqno: int) -> bytes:
        """RPC: the raw undigested slot suffix beyond ``since_seqno`` —
        lets a promoting replica pull entries a further-down replica
        acked that it never received (writer died mid-chain)."""
        slot = self.slots.get(proc_id)
        return slot.suffix_bytes(since_seqno) if slot is not None else b""

    def in_slot(self, path: str) -> bool:
        """Whether any replica slot's mirror holds fresher (undigested)
        state for the path — one reverse-index dict hit, not a scan of
        every slot's mirror."""
        return path in self.slot_index

    def chain_continue(self, proc_id: str, data: bytes,
                       rest: List[str]) -> int:
        """RPC: continue chain replication; ack = last seqno seen.

        The one-sided write may already have landed (writer wrote to us
        directly as chain head), the writer may be retrying after a
        dropped ack, or recovery may be re-shipping a log suffix a
        background digest already applied here: ``ReplicaSlot.write``
        dedups by seqno (digested watermark counts as the tail when the
        slot is empty), so appending is idempotent end to end. An older
        seqno the slot lacks was coalesced out of a batch it already
        acked — the coalesced stream is replay-equivalent — and is
        likewise skipped rather than replayed over newer state."""
        slot = self.slot_for(proc_id)
        if data:
            slot.write(None, data)
        if rest:
            head, tail = rest[0], rest[1:]
            # a middle replica dying right here leaves the prefix acked
            # nowhere: the writer sees NodeDown, the op is not acked
            self.transport.crashpoint("chain.fwd", self.node_id)
            self.transport.one_sided_write(head, f"slot/{proc_id}", data,
                                           _epoch=self.view_epoch)
            return self.transport.rpc(head, "chain_continue", proc_id, data,
                                      tail, _epoch=self.view_epoch)
        return slot.acked_seqno

    # -- group commit (cross-process batch replication) ------------------------
    def ensure_group_sink(self, writer_node: str) -> None:
        """RPC: register the ``gslot/<writer-node>`` region that group-
        committed batches from that node land in (idempotent)."""
        if writer_node not in self._group_sinks:
            sink = GroupSlotSink(self, writer_node)
            self._group_sinks[writer_node] = sink
            self.transport.register_region(self.node_id,
                                           f"gslot/{writer_node}", sink)

    def group_continue(self, writer_node: str, items: List[Tuple],
                       rest: List[str]) -> List[int]:
        """RPC: ack a group-committed batch; the payload arrived via the
        one-sided ``gslot`` write (the sink already routed each member's
        slice into its ReplicaSlot and journaled the batch) — this RPC
        carries only (proc_id, since, last) descriptors, never data.
        Forwarding down the chain re-frames each member's slice out of
        the local slots (``suffix_bytes``), so a hop ships each entry's
        bytes exactly once too. Returns per-member acked seqnos in
        ``items`` order."""
        if rest:
            head, tail = rest[0], rest[1:]
            self.transport.crashpoint("chain.fwd", self.node_id)
            framed = frame_batch(
                [(pid, self.slot_for(pid).suffix_bytes(since))
                 for pid, since, _last in items])
            self.transport.one_sided_write(head, f"gslot/{writer_node}",
                                           framed, _epoch=self.view_epoch)
            self.transport.rpc(head, "group_continue", writer_node, items,
                               tail, _epoch=self.view_epoch)
        return [self.slot_for(pid).acked_seqno for pid, _s, _l in items]

    # -- digest / eviction (paper §A.1) ----------------------------------------
    def _apply_batch(self, entries: List[L.Entry]) -> None:
        """Apply one digest batch under the shard locks. With a single
        shard this is exactly the old per-node digest lock. With
        several, the batch is grouped by subtree shard and each group
        applies under its own lock — two workers digesting different
        subtrees never contend. A rename across shards (rare: it
        crosses a lease boundary) falls back to holding every shard
        lock in order so its delete+put pair is atomic batch-wide."""
        if self._digest_shards == 1:
            with self._shard_locks[0]:
                for e in entries:
                    self._apply_entry(e)
            return
        cross = any(
            e.op == L.OP_RENAME
            and self._shard_of(e.path) != self._shard_of(e.data.decode())
            for e in entries)
        if cross:
            for lk in self._shard_locks:
                lk.acquire()
            try:
                for e in entries:
                    self._apply_entry(e)
            finally:
                for lk in reversed(self._shard_locks):
                    lk.release()
            return
        groups: Dict[int, List[L.Entry]] = {}
        for e in entries:
            groups.setdefault(self._shard_of(e.path), []).append(e)
        for i in sorted(groups):
            with self._shard_locks[i]:
                for e in groups[i]:
                    self._apply_entry(e)

    def digest_slot(self, proc_id: str, through_seqno: int) -> int:
        """Apply a process's replicated log prefix into the hot area.
        Serialized per process (apply/truncate must see a consistent
        slot cut) but concurrent across processes."""
        with self._slot_digest_lock(proc_id):
            slot = self.slot_for(proc_id)
            batch = [e for e in slot.entries if e.seqno <= through_seqno]
            self._apply_batch(batch)
            with self._commit_lock:
                self._evict_if_needed()
                self._commit_areas()
            # dying here (applied, not yet truncated) is safe exactly
            # because re-digesting the same slot prefix is idempotent
            self.transport.crashpoint("digest.mid", self.node_id)
            # truncate only after the applied entries are durable in the
            # areas — a crash in between must never lose the digested range
            slot.truncate_through(through_seqno)
            self.stats["digests"] += 1
            self.recorder.record("digest", f"slot:{proc_id}@{through_seqno}")
            self._span("digest.apply", proc=proc_id, upto=through_seqno,
                       applied=len(batch))
            return len(batch)

    def digest_slot_chain(self, proc_id: str, through_seqno: int,
                          rest: List[str]) -> int:
        """RPC: digest this node's slot, then forward down the chain —
        the writer pays one RPC for the whole replica set instead of a
        round-trip per replica."""
        applied = self.digest_slot(proc_id, through_seqno)
        if rest:
            self.transport.rpc(rest[0], "digest_slot_chain", proc_id,
                               through_seqno, rest[1:],
                               _epoch=self.view_epoch)
        return applied

    def digest_entries(self, entries: List[L.Entry]) -> int:
        self._apply_batch(entries)
        with self._commit_lock:
            # node dies mid-digest, before the area commit: the applied
            # batch is buffered, not durable — recovery replays it from
            # the replicated log (slots), never from the torn area
            self.transport.crashpoint("digest.apply", self.node_id)
            self.stats["digests"] += 1
            self._evict_if_needed()
            self._commit_areas()
        self.recorder.record("digest", f"entries:{len(entries)}")
        self._span("digest.apply", applied=len(entries))
        return len(entries)

    def _commit_areas(self) -> None:
        """One flush per digest batch (vs the seed's per-op flush)."""
        self.hot.commit()
        self.cold.commit()

    def _apply_entry(self, e: L.Entry) -> None:
        if e.op == L.OP_PUT:
            self.hot.put(e.path, e.data)
        elif e.op == L.OP_WRITE:
            # patch in place in the hot area (promote a cold base first:
            # the patched object is hot by definition of being written)
            if not self.hot.contains(e.path) and self.cold.contains(e.path):
                data = self.cold.get(e.path)
                self.cold.delete(e.path)
                self.hot.put(e.path, data)
            if not self.hot.contains(e.path):
                # no local base (e.g. dropped by epoch invalidation, or
                # a late-joining replica): fetch it from a peer before
                # patching — patching a fabricated zeros base would
                # permanently corrupt the object on this node. A peer
                # tombstone (found, None) legitimately means zeros.
                base = self._fetch_base(e.path)
                if base is not None:
                    self.hot.put(e.path, base)
            self.hot.patch(e.path, e.offset, e.data)
        elif e.op == L.OP_DELETE:
            self.hot.delete(e.path)
            self.cold.delete(e.path)
        elif e.op == L.OP_RENAME:
            dst = e.data.decode()
            if self.hot.contains(e.path):
                self.hot.rename(e.path, dst)
            elif self.cold.contains(e.path):
                data = self.cold.get(e.path)
                self.cold.delete(e.path)
                self.hot.put(dst, data)
        self.cluster.mark_dirty(e.path if e.op != L.OP_RENAME
                                else e.data.decode())

    def _fetch_base(self, path: str) -> Optional[bytes]:
        """Base value for a range write from the path's replica peers
        (freshest view: their slots are consulted first by read_any)."""
        peers = self.cluster.chain_for(path) + \
            self.cluster.reserves.get("/", [])
        for nid in peers:
            if nid == self.node_id:
                continue
            try:
                # retried: a transient drop must not demote to the next
                # peer (whose copy may be staler) or to a fabricated base
                found, v = self._rpc(nid, "read_remote", path)
            except Exception:
                continue
            if found:
                return v  # may be None: peer tombstone -> zeros base
        return None

    def _evict_if_needed(self) -> None:
        if self.hot.bytes <= self.hot.capacity:
            # live data fits, but overwrite churn can leave the segment
            # files holding up to ~2x live bytes: the modeled NVM tier
            # is fixed-size, so reclaim dead needles when the on-disk
            # footprint outgrows it
            if self.hot.disk_bytes > self.hot.capacity \
                    and self.hot.dead_bytes > 0:
                self.hot.compact()
            return
        for p in self.hot.lru_victims(0):
            data = self.hot.get(p)
            if data is not None:
                self.cold.put(p, data)
            self.hot.delete(p)
            self.stats["evictions"] += 1
            if self.hot.bytes <= self.hot.capacity:
                break

    # -- reads ------------------------------------------------------------------
    def read(self, path: str) -> Optional[bytes]:
        """L2 read (RPC-able): hot area only."""
        return self.hot.get(path)

    def read_any(self, path: str,
                 fetch_base: bool = True) -> Tuple[bool, Optional[bytes]]:
        """Undigested replica slots first (freshest), then hot, then
        cold. Returns ``(found, value)`` so a slot **tombstone** —
        ``(True, None)`` — is distinguishable from a plain miss
        ``(False, None)``: callers must not fall through to other
        replicas or cold storage on a tombstone (deleted data would
        resurrect). Slot extent overlays are assembled over this node's
        lower tiers (zeros base after a tombstone); when the local base
        copy is gone (epoch invalidation, late join) it is fetched from
        peers rather than fabricated as zeros. ``fetch_base=False`` is
        the remote-serving mode (see ``read_remote``): it reports a
        miss instead of fetching, which both breaks the RPC cycle two
        base-less nodes would otherwise enter and lets the remote
        caller continue its own tier walk. Slot lookup is one reverse-
        index dict hit (``slot_index``), not a scan over every slot."""
        slot = self.slot_index.get(path)
        if slot is not None and path in slot.mirror:
            v = slot.mirror[path]
            if isinstance(v, ExtentOverlay):
                base = b""
                if not v.from_zero:
                    # explicit None checks: an empty-bytes hot value
                    # is a real base and must not fall through to a
                    # stale cold copy
                    base = self.hot.get(path)
                    if base is None:
                        base = self.cold.get(path)
                    if base is None:
                        if not fetch_base:
                            return False, None
                        base = self._fetch_base(path)
                    if base is None:
                        base = b""
                return True, v.apply_to(base)
            if isinstance(v, bytearray):  # in-place-patched mirror
                return True, bytes(v)
            return True, v  # full value, or tombstone (None)
        v = self.hot.get(path)
        if v is not None:
            return True, v
        v = self.cold.get(path)
        if v is not None:
            return True, v
        return False, None

    def read_remote(self, path: str) -> Tuple[bool, Optional[bytes]]:
        self.stats["remote_reads"] += 1
        return self.read_any(path, fetch_base=False)

    def read_range(self, path: str, offset: int, length: int,
                   fetch_base: bool = True) -> Tuple[bool, Optional[bytes]]:
        """Node-local ranged read with ``read_any``'s tier order and
        tombstone semantics, but touching only the requested bytes:
        slot-mirror overlays serve covered ranges without a base, plain
        mirror values slice in memory, and the hot/cold areas answer
        with a single ``pread`` of the range (never a whole-value
        materialization). Equivalent to ``read_any(path)[offset:
        offset+length]`` when found."""
        slot = self.slot_index.get(path)
        if slot is not None and path in slot.mirror:
            v = slot.mirror[path]
            if v is None:
                return True, None  # tombstone: authoritative
            if isinstance(v, ExtentOverlay):
                r = v.read_range(offset, length)
                if r is not None:
                    return True, r
                # overlay only partially covers the range: assemble the
                # window over this node's lower-tier base (rare)
                found, full = self.read_any(path, fetch_base=fetch_base)
                if not found:
                    return False, None
                return True, (None if full is None
                              else full[offset:offset + length])
            if isinstance(v, bytearray):
                return True, bytes(v[offset:offset + length])
            return True, v[offset:offset + length]
        r = self.hot.get_range(path, offset, length)
        if r is not None:
            return True, r
        r = self.cold.get_range(path, offset, length)
        if r is not None:
            return True, r
        return False, None

    def read_remote_range(self, path: str, offset: int,
                          length: int) -> Tuple[bool, Optional[bytes]]:
        """RPC: ranged remote read (remote-serving mode — reports a miss
        instead of fetching an absent base). The RPC fallback for
        one-sided reads whose handle went stale mid-flight."""
        self.stats["remote_reads"] += 1
        return self.read_range(path, offset, length, fetch_base=False)

    # -- one-sided read protocol (locate -> Transport.one_sided_read) --------
    @staticmethod
    def _inline_desc(full: bytes, offset: int, length: Optional[int]):
        if length is None:
            return ("inline", full[offset:], len(full))
        return ("inline", full[offset:offset + length], len(full))

    def _locate_one(self, path: str, offset: int, length: Optional[int]):
        slot = self.slot_index.get(path)
        if slot is not None and path in slot.mirror:
            v = slot.mirror[path]
            if v is None:
                return ("tomb",)
            if isinstance(v, ExtentOverlay):
                if length is not None:
                    r = v.read_range(offset, length)
                    if r is not None:
                        return ("inline", r, v.end)
                # overlay needs this node's base: remote-serving mode
                # must not fetch one, so either answer from local tiers
                # or report a miss and let the caller keep walking
                found, full = self.read_any(path, fetch_base=False)
                if not found:
                    return ("miss",)
                if full is None:
                    return ("tomb",)
                return self._inline_desc(full, offset, length)
            if isinstance(v, bytearray):
                return self._inline_desc(bytes(v), offset, length)
            loc = slot.locate(path)
            if loc is not None and slot.region_id is not None:
                boff, n, rkey, pc = loc
                lo = min(offset, n)
                ln = (n - lo) if length is None else min(length, n - lo)
                # an int pc means the slot's lazy chunk-table expansion
                # found rot: poison the summary so a verifying client
                # detects and falls back instead of trusting the pull
                vsum = (poison_sum(ln) if isinstance(pc, int)
                        else range_sum(pc, n, lo, ln))
                return ("val", slot.region_id, boff + lo, ln, n, rkey,
                        vsum)
            return self._inline_desc(v, offset, length)
        if self._digest_shards > 1:
            i = self.hot.shard_index(path)
            hot_pair = (self.hot.shards[i], f"area/hot/{i}")
        else:
            hot_pair = (self.hot, "area/hot")
        for area, rid in (hot_pair, (self.cold, "area/cold")):
            d = area.locate(path, offset, length)
            if d is None:
                continue
            if d[0] == "loc":
                _, addr, n, total, rkey, vsum = d
                return ("val", rid, addr, n, total, rkey, vsum)
            total = d[1]  # fragmented (patch chain): range-assemble here
            ln = max(0, total - offset) if length is None else length
            data = area.get_range(path, offset, ln)
            return ("inline", data if data is not None else b"", total)
        return ("miss",)

    def locate(self, path: str, offset: int = 0,
               length: Optional[int] = None):
        """RPC: resolve a read to a one-sided-readable descriptor.

        Returns one of
          ``("val", region_id, off, n, total, rkey, vsum)`` — the caller
            pulls ``n`` bytes at ``off`` from the region with
            ``Transport.one_sided_read`` (rkey-guarded) — or, with
            verification on, the chunk-aligned expansion described by
            ``vsum = (head, ext, c0, c1)`` (integrity.range_sum; None
            when the extent carries no chunk CRCs), checking the pull
            client-side before trusting a single byte of it;
          ``("inline", bytes, total)`` — the *ranged* bytes, answered
            inline because no single physical extent covers them
            (overlay/patch-chain assembly, zero holes);
          ``("tomb",)`` — tombstone: found-deleted, authoritative;
          ``("miss",)`` — not on this node; keep walking.

        Remote-serving mode throughout: never fetches an absent base
        (see ``read_remote``)."""
        self.stats["remote_locates"] += 1
        return self._locate_one(path, offset, length)

    def locate_batch(self, reqs: List[Tuple[str, int, Optional[int]]]):
        """RPC: one round-trip resolving many reads (the multiget /
        readahead path) — descriptors in request order."""
        self.stats["remote_locates"] += 1
        return [self._locate_one(p, off, ln) for p, off, ln in reqs]

    # -- integrity: verify-on-read fallback, read-repair, scrub (§5.3) --------
    def _verify_local(self, path: str) -> Optional[bool]:
        """Do this node's own bytes for ``path`` still match their
        chunk CRCs, across every surface that can serve them (slot
        region, hot, cold)? False on any mismatch; None when the path
        is nowhere local."""
        ok: Optional[bool] = None
        slot = self.slot_index.get(path)
        if slot is not None:
            r = slot.verify(path)
            if r is False:
                return False
            if r is not None:
                ok = True
        for area in (self.hot, self.cold):
            if area.contains(path):
                if area.verify(path) is False:
                    return False
                ok = True
        return ok

    def read_checked(self, path: str) -> Tuple[bool, Optional[bytes]]:
        """RPC: remote-serving full read that verifies this node's own
        copy first and reports a **miss** rather than serving rotten
        bytes — the peer side of read-repair. Deliberately non-
        recursive (no repair, no fetch): a rotten peer answering a
        repair must not start a repair of its own mid-call, or two
        rotten replicas would recurse; its own scrub fixes it."""
        self.stats["remote_reads"] += 1
        if self._verify_local(path) is False:
            return False, None
        return self.read_any(path, fetch_base=False)

    def read_verified(self, path: str, offset: int,
                      length: Optional[int]
                      ) -> Tuple[bool, Optional[bytes]]:
        """RPC: the client's fallback after a one-sided read failed its
        checksum. Verify this node's own copy; if it rotted at rest,
        read-repair it from the replica chain first; then serve the
        range through the RPC path (whose payload is not subject to
        one-sided in-flight faults). The client gets verified bytes —
        or a miss when the extent was unsalvageable — never the
        corrupt ones."""
        self.stats["remote_reads"] += 1
        if self._verify_local(path) is False:
            self.repair_path(path)
        if length is None:
            found, v = self.read_any(path, fetch_base=False)
            if not found or v is None:
                return found, v
            return True, v[offset:]
        return self.read_range(path, offset, length, fetch_base=False)

    def _peer_verified(self, path: str) -> Tuple[bool, Optional[bytes]]:
        """``(found, value)`` from the first chain/reserve peer whose
        own copy passes verification (``read_checked``); value None =
        an authoritative tombstone. ``(False, None)`` when no intact
        replica answered."""
        peers = self.cluster.chain_for(path) \
            + self.cluster.reserves.get("/", [])
        seen = set()
        for nid in peers:
            if nid == self.node_id or nid in seen:
                continue
            seen.add(nid)
            try:
                found, v = self._rpc(nid, "read_checked", path)
            except Exception:
                continue
            if found:
                return True, v
        return False, None

    def _refetch_verified(self, path: str) -> Optional[bytes]:
        """Quarantine-salvage callback (``SegmentStore.repair``):
        verified replica bytes, or None when unsalvageable."""
        found, v = self._peer_verified(path)
        return v if found else None

    def repair_path(self, path: str) -> bool:
        """Read-repair one path on this node. Slot-region rot rebuilds
        from the decoded entry mirror (local, exact). Area rot
        re-fetches verified bytes from the replica chain and rewrites
        the extent (fresh needle + rkey bump, so outstanding one-sided
        handles fail closed; segments over the mismatch budget are
        quarantined). When no intact replica exists — or the intact
        answer is a tombstone — the local copy is dropped: the corrupt
        extent is *excluded*, never served."""
        repaired = False
        slot = self.slot_index.get(path)
        if slot is not None and slot.verify(path) is False:
            slot.repair_region()
            self.stats["repairs"] += 1
            repaired = True
        for area in (self.hot, self.cold):
            if not area.contains(path) or area.verify(path) is not False:
                continue
            found, good = self._peer_verified(path)
            if found and good is not None:
                area.repair(path, good, refetch=self._refetch_verified)
                self.stats["repairs"] += 1
                repaired = True
            else:
                area.delete(path)
                if found:  # tombstone: the value is deleted cluster-wide
                    self.stats["repairs"] += 1
                    repaired = True
                else:
                    self.stats["repair_failures"] += 1
        with self._commit_lock:
            self._commit_areas()
        if repaired:
            self.recorder.record("repair", path)
        self._span("repair", path=path, ok=repaired)
        return repaired

    def scrub_path(self, path: str) -> bool:
        """RPC: verify one path locally, repair from replicas if rotten
        (a peer's scrub telling us our checksum disagrees)."""
        if self._verify_local(path) is False:
            return self.repair_path(path)
        return False

    def _value_crcs(self, paths: List[str]) -> List[Optional[int]]:
        out: List[Optional[int]] = []
        for p in paths:
            found, v = self.read_any(p, fetch_base=False)
            out.append(None if not found
                       else (-1 if v is None else zlib.crc32(v)))
        return out

    def checksum_exchange(self, paths: List[str]) -> List[Optional[int]]:
        """RPC: CRC32 of the value this node would serve for each path.
        Integers only — the scrub happy path compares replicas without
        a single payload byte on the wire. -1 encodes a tombstone,
        None a miss."""
        self.stats["checksum_exchanges"] += 1
        return self._value_crcs(paths)

    def scrub_now(self, max_paths: Optional[int] = None,
                  exchange: bool = True) -> Dict[str, int]:
        """One synchronous scrub pass (the daemon calls this throttled):

        1. every replica slot's region bytes vs their apply-time CRCs
           (rot there rebuilds the region from the entry mirror);
        2. up to ``max_paths`` hot/cold paths (resumable cursor) vs
           their chunk CRCs, feeding ``repair_path`` on mismatch;
        3. optional cross-replica checksum exchange over the same batch
           — CRC integers only — telling a disagreeing peer whose own
           copy is rotten to scrub itself (``scrub_path``).

        Returns this pass's counters; cumulative ones live in
        ``stats`` (surfaced through ``harness.integrity_stats``)."""
        scanned = errors = repaired = disagree = 0
        for slot in list(self.slots.values()):
            for p in list(slot._locs):
                scanned += 1
                if slot.verify(p) is False:
                    errors += 1
                    slot.repair_region()
                    self.stats["repairs"] += 1
                    repaired += 1
        paths = sorted(set(self.hot.paths()) | set(self.cold.paths()))
        if max_paths is not None and paths:
            start = self._scrub_cursor % len(paths)
            take = min(max_paths, len(paths))
            batch = [paths[(start + i) % len(paths)] for i in range(take)]
            self._scrub_cursor = (start + take) % len(paths)
        else:
            batch = paths
        for p in batch:
            scanned += 1
            if any(area.contains(p) and area.verify(p) is False
                   for area in (self.hot, self.cold)):
                errors += 1
                if self.repair_path(p):
                    repaired += 1
        if exchange and batch:
            mine = self._value_crcs(batch)
            peers: List[str] = []
            for p in batch:
                for nid in self.cluster.chain_for(p):
                    if nid != self.node_id and nid not in peers:
                        peers.append(nid)
            for nid in peers:
                try:
                    theirs = self._rpc(nid, "checksum_exchange", batch)
                except Exception:
                    continue
                for p, a, b in zip(batch, mine, theirs):
                    if a is None or b is None or a == b:
                        continue
                    disagree += 1
                    if self._verify_local(p) is not False:
                        # our bytes check out: the peer's rotted
                        try:
                            self._rpc(nid, "scrub_path", p)
                        except Exception:
                            pass
        self.stats["scrub_passes"] += 1
        self.stats["scrub_paths"] += scanned
        self.stats["scrub_errors"] += errors
        self.stats["scrub_repairs"] += repaired
        self.stats["scrub_disagreements"] += disagree
        return {"scanned": scanned, "errors": errors,
                "repaired": repaired, "disagreements": disagree}

    def start_scrub(self, interval_s: float = 0.01, batch: int = 64,
                    exchange: bool = False) -> None:
        """Throttled background scrub worker: one ``scrub_now`` batch
        per interval, walking the namespace round-robin via the resume
        cursor. Off by default — tests and benches call ``scrub_now``
        synchronously; the daemon is the deployment shape."""
        if self._scrub_thread is not None \
                and self._scrub_thread.is_alive():
            return
        stop = threading.Event()
        self._scrub_stop = stop

        def _loop():
            with self.transport.act_as(self.node_id):
                while not stop.wait(interval_s):
                    if self._abandon:
                        return
                    try:
                        self.scrub_now(max_paths=batch, exchange=exchange)
                    except Exception:
                        pass  # a dying peer mid-pass: next pass retries

        t = threading.Thread(target=_loop,
                             name=f"scrub-{self.node_id}", daemon=True)
        self._scrub_thread = t
        t.start()

    def stop_scrub(self) -> None:
        if self._scrub_stop is not None:
            self._scrub_stop.set()
        t = self._scrub_thread
        if t is not None and t.is_alive() \
                and t is not threading.current_thread():
            t.join(timeout=1.0)
        self._scrub_thread = None

    # -- leases -------------------------------------------------------------------
    def _resolve_manager(self, subtree: str) -> str:
        """Which node manages leases for ``subtree`` — resolved through
        the transported "cm" endpoint (the delegation root), cached for
        half the delegation TTL. A node partitioned away from the
        manager cannot resolve (RpcTimeout after a short deadline) once
        its cache expires: its processes fail-stop on lease renewal
        instead of granting themselves leases the majority side is
        already reassigning (§5.4 minority fail-stop)."""
        now = self.cluster.clock()
        hit = self._mgr_cache.get(subtree)
        if hit is not None and now < hit[1]:
            return hit[0]
        mgr = self._rpc("cm", "manager_for", subtree, self.node_id,
                        deadline_s=0.25, fenced=True)
        self._mgr_cache[subtree] = (mgr, now + MANAGER_TTL / 2)
        return mgr

    def lease_acquire(self, holder: str, path: str, mode: str,
                      subtree: str = "/") -> Tuple[str, str, float]:
        """Acquire (or refresh) a lease; returns ``(lease_path, mode,
        expires_at)`` so the holder can cache the grant and skip the
        manager entirely until it expires or is revoked (paper §3.3)."""
        if not self.check_permission(path, mode):
            raise PermissionError(f"{holder}: {mode} {path}")
        mgr_node = self._resolve_manager(subtree)
        now = self.cluster.clock()
        if mgr_node == self.node_id:
            lease = self.lease_mgr.acquire(holder, path, mode, now,
                                           subtree=subtree,
                                           epoch=self.view_epoch)
            return (lease.path, lease.mode, lease.expires_at)
        # idempotent at the manager (a re-acquire refreshes the grant),
        # so a dropped grant RPC is safely retried; the epoch header
        # fences a stale-view requester before any grant is made
        return self._rpc(mgr_node, "lease_acquire_local", holder, path,
                         mode, subtree, fenced=True, deadline_s=0.25)

    def lease_acquire_local(self, holder: str, path: str, mode: str,
                            subtree: str = "/") -> Tuple[str, str, float]:
        lease = self.lease_mgr.acquire(holder, path, mode,
                                       self.cluster.clock(),
                                       subtree=subtree,
                                       epoch=self.view_epoch)
        return (lease.path, lease.mode, lease.expires_at)

    def _revoke_holder(self, holder: str, path: str) -> None:
        """Grace-period revocation: make the holder drop its cached
        lease and flush + digest. A holder living on another node is
        reached by RPC — with lease caching it would otherwise keep
        writing against a revoked grant until the TTL ran out."""
        proc = self.local_procs.get(holder)
        if proc is not None:
            proc.handle_revocation(path)
            return
        for nid in self.cluster.alive_nodes():
            if nid == self.node_id:
                continue
            try:
                # retried: a dropped revocation would leave the holder
                # serving stale cached state against a revoked grant
                if self._rpc(nid, "revoke_holder", holder, path,
                             fenced=True):
                    return
            except Exception:
                continue  # dead node: its procs died with it

    def revoke_holder(self, holder: str, path: str) -> bool:
        """RPC: revoke a lease held by one of this node's processes."""
        proc = self.local_procs.get(holder)
        if proc is None:
            return False
        proc.handle_revocation(path)
        return True

    # -- process failure (LibFS recovery, paper §3.4) -------------------------------
    def slot_acked(self, proc_id: str) -> int:
        """RPC: chain-acked watermark of this node's slot for a process
        (0 when the node never held one). Failover uses the max across
        replicas so the successor's seqnos continue past every copy."""
        slot = self.slots.get(proc_id)
        return slot.acked_seqno if slot is not None else 0

    def promote_dead_process(self, proc_id: str,
                             peers: List[str] = ()) -> int:
        """Fast promotion (§3.5): make this warm cache replica the
        serving node for a dead process's state *immediately*. Nothing
        is replayed on the critical path — the slot mirror already
        materializes the chain-acked undigested suffix and ``read_any``
        consults it first, so promotion is: release the dead holder's
        leases, queue the O(dirty-since-last-digest) slot replay on the
        background digest worker, and return the acked watermark the
        successor continues its seqnos from. FIFO ordering on the
        worker means the suffix lands in the areas before any digest
        the successor seals afterwards, so the slot's freshest-first
        read order can never be beaten by a newer write (the inline
        ``digest()`` path adds a one-shot settle barrier for the same
        reason — see ``LibState``). Contrast ``recover_dead_process``,
        which drains + digests synchronously: that is the O(total
        recovery) cold path fig15 compares against.

        ``peers`` are the other *surviving* slot-mirror holders (chain +
        reserves). The background replay re-ships this slot's suffix to
        them and fans out the digest so every surviving tier converges
        on the same cut: without lockstep, a read that falls through to
        a staler peer tier can resurrect a deleted key or serve a mix
        of two cuts."""
        self.lease_mgr.release_all(proc_id)
        self.local_procs.pop(proc_id, None)
        slot = self.slots.get(proc_id)
        acked = slot.acked_seqno if slot is not None else 0
        others = [n for n in peers if n != self.node_id]
        self.recorder.record("promote", f"{proc_id}@{acked}")
        self._span("failover.promote", proc=proc_id, acked=acked)
        tracer = getattr(self.transport, "tracer", None)
        ctx = tracer.current() if tracer is not None else None
        if slot is not None and (slot.entries or others):
            data = slot.suffix_bytes(slot.digested_seqno)

            def _replay():
                # re-activate the fail-over trace on the digest worker
                # so the background replay's spans join it
                tok = tracer.push(ctx) if tracer is not None else None
                if ctx is not None:
                    ctx.annotate("failover.replay", node=self.node_id,
                                 proc=proc_id, nbytes=len(data))
                try:
                    self._do_replay(proc_id, acked, others, data)
                finally:
                    if tracer is not None:
                        tracer.pop(tok)

            # keyed by proc: FIFO with any digest the successor seals
            # for the same process afterwards (the ordering the fast-
            # promotion read path depends on)
            self.submit_digest(_replay, key=proc_id)
        self.stats["promotions"] += 1
        return acked

    def _do_replay(self, proc_id: str, acked: int, others: List[str],
                   data: bytes) -> None:
        """Body of the promotion replay (see ``promote_dead_process``)."""
        for nid in others:
            try:
                self._rpc(nid, "ensure_slot", proc_id, fenced=True)
                if data:
                    self._rpc(nid, "chain_continue", proc_id, data, [],
                              fenced=True)
            except Exception:
                pass  # dead peer: chain repair handles it
        self.digest_slot(proc_id, acked)
        for nid in others:
            try:
                self._rpc(nid, "digest_slot", proc_id, acked,
                          fenced=True)
            except Exception:
                pass  # dead peer: chain repair handles it

    def recover_dead_process(self, proc_id: str) -> int:
        """Idempotent log-based eviction of a dead process's updates.
        Drains this node's digest worker first so an in-flight sealed
        region handed over before the death lands before the slot is
        digested (recovery must see a settled pipeline)."""
        self.drain_digests()
        slot = self.slots.get(proc_id)
        applied = 0
        if slot is not None:
            applied = self.digest_slot(proc_id, slot.acked_seqno)
        self.lease_mgr.release_all(proc_id)
        self.local_procs.pop(proc_id, None)
        return applied

    # -- background re-replication (restore the replication factor) -----------
    def install_bases(self, items: List[Tuple[str, Optional[bytes]]]) -> int:
        """RPC: bulk-install digested state on a recruited replica —
        ``(path, value)`` pairs; value None is a tombstone (drop any
        local copy). One area commit covers the batch."""
        n = 0
        for path, v in items:
            if v is None:
                self.hot.delete(path)
                self.cold.delete(path)
            else:
                self.hot.put(path, v)
            n += 1
        with self._commit_lock:
            self._evict_if_needed()
            self._commit_areas()
        return n

    def rereplicate_to(self, recruit: str) -> Dict[str, int]:
        """Catch a recruited chain member up in the background: ship
        every live slot's undigested suffix (seqno-deduped, so a
        concurrent writer's own pushes interleave safely), then delta-
        resync the digested namespace by comparing value CRCs
        (``checksum_exchange`` — integers on the wire) and pushing only
        differing paths via ``install_bases``. Runs on a digest worker,
        off the writers' hot path; every message is epoch-fenced, so a
        membership change mid-resync aborts loudly rather than
        installing state under a superseded view."""
        out = {"slots": 0, "suffix_bytes": 0, "paths_checked": 0,
               "paths_pushed": 0}
        for proc_id, slot in list(self.slots.items()):
            self._rpc(recruit, "ensure_slot", proc_id, fenced=True)
            data = slot.suffix_bytes(0)
            if data:
                self._rpc(recruit, "chain_continue", proc_id, data, [],
                          fenced=True)
                out["suffix_bytes"] += len(data)
            out["slots"] += 1
        # writers homed HERE hold their authoritative log locally (no
        # slot on this node): their acked-but-undigested suffix must
        # reach the recruit too, or a later home-node loss would shrink
        # the acked prefix below what the old chain had acknowledged
        for proc_id, proc in list(self.local_procs.items()):
            data = proc.log.encoded_since(0)
            self._rpc(recruit, "ensure_slot", proc_id, fenced=True)
            if data:
                self._rpc(recruit, "chain_continue", proc_id, data, [],
                          fenced=True)
                out["suffix_bytes"] += len(data)
            out["slots"] += 1
        paths = sorted(set(self.hot.paths()) | set(self.cold.paths()))
        for i in range(0, len(paths), 64):
            batch = paths[i:i + 64]
            mine = self._value_crcs(batch)
            theirs = self._rpc(recruit, "checksum_exchange", batch,
                               fenced=True)
            push = []
            for p, a, b in zip(batch, mine, theirs):
                out["paths_checked"] += 1
                if a is None or a == b:
                    continue
                _found, v = self.read_any(p, fetch_base=False)
                push.append((p, v))
            if push:
                self._rpc(recruit, "install_bases", push, fenced=True)
                out["paths_pushed"] += len(push)
        return out

    # -- epoch-based invalidation on rejoin (paper §3.4) ------------------------------
    def invalidate_since(self, epoch: int) -> int:
        dirty = self.cluster.dirty_since(epoch)
        n = 0
        for p in dirty:
            if self.hot.contains(p):
                self.hot.delete(p)
                n += 1
            if self.cold.contains(p):
                self.cold.delete(p)
                n += 1
        self._commit_areas()
        self.stats["invalidated"] += n
        self.recovered_epoch = self.cluster.epoch
        return n

    def promote_to_cache_replica(self) -> None:
        """Reserve -> cache replica under cascaded failures (§3.5)."""
        self.is_reserve = False

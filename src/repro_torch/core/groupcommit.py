"""Cross-process group commit (paper §5.1: multi-writer scaling).

Concurrent fsync/dsync calls from co-located writer processes are
batched by a per-node ``GroupCommitCoordinator`` into

- **one fsync**: every member's pending log suffix is appended to the
  node's ``CommitJournal`` and made durable with a single
  flush+fsync — instead of one ``os.fsync`` per writer per op; and
- **one chain-replication slice**: the members' pre-encoded suffixes
  are framed into a single batch, delivered to each chain node with one
  one-sided write into a ``gslot/<writer-node>`` region, and acked with
  one *payload-free* ``group_continue`` RPC per hop (the data never
  rides the RPC — each entry's bytes cross each hop exactly once).

Leader/follower batching: the first committer becomes the leader and
flushes immediately — **a lone writer never waits**. Writers arriving
while a flush is in flight enqueue and are flushed together in the next
round; the natural pile-up while the leader is on the wire is what
amortizes the fsync and the RPC across the batch.

Retry safety: the one-sided batch write is pushed once (a ``pushed``
flag keeps an RPC retry from re-shipping payload bytes); the receiving
slots dedup by seqno as always, so duplicate *delivery* (injected
faults) stays harmless too. Forwarding down the chain re-frames each
sub-slice out of the local replica slots (``suffix_bytes``), so a
middle hop also ships each entry's bytes exactly once.
"""
from __future__ import annotations

import os
import queue
import struct
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

from repro_torch.core.log import UpdateLog, decode_stream
from repro_torch.core.transport import with_retries

# frame header: proc-id length, payload length, CRC32 of pid+payload.
# The CRC is what lets journal replay tell a torn tail (the crash cut
# the last frame short: expected, prefix semantics) from a corrupted
# middle frame (acknowledged batches would be silently lost: raise).
_FRAME = struct.Struct("<HII")


class JournalCorruption(RuntimeError):
    """A CRC-bad frame was found *before* later, valid frames in a
    commit journal: mid-journal corruption, not a torn tail. Replaying
    past it would silently drop an acknowledged batch while keeping
    newer ones — recovery must fail loudly and repair from replicas."""


def frame_batch(items: List[Tuple[str, bytes]]) -> bytes:
    """One wire buffer holding each member's pre-encoded log slice,
    tagged with its proc id (entries alone don't carry one) and
    covered by a frame CRC."""
    parts = []
    for pid, data in items:
        p = pid.encode()
        parts.append(_FRAME.pack(len(p), len(data),
                                 zlib.crc32(data, zlib.crc32(p))))
        parts.append(p)
        parts.append(data)
    return b"".join(parts)


def scan_frames(buf: bytes) -> List[Tuple[str, bytes, bool]]:
    """Structural frame scan: ``(pid, payload, crc_ok)`` per complete
    frame, stopping at a zeroed header (preallocated-journal end
    marker) or a frame cut short by the buffer end (torn tail)."""
    out, off, n = [], 0, len(buf)
    while off + _FRAME.size <= n:
        plen, dlen, crc = _FRAME.unpack_from(buf, off)
        if plen == 0:
            break  # zeroed header: preallocated-journal end marker
        off += _FRAME.size
        end = off + plen + dlen
        if end > n:
            break  # torn frame: prefix semantics, same as the log
        blob = bytes(buf[off:end])
        ok = zlib.crc32(blob) == crc
        try:
            pid = blob[:plen].decode()
        except UnicodeDecodeError:
            pid, ok = "", False  # header survived, pid bytes rotted
        out.append((pid, blob[plen:], ok))
        off = end
    return out


def unframe_batch(buf: bytes) -> List[Tuple[str, bytes]]:
    """Lenient unframing for in-flight buffers: the valid prefix, cut
    at the first CRC-bad frame (a torn one-sided delivery)."""
    out = []
    for pid, data, ok in scan_frames(buf):
        if not ok:
            break
        out.append((pid, data))
    return out


class CommitJournal:
    """Node-level group-commit journal: the single durability point for
    a batch. Member logs are flushed to the OS but NOT individually
    fsynced on the group path; the journal's one fdatasync covers the
    whole batch (classic shared-WAL group commit).

    The file is **preallocated** and written with ``pwrite`` at a
    moving offset: a stable size means ``fdatasync`` never has to
    commit metadata, which measures ~35% cheaper than append+fsync on
    this class of filesystem — the WAL layout every serious database
    uses. Entries leave the journal's responsibility once digested, so
    the offset wraps whenever the next batch would outgrow ``capacity``
    (every frame in it is by then also in the replica slots and/or the
    areas); the wrap rezeroes the file so ``replay``'s zero-header scan
    stops at the live region's end."""

    def __init__(self, path: str, fsync_data: bool = False,
                 capacity: int = 8 << 20):
        self.path = path
        self.fsync_data = fsync_data
        self.capacity = capacity
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self._fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
        os.ftruncate(self._fd, capacity)
        if fsync_data:
            os.fsync(self._fd)  # the preallocation itself, once
        self._off = 0
        # pipelined committers may append concurrently (disjoint
        # batches): the offset bump and the write must stay atomic
        self._lock = threading.Lock()
        self.batches = 0
        self.fsyncs = 0

    def append_raw(self, framed: bytes) -> None:
        """Write one framed batch WITHOUT the durability point — for
        callers that coalesce several batches under one ``sync()``."""
        with self._lock:
            if len(framed) + _FRAME.size > self.capacity:
                self.capacity = len(framed) + _FRAME.size
                os.ftruncate(self._fd, self.capacity)
            if self._off + len(framed) + _FRAME.size > self.capacity:
                # recycle: rezero so stale frames past the wrap point
                # can't replay over the new live region
                os.ftruncate(self._fd, 0)
                os.ftruncate(self._fd, self.capacity)
                self._off = 0
            os.pwrite(self._fd, framed, self._off)
            self._off += len(framed)
        self.batches += 1

    def sync(self) -> None:
        if self.fsync_data:
            os.fdatasync(self._fd)
            self.fsyncs += 1

    def append_commit(self, framed: bytes) -> None:
        """Write one framed batch and make it durable — ONE fdatasync
        for every member in it."""
        self.append_raw(framed)
        self.sync()

    def replay(self) -> Dict[str, list]:
        """Decode the journal's surviving frames: proc id -> entries.
        Recovery uses this to re-ship a log tail that was flushed to the
        journal but lost from a member log file (the log skipped its own
        fsync on the group path).

        A CRC-bad frame at the decodable end is a torn tail (the crash
        interrupted the last batch's pwrite): prefix semantics, drop it.
        A CRC-bad frame with *valid frames after it* is at-rest
        corruption of an acknowledged batch — truncating there would
        silently lose it while replaying newer ones, so this raises
        ``JournalCorruption`` instead (the caller repairs from
        replicas)."""
        buf = os.pread(self._fd, self.capacity, 0)
        frames = scan_frames(buf)
        bad = next((i for i, f in enumerate(frames) if not f[2]), None)
        if bad is not None and any(f[2] for f in frames[bad + 1:]):
            raise JournalCorruption(
                f"{self.path}: frame {bad} corrupt before valid frames")
        out: Dict[str, list] = {}
        for pid, data, ok in frames:
            if not ok:
                break
            out.setdefault(pid, []).extend(decode_stream(data))
        return out

    def close(self) -> None:
        # idempotent: a node teardown (kill_node) and the final cluster
        # close may both reach the same journal
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1


class GroupSlotSink:
    """Replica-side region sink for ``gslot/<writer-node>``: one
    one-sided write delivers a whole batch; the sink routes each framed
    sub-slice into that process's ``ReplicaSlot`` (which dedups by
    seqno) and makes the batch durable with ONE journal fsync instead
    of one fsync per slot file."""

    def __init__(self, sharedfs, writer_node: str):
        self.sfs = sharedfs
        # the slots flush to the OS; this journal's ONE fdatasync is the
        # replica's durability point for the whole batch — same
        # guarantee as the pre-group path (chain ack ⇒ every replica
        # durable), amortized over the batch instead of paid per slot
        self.journal = CommitJournal(
            os.path.join(sharedfs.root, "nvm", "repl",
                         f"gc-{writer_node}.journal"),
            fsync_data=sharedfs.fsync_data)
        # the slot decode+apply work runs on this helper WHILE the
        # delivering thread sits inside the journal's fdatasync: the
        # flush genuinely releases the GIL (a blocking syscall), so on
        # a starved-core box the CPU-bound apply work rides inside the
        # flush's wall time. (Kicking the *flush* to a helper does NOT
        # work: the kicker keeps the GIL through its CPU-bound applies
        # and the helper never gets scheduled until the kicker blocks
        # — the overlap has to be anchored on the thread that blocks.)
        self._applyq: "queue.Queue" = queue.Queue()
        self._athread: Optional[threading.Thread] = None

    def write(self, offset, framed: bytes) -> None:
        # append the frame, hand the sub-slice routing to the applier,
        # then block in the journal's fdatasync. Both the flush and the
        # applies complete before this returns — the ack's guarantee
        # (batch durable at the replica) is unchanged, the batch just
        # pays max(flush, apply) instead of their sum.
        self.journal.append_raw(framed)
        done = threading.Event()
        err: List[BaseException] = []
        self._apply_async(framed, done, err)
        try:
            self.journal.sync()
        finally:
            done.wait()
        if err:
            raise err[0]

    def _apply_async(self, framed: bytes, done: threading.Event,
                     err: List[BaseException]) -> None:
        t = self._athread
        if t is None or not t.is_alive():
            t = threading.Thread(target=self._apply_loop,
                                 name="gc-sink-apply", daemon=True)
            self._athread = t
            t.start()
        self._applyq.put((framed, done, err))

    def _apply_loop(self) -> None:
        # single applier = FIFO per sink: preserves the transport's
        # ordered-delivery semantics for one-sided writes
        while True:
            item = self._applyq.get()
            if item is None:
                return
            framed, done, err = item
            try:
                for pid, data in unframe_batch(framed):
                    if data:
                        # sync=False: the slot flushes to the OS but
                        # skips its per-file fsync — the journal is the
                        # batch's durability point
                        self.sfs.slot_for(pid).write(None, data,
                                                     sync=False)
            except BaseException as e:  # noqa: BLE001
                err.append(e)
            finally:
                done.set()

    def close(self) -> None:
        t = self._athread
        if t is not None and t.is_alive():
            self._applyq.put(None)
            t.join(timeout=1.0)
        self._athread = None
        self.journal.close()


class _CommitReq:
    __slots__ = ("ls", "coalesce", "done", "error", "ctx")

    def __init__(self, ls, coalesce: bool, ctx=None):
        self.ls = ls
        self.coalesce = coalesce
        # per-request event, NOT the coordinator cv: a writer waits on
        # its own wake-up so an arrival's notify doesn't stampede every
        # blocked writer awake just to re-check and re-sleep
        self.done = threading.Event()
        self.error: Optional[BaseException] = None
        # the committing op's trace context, captured writer-side: the
        # flusher/committer threads annotate batch and ack spans into
        # it (the in-process analogue of the _trace RPC header)
        self.ctx = ctx


class GroupCommitCoordinator:
    """Per-node commit coordinator (owned by the SharedFS daemon).

    ``commit()`` is the writer-facing entry point: it enqueues the
    request and either leads a flush round (first arrival — flushes
    immediately, no batching delay for a lone writer) or blocks until a
    leader completes it. ``window_s > 0`` optionally holds a small batch
    open briefly so stragglers can join — bounded, and never applied
    when the leader is alone with a single request."""

    def __init__(self, sharedfs, *, max_batch: int = 16,
                 window_s: float = 0.0, n_committers: int = 2):
        self.sfs = sharedfs
        self.max_batch = max_batch
        self.window_s = window_s
        self.n_committers = max(1, n_committers)
        self.journal = CommitJournal(
            os.path.join(sharedfs.root, "nvm", "gc.journal"),
            fsync_data=sharedfs.fsync_data)
        self._cv = threading.Condition()
        self._queue: List[_CommitReq] = []
        self._stopped = False
        self._flusher: Optional[threading.Thread] = None
        # batch pipeline: the flusher hands gathered batches to a small
        # committer pool so one cohort's journal+ship overlaps the next
        # cohort's wake+append+re-enqueue (writers release in staggered
        # waves instead of lockstep). _idle gates the flusher: a batch
        # is taken from the queue as late as possible — only when a
        # committer can start it — so arrivals keep accumulating.
        self._dispatchq: "queue.Queue" = queue.Queue()
        self._committers: List[threading.Thread] = []
        self._idle = 0
        self._inflight = 0  # members dispatched but not yet completed
        self._active = 0.0  # decaying estimate of concurrent writers
        # arrivals-needed threshold published by the flusher: an
        # arriving writer only notifies the cv once the queue reaches
        # it, so a gathering round pays one flusher wake-up instead of
        # one per arrival (the window timeout covers shortfalls)
        self._want = 1
        self._ensured = set()  # (node, region) gslot sinks ensured
        # adaptive window state: how many members the last batch carried
        # — the leader only waits for stragglers when recent history
        # shows real concurrency, so a lone writer never eats the window
        self._last_members = 0
        # persistent journal writer: the batch's fdatasync runs here,
        # overlapped with the leader's chain ship (a per-batch thread
        # spawn would eat the overlap in scheduling latency)
        self._jq: "queue.Queue" = queue.Queue()
        self._jthread: Optional[threading.Thread] = None
        # counters live in the node's metrics registry (node.metrics)
        # under the gc. prefix; the view keeps the legacy dict API
        self.stats = sharedfs.metrics.scoped(
            "gc.", seed=("commits", "batches", "batched_members",
                         "max_batch_seen"))

    # -- writer entry point -------------------------------------------------
    def commit(self, ls, coalesce: bool = False) -> None:
        """Enqueue and block until a flush round covers this request.

        Flushing runs on a dedicated per-node flusher thread — NOT on a
        writer's thread. (An earlier writer-as-leader design deadlocked
        a writer into serving everyone else: the leader could only
        return once the queue drained, which under steady concurrency
        is never, so the first writer stopped doing its own work.)"""
        tracer = getattr(self.sfs.transport, "tracer", None)
        req = _CommitReq(ls, coalesce,
                         ctx=tracer.current() if tracer is not None
                         else None)
        with self._cv:
            if self._flusher is None or not self._flusher.is_alive():
                self._stopped = False
                self._idle = self.n_committers
                self._committers = []
                for i in range(self.n_committers):
                    t = threading.Thread(target=self._commit_loop,
                                         name=f"gc-commit-{i}", daemon=True)
                    t.start()
                    self._committers.append(t)
                self._flusher = threading.Thread(
                    target=self._flush_loop, name="gc-flush", daemon=True)
                self._flusher.start()
            self._queue.append(req)
            # wake the flusher — and close a batching window early: the
            # window ends as soon as the expected stragglers arrive, it
            # is not a fixed sleep. Arrivals below the published
            # ``_want`` threshold skip the notify (the flusher would
            # just re-check and re-sleep); the window timeout bounds
            # the wait if the expected stragglers never come.
            if len(self._queue) >= self._want:
                self._cv.notify_all()
        req.done.wait()
        if req.error is not None:
            raise req.error

    def _flush_loop(self) -> None:
        while True:
            with self._cv:
                self._want = 1  # any arrival must wake us from here
                while (not self._queue or self._idle == 0) \
                        and not self._stopped:
                    self._cv.wait()
                if self._stopped:
                    return
                # evidence of concurrency: another batch is still on
                # the wire, or the last batch carried several members.
                # Either justifies holding this batch open briefly.
                overlap = self._inflight > 0
                if self.window_s > 0 and len(self._queue) < self.max_batch \
                        and (len(self._queue) > 1 or self._last_members > 1
                             or overlap):
                    # bounded batching window: hold the batch open only
                    # for the writers that can actually still arrive —
                    # the active estimate minus the members locked up in
                    # in-flight batches (waiting for those would just
                    # re-serialize the committer pipeline). Arrivals
                    # notify the cv, so the window closes early once
                    # they show up. A lone writer never waits: with no
                    # batch in flight and history and queue both at one
                    # member, this branch is dead.
                    deadline = time.monotonic() + self.window_s
                    while True:
                        free = int(self._active) - self._inflight
                        want = min(self.max_batch, max(1, free))
                        if len(self._queue) >= want:
                            break
                        left = deadline - time.monotonic()
                        if left <= 0:
                            break
                        self._want = want  # arrivals below this stay quiet
                        self._cv.wait(left)
                    self._want = 1
                batch = self._queue[:self.max_batch]
                del self._queue[:len(batch)]
                self._idle -= 1
                self._inflight += len(batch)
                # concurrency estimate: everything committing plus
                # everything queued right now, decayed so a drop in
                # writer count is forgotten within a few rounds
                cur = self._inflight + len(self._queue)
                self._active = max(float(cur), 0.9 * self._active)
            self._dispatchq.put(batch)

    def _commit_loop(self) -> None:
        while True:
            batch = self._dispatchq.get()
            if batch is None:
                return
            try:
                self._flush(batch)
            except BaseException as e:  # noqa: BLE001 — fan to waiters
                for r in batch:
                    if r.error is None:
                        r.error = e
            for r in batch:
                r.done.set()
            with self._cv:
                self._idle += 1
                self._inflight -= len(batch)
                self._cv.notify_all()

    # -- one flush round ----------------------------------------------------
    def _flush(self, batch: List[_CommitReq]) -> None:
        # one req per process (a proc's committing thread blocks until
        # its req completes, so duplicates only arise from multi-
        # threaded use of one LibState — collapse them; one flush
        # covers both)
        reqs: Dict[str, _CommitReq] = {}
        for r in batch:
            reqs.setdefault(r.ls.proc_id, r)
        members = sorted(reqs.values(), key=lambda r: r.ls.proc_id)
        with self._cv:  # committers run concurrently; keep counts exact
            self.stats["commits"] += len(batch)
            self.stats["batches"] += 1
            self.stats["batched_members"] += len(members)
            self.stats["max_batch_seen"] = max(self.stats["max_batch_seen"],
                                               len(members))
        for r in members:
            if r.ctx is not None:
                r.ctx.annotate("gc.batch", node=self.sfs.node_id,
                               members=len(members))
        plan = []  # (req, chain tuple, since, last, data)
        held = []
        try:
            for r in members:
                ls = r.ls
                ls._repl_lock.acquire()
                held.append(ls._repl_lock)
                try:
                    chain = ls.chain
                    # settle any pipelined sealed-region ship first: the
                    # batch's slice starts at the submitted watermark,
                    # and an in-flight older range landing AFTER the
                    # batch would be dropped by the slots' seqno dedup
                    chain.wait_acked(chain.submitted_seqno)
                    since = chain.submitted_seqno
                    pending = ls.log.entries_since(since)
                    if not pending:
                        ls.log.flush_to_os()
                        continue
                    if r.coalesce:
                        reduced = UpdateLog.coalesce(pending)
                        ls.stats["coalesced_out"] += \
                            len(pending) - len(reduced)
                        data = b"".join(e.encode() for e in reduced)
                    else:
                        data = ls.log.encoded_since(since)
                    # member log: NOT flushed here, not even to the OS
                    # — the journal fsync below holds this very slice,
                    # so a crashed member's file tail is rebuilt from
                    # ``CommitJournal.replay`` (the log's buffered
                    # writer drains to the OS on its own as it fills,
                    # and every seal/rotation flushes before swapping
                    # files); eight per-batch flush syscalls buy
                    # nothing durability-wise
                    plan.append((r, tuple(chain.chain), since,
                                 pending[-1].seqno, data))
                except BaseException as e:  # noqa: BLE001
                    r.error = e
            jdone: Optional[threading.Event] = None
            jerr: List[BaseException] = []
            if plan:
                # THE single fdatasync of the whole batch — run on the
                # journal writer thread, overlapped with the chain ship
                # below (the commit is acked only after BOTH complete),
                # so a batch pays max(local sync, remote ship), not sum
                framed = frame_batch(
                    [(p[0].ls.proc_id, p[4]) for p in plan])
                jdone = threading.Event()
                self._journal_async(framed, jdone, jerr)
            # one framed one-sided write + one payload-free RPC per
            # distinct chain (members over the same chain share it)
            groups: Dict[tuple, list] = {}
            for p in plan:
                groups.setdefault(p[1], []).append(p)
            for chain, grp in groups.items():
                try:
                    self._ship_group(chain, grp)
                except BaseException as e:  # noqa: BLE001
                    for r, *_ in grp:
                        if r.error is None:
                            r.error = e
            if jdone is not None:
                jdone.wait()
                if jerr:
                    for r in batch:
                        if r.error is None:
                            r.error = jerr[0]
        finally:
            for lk in reversed(held):
                lk.release()
            self._last_members = len(members)

    def _journal_async(self, framed: bytes, done: threading.Event,
                       err: List[BaseException]) -> None:
        t = self._jthread
        if t is None or not t.is_alive():
            t = threading.Thread(target=self._journal_loop,
                                 name="gc-journal", daemon=True)
            self._jthread = t
            t.start()
        self._jq.put((framed, done, err))

    def _journal_loop(self) -> None:
        while True:
            item = self._jq.get()
            if item is None:
                return
            # coalesce: pipelined committers may both have a batch
            # pending — write every queued frame, then pay ONE
            # fdatasync for all of them (group commit of group commits)
            pending = [item]
            while True:
                try:
                    nxt = self._jq.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    self._jq.put(None)  # re-arm shutdown
                    break
                pending.append(nxt)
            try:
                for framed, _done, _err in pending:
                    self.journal.append_raw(framed)
                self.journal.sync()
            except BaseException as e:  # noqa: BLE001
                for _framed, _done, err in pending:
                    err.append(e)
            finally:
                for _framed, done, _err in pending:
                    done.set()

    def _ship_group(self, chain: tuple, grp: list) -> None:
        if not chain:  # replication factor 1: durable locally is acked
            for r, _c, _s, last, _d in grp:
                r.ls.chain.mark_acked(last)
            return
        tr = self.sfs.transport
        wnode = self.sfs.node_id
        region = f"gslot/{wnode}"
        with tr.act_as(wnode):
            for nid in chain:
                if (nid, region) not in self._ensured:
                    with_retries(
                        lambda n=nid: tr.rpc(n, "ensure_group_sink",
                                             wnode,
                                             _epoch=self.sfs.view_epoch),
                        stats=tr.stats)
                    self._ensured.add((nid, region))
        framed = frame_batch([(p[0].ls.proc_id, p[4]) for p in grp])
        items = [(p[0].ls.proc_id, p[2], p[3]) for p in grp]
        head, rest = chain[0], list(chain[1:])
        pushed = [False]

        def _attempt():
            # epoch read fresh per attempt: a fenced first try followed
            # by a view refresh must carry the new header on the retry
            ep = self.sfs.view_epoch
            if not pushed[0]:
                # push-once: an RPC retry after a dropped ack must not
                # re-ship the payload bytes (the slots already hold
                # them; the wire-bytes audit pins this down)
                tr.one_sided_write(head, region, framed, _epoch=ep)
                pushed[0] = True
            # writer dies between the batch write and the continue RPC:
            # the head holds every member's bytes, no ack happened
            tr.crashpoint("chain.mid", wnode)
            return tr.rpc(head, "group_continue", wnode, items, rest,
                          _epoch=ep)

        # the batch shares one wire ship: its spans attach to the first
        # traced member's context (the others still get batch/ack spans)
        tracer = getattr(tr, "tracer", None)
        ctxs = [p[0].ctx for p in grp if p[0].ctx is not None]
        tok = tracer.push(ctxs[0]) if tracer is not None and ctxs else None
        try:
            with tr.act_as(wnode):
                acks = with_retries(_attempt, stats=tr.stats)
        finally:
            if tracer is not None and ctxs:
                tracer.pop(tok)
        for (r, _c, _s, last, _d), ack in zip(grp, acks):
            assert ack >= last, (ack, last)
            r.ls.chain.mark_acked(last)
            if r.ctx is not None:
                r.ctx.annotate("repl.ack", node=wnode, seqno=last)

    def close(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        f = self._flusher
        if f is not None and f.is_alive():
            f.join(timeout=1.0)
        self._flusher = None
        for t in self._committers:
            self._dispatchq.put(None)
        for t in self._committers:
            if t.is_alive():
                t.join(timeout=1.0)
        self._committers = []
        t = self._jthread
        if t is not None and t.is_alive():
            self._jq.put(None)
            t.join(timeout=1.0)
        self._jthread = None
        self.journal.close()

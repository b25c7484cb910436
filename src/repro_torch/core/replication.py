"""Chain replication of update-log segments (paper §3.2/§4.1).

The writer performs an RDMA-like one-sided write of the encoded log
segment into the next replica's *replica slot* (reserved NVM), then RPCs
it to continue the chain; the ack returns through the nested calls —
exactly the paper's A1/A2 flow. Ordering of one-sided writes gives the
replicated log prefix semantics for free.

The wire payload is the log's **pre-encoded** byte range
(``UpdateLog.encoded_since`` — one buffer slice), so replicating N
entries costs zero per-entry re-encoding on the writer. Each
``ReplicaSlot`` decodes its byte stream incrementally, keeps a
``seqno -> byte-offset`` index over it, and maintains an in-memory
mirror index, so a failover target already has the dead process's cache
state materialized (near-instant failover).

Byte-range writes (``OP_WRITE``) replicate only the written range: the
mirror keeps a per-path, tombstone-aware ``ExtentOverlay`` when the
base value is not in the slot; reads assemble extents over the node's
lower tiers (see ``SharedFS.read_any``).
"""
from __future__ import annotations

import bisect
import contextlib
import os
import threading
from collections import deque
from typing import List, Optional

from repro_torch.core.log import _HDR, _WRITE_BUF  # wire header / buffer size
from repro_torch.core.extents import apply_range_write
from repro_torch.core.integrity import full_sum, prefix_sums
from repro_torch.core.log import (Entry, affected_paths, decode_stream,
                            renames_touch)
from repro_torch.core.transport import next_rkey, with_retries


def _apply_to_table(table: dict, e: Entry) -> None:
    """Entry application into a plain ``path -> value`` dict — the
    scratch-table form of ``ReplicaSlot._apply`` used by truncation to
    precompute survivor state before touching the live mirror."""
    from repro_torch.core import log as L
    if e.op == L.OP_PUT:
        table[e.path] = e.data
    elif e.op == L.OP_DELETE:
        table[e.path] = None  # tombstone
    elif e.op == L.OP_WRITE:
        apply_range_write(table, e.path, e.offset, e.data)
    elif e.op == L.OP_RENAME:
        val = table.get(e.path)
        table[e.path] = None  # tombstone first: self-rename safe
        if val is not None:
            table[e.data.decode()] = val


class ReplicaSlot:
    """File-backed replica region for one writer process.

    ``index``, when given, is the owning SharedFS's shared
    ``path -> slot`` reverse index: every mirror insert/remove updates
    it, so ``read_any``/``in_slot`` cost one dict hit instead of a scan
    over every slot's mirror.
    """

    def __init__(self, path: str, fsync_data: bool = False, *,
                 index: Optional[dict] = None):
        self.path = path
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self._f = open(path, "ab+", buffering=_WRITE_BUF)
        self.fsync_data = fsync_data
        self._buf = bytearray()
        self.entries: List[Entry] = []
        self._offsets: List[int] = []  # entry i -> offset into _buf
        self._seqnos: List[int] = []   # entry i -> seqno (bisect key)
        self.mirror = {}  # path -> bytes (latest, undigested)
        self._index = index if index is not None else {}
        # path -> (byte offset into _buf, length, checksum) for mirror
        # values that are plain full PUTs: a remote reader can
        # one-sided-read them straight out of the slot region, no
        # server work, and verify the pulled range. The checksum is the
        # full-value sum (integrity.full_sum — computed from the
        # decoded entry bytes, i.e. the mirror's truth, one cheap call
        # on the replication apply path) until the first locate expands
        # it into the chunk prefix-sum table, validated against that
        # sum (see locate). Dropped the moment the mirror value stops
        # being the raw needle bytes (range patch, delete, rename);
        # rebuilt on truncation.
        self._locs: dict = {}
        self.rkey = next_rkey()  # one-sided region key (see transport)
        self.region_id: Optional[str] = None  # set at registration
        self.acked_seqno = 0
        self.digested_seqno = 0
        # serializes appends (chain writes) against truncation (digest
        # fan-out runs on the writer's background worker): both reshape
        # the entry/offset lists and the slot file
        self._lock = threading.RLock()
        self._recover()

    def _recover(self) -> None:
        self._f.seek(0)
        buf = self._f.read()
        entries = decode_stream(buf)
        valid = sum(e.nbytes for e in entries)
        self._buf = bytearray(buf[:valid])
        self._ingest(entries, 0)
        if valid < len(buf):
            # torn tail from a crash mid one-sided write: repair it now
            # so later appends don't land after undecodable garbage
            self._f.close()
            with open(self.path, "rb+") as f:
                f.truncate(valid)
            self._f = open(self.path, "ab+", buffering=_WRITE_BUF)

    def _ingest(self, new: List[Entry], start_off: int) -> None:
        off = start_off
        for e in new:
            self.entries.append(e)
            self._offsets.append(off)
            self._seqnos.append(e.seqno)
            self._apply(e, off)
            off += e.nbytes
        if new:
            self.acked_seqno = new[-1].seqno

    def _mirror_set(self, path: str, val) -> None:
        self.mirror[path] = val
        self._index[path] = self

    def _mirror_del(self, path: str) -> None:
        self.mirror.pop(path, None)
        if self._index.get(path) is self:
            del self._index[path]

    def _apply(self, e: Entry, off: Optional[int] = None) -> None:
        from repro_torch.core import log as L
        if e.op == L.OP_PUT:
            self._mirror_set(e.path, e.data)
            if off is not None:
                self._locs[e.path] = (
                    off + _HDR.size + len(e.path.encode()), len(e.data),
                    full_sum(e.data))
            else:
                self._locs.pop(e.path, None)
        elif e.op == L.OP_DELETE:
            self._mirror_set(e.path, None)  # tombstone
            self._locs.pop(e.path, None)
        elif e.op == L.OP_WRITE:
            apply_range_write(self.mirror, e.path, e.offset, e.data)
            self._index[e.path] = self
            self._locs.pop(e.path, None)  # mirror != raw needle bytes now
        elif e.op == L.OP_RENAME:
            val = self.mirror.get(e.path)
            self._mirror_set(e.path, None)  # tombstone first: self-rename safe
            self._locs.pop(e.path, None)
            self._locs.pop(e.data.decode(), None)
            if val is not None:
                self._mirror_set(e.data.decode(), val)

    def locate(self, path: str) -> Optional[tuple]:
        """(buf offset, length, rkey, prefix CRCs) of the path's full
        value when it is a plain PUT needle in the slot buffer —
        one-sided readable and range-verifiable. The rkey is captured
        under the slot lock so the tuple is internally consistent even
        if a truncation lands right after."""
        with self._lock:
            loc = self._locs.get(path)
            if loc is None:
                return None
            boff, n, pc = loc
            if isinstance(pc, int):
                # lazy expansion (see SegmentStore._chunk_sums): the
                # apply path stored only the full-value sum; expand the
                # chunk table from the region bytes and validate it
                # against that sum — on mismatch the region has rotted
                # and the int is handed back so the caller poisons the
                # descriptor instead of caching lies
                expanded = prefix_sums(self._buf[boff:boff + n])
                if expanded[-1] == pc:
                    self._locs[path] = (boff, n, expanded)
                    pc = expanded
            return (boff, n, self.rkey, pc)

    # -- integrity (scrub/repair surface) ----------------------------------
    def verify(self, path: str) -> Optional[bool]:
        """Region bytes of the path's plain-PUT needle still match the
        chunk CRCs computed at apply time. None when the path has no
        one-sided location (nothing a remote reader could pull)."""
        with self._lock:
            loc = self._locs.get(path)
            if loc is None:
                return None
            boff, n, pc = loc
            want = pc if isinstance(pc, int) else pc[-1]
            return full_sum(bytes(self._buf[boff:boff + n])) == want

    def repair_region(self) -> int:
        """Rewrite the whole region buffer (and its backing file) from
        the decoded entry mirror — ``Entry.encode`` is deterministic, so
        the rebuilt bytes equal the originally-replicated stream and
        every ``_locs`` offset stays valid. Outstanding one-sided
        handles are failed closed first (rkey bump). Returns the number
        of bytes rewritten."""
        with self._lock:
            self.rkey = next_rkey()
            fresh = b"".join(e.encode() for e in self.entries)
            self._buf = bytearray(fresh)
            self._f.flush()
            self._f.close()
            nxt = self.path + ".next"
            with open(nxt, "wb") as f:
                f.write(fresh)
            os.replace(nxt, self.path)
            self._f = open(self.path, "ab+", buffering=_WRITE_BUF)
            if self.fsync_data:
                os.fsync(self._f.fileno())
            return len(fresh)

    # transport sink interface -------------------------------------------------
    def write(self, offset: Optional[int], data: bytes,
              sync: bool = True) -> None:
        """One-sided append (RDMA WRITE). Persist + decode new entries.

        Idempotent by seqno: entries at or below the slot's tail (or its
        digested watermark when empty) are skipped, so a retransmitted
        write — a retried chain step after a dropped ack, or an injected
        duplicate delivery — never double-applies. Entries in one stream
        have strictly increasing seqnos, so the survivors are a byte
        suffix of ``data``.

        ``sync=False`` flushes to the OS but skips the per-file fsync:
        the group-commit sink calls it once per batch member and makes
        the whole batch durable with ONE journal fsync instead (see
        ``groupcommit.GroupSlotSink``)."""
        with self._lock:
            entries = decode_stream(data)
            tail = (self.entries[-1].seqno if self.entries
                    else self.digested_seqno)
            keep = [e for e in entries if e.seqno > tail]
            if not keep:
                return
            if len(keep) != len(entries):
                skip = sum(e.nbytes for e in entries[:len(entries)
                                                    - len(keep)])
                data = data[skip:]
            self._f.write(data)
            self._f.flush()
            if sync and self.fsync_data:
                os.fsync(self._f.fileno())
            start = len(self._buf)
            self._buf += data
            self._ingest(keep, start)

    def read(self, offset: int, size: int) -> bytes:
        # locked: a concurrent truncation reshapes _buf, and a one-sided
        # read must see either the pre- or post-truncate buffer whole
        # (the transport's after-read rkey check then rejects the
        # post-truncate case)
        with self._lock:
            return bytes(self._buf[offset: offset + size])

    def _idx_after(self, seqno: int) -> int:
        return bisect.bisect_right(self._seqnos, seqno)

    def entries_since(self, seqno: int) -> List[Entry]:
        return self.entries[self._idx_after(seqno):]

    def suffix_bytes(self, seqno: int) -> bytes:
        """Raw encoded bytes of every entry with a seqno beyond
        ``seqno`` — the wire form a peer slot can ingest directly."""
        with self._lock:
            i = self._idx_after(seqno)
            cut = (self._offsets[i] if i < len(self.entries)
                   else len(self._buf))
            return bytes(self._buf[cut:])

    def truncate_through(self, seqno: int) -> None:
        """Drop digested entries by rotating the undigested suffix into
        a fresh slot file (single slice write + atomic ``os.replace``).
        The mirror is maintained incrementally: only paths the dropped
        entries touched are recomputed (restricted replay of the
        surviving suffix), not the whole mirror."""
        with self._lock:
            self._truncate_locked(seqno)

    def _truncate_locked(self, seqno: int) -> None:
        i = self._idx_after(seqno)
        cut = self._offsets[i] if i < len(self.entries) else len(self._buf)
        dropped = self.entries[:i]
        self.entries = self.entries[i:]
        self._offsets = [o - cut for o in self._offsets[i:]]
        self._seqnos = self._seqnos[i:]
        # the slot region's memory is about to be reused (offsets
        # shift): invalidate outstanding one-sided handles FIRST — a
        # racing reader that validated against the old key must fail
        # its after-read check, never see the shifted buffer as valid
        self.rkey = next_rkey()
        self._buf = self._buf[cut:]
        # rebuild the plain-value location map over the survivors
        self._locs.clear()
        from repro_torch.core import log as L
        for e, off in zip(self.entries, self._offsets):
            if e.op == L.OP_PUT:
                self._locs[e.path] = (
                    off + _HDR.size + len(e.path.encode()), len(e.data),
                    full_sum(e.data))
            elif e.op in (L.OP_DELETE, L.OP_WRITE):
                self._locs.pop(e.path, None)
            elif e.op == L.OP_RENAME:
                self._locs.pop(e.path, None)
                self._locs.pop(e.data.decode(), None)
        self.digested_seqno = max(self.digested_seqno, seqno)
        self._f.flush()
        self._f.close()
        nxt = self.path + ".next"
        with open(nxt, "wb") as f:
            f.write(self._buf)
        os.replace(nxt, self.path)  # segment rotation
        self._f = open(self.path, "ab+", buffering=_WRITE_BUF)
        # Mirror maintenance is gap-free for concurrent readers
        # (read_any runs lockless on another thread): the survivors'
        # state is computed into a scratch table first, then applied as
        # per-path set/delete — a reader sees either the pre-truncate
        # value or the post-truncate one, never a transient miss that
        # would fall through to the hot area's older prefix.
        affected = affected_paths(dropped)
        scratch = {}
        if renames_touch(self.entries, affected):
            # a surviving rename moves state across an affected path:
            # restricted replay can't order that — full rebuild (rare)
            for e in self.entries:
                _apply_to_table(scratch, e)
            for p, v in scratch.items():
                self._mirror_set(p, v)
            for p in list(self.mirror):
                if p not in scratch:
                    self._mirror_del(p)
            return
        for e in self.entries:
            if e.path in affected:
                _apply_to_table(scratch, e)
        for p in affected:
            if p in scratch:
                self._mirror_set(p, scratch[p])
            else:
                self._mirror_del(p)

    def close(self):
        self._f.close()


class ChainClient:
    """Writer-side chain replication, with a pipelined sender.

    Transient wire faults (``RpcTimeout``) are absorbed by bounded
    retries — safe because ``ReplicaSlot.write`` dedups by seqno, so a
    retried one-sided write + chain_continue is idempotent end to end.
    ``NodeDown`` still surfaces: a dead replica cannot ack, and the
    caller's next op after failure detection refreshes the chain (see
    ``LibState._check_epoch``).

    Pipelining (``submit``/``wait_acked``): a sealed log region is
    handed to a background sender and shipped over the chain while the
    next region fills — the digest worker overlaps the local apply with
    the wire time. Two watermarks track the split: ``submitted_seqno``
    (highest seqno handed to the sender; new slices start past it) and
    ``replicated_seqno`` (highest chain-acked seqno; fsync/dsync wait
    only on their own watermark via ``wait_acked``). The in-flight
    window is bounded (``window`` queued slices) so a stalled chain
    backpressures the pipeline instead of buffering unboundedly. A
    sender failure parks in ``_error`` and surfaces at the next
    submit/wait; ``reset()`` (called after a chain refresh) clears it
    and rewinds ``submitted_seqno`` so unacked ranges re-ship to the
    repaired chain — duplicate delivery is absorbed by slot dedup."""

    def __init__(self, proc_id: str, chain: List[str], transport,
                 owner: Optional[str] = None, window: int = 4,
                 epoch_fn=None, deadline_s: Optional[float] = None):
        self.proc_id = proc_id
        self.chain = list(chain)  # replica node ids, in order (no self)
        self.transport = transport
        self.owner = owner  # writer's node id (crash-point identity)
        # epoch_fn() -> the writer's current view epoch, read fresh per
        # attempt so every ship carries an honest header; None = unfenced
        self.epoch_fn = epoch_fn
        # total-elapsed retry bound per ship (see with_retries): during
        # a partition the writer surfaces RpcTimeout within this budget
        self.deadline_s = deadline_s
        self.replicated_seqno = 0  # chain-acked watermark
        self.submitted_seqno = 0   # handed to the sender (>= acked)
        self.window = window
        self._cv = threading.Condition()
        self._sendq: deque = deque()  # (last_seqno, data) in seqno order
        self._sender: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._stopped = False

    # -- acked-watermark bookkeeping ---------------------------------------
    def mark_acked(self, seqno: int) -> None:
        """Advance both watermarks to an externally-acked seqno (group
        commit acks whole batches at once) and wake waiters."""
        with self._cv:
            self.replicated_seqno = max(self.replicated_seqno, seqno)
            self.submitted_seqno = max(self.submitted_seqno, seqno)
            self._cv.notify_all()

    def wait_acked(self, seqno: int) -> None:
        """Block until the chain has acked through ``seqno`` — the
        caller's own watermark, nothing newer. Raises the sender's
        parked error if the ack can never arrive."""
        if self.replicated_seqno >= seqno and self._error is None:
            return  # fast path: watermark reads are GIL-atomic
        with self._cv:
            while self.replicated_seqno < seqno and self._error is None:
                self._cv.wait()
            if self._error is not None and self.replicated_seqno < seqno:
                raise self._error

    def reset(self) -> None:
        """After a chain refresh (epoch bump / repair): drop the parked
        error and queued slices, rewind the submitted watermark to the
        acked one — the next replicate/submit re-ships the unacked range
        to the new chain (receivers dedup by seqno)."""
        with self._cv:
            self._error = None
            self._sendq.clear()
            self.submitted_seqno = self.replicated_seqno
            self._cv.notify_all()

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()

    # -- pipelined ship (sealed regions) ------------------------------------
    def submit(self, last_seqno: int, data: bytes, ctx=None) -> None:
        """Queue a pre-encoded slice ending at ``last_seqno`` for
        asynchronous shipping; returns once queued (bounded window).
        The caller must have computed ``data`` starting exactly at the
        current ``submitted_seqno`` (slices must tile the stream).
        ``ctx`` is an optional trace context that rides the queue to the
        sender thread, so the ship's wire spans land in the submitting
        op's trace."""
        if not self.chain:
            self.mark_acked(last_seqno)
            return
        with self._cv:
            while len(self._sendq) >= self.window and self._error is None:
                self._cv.wait()
            if self._error is not None:
                raise self._error
            self._sendq.append((last_seqno, data, ctx))
            self.submitted_seqno = max(self.submitted_seqno, last_seqno)
            self._stopped = False
            t = self._sender
            if t is None or not t.is_alive():
                t = threading.Thread(target=self._sender_loop,
                                     name=f"chainsend-{self.proc_id}",
                                     daemon=True)
                self._sender = t
                t.start()
            self._cv.notify_all()

    def _sender_loop(self) -> None:
        while True:
            with self._cv:
                while not self._sendq and not self._stopped:
                    self._cv.wait()
                if not self._sendq:
                    return  # stopped and drained
                last, data, ctx = self._sendq[0]
            # the queued slice carries its submitter's trace context:
            # activate it so the ship's wire spans attach to that trace
            tracer = getattr(self.transport, "tracer", None)
            tok = tracer.push(ctx) if tracer is not None else None
            try:
                self._ship(last, data)
            except BaseException as e:  # parked: surfaces at next wait
                with self._cv:
                    self._error = e
                    self._sendq.clear()
                    self._cv.notify_all()
                return
            finally:
                if tracer is not None:
                    tracer.pop(tok)
            with self._cv:
                if self._sendq and self._sendq[0][0] == last:
                    self._sendq.popleft()
                self.replicated_seqno = max(self.replicated_seqno, last)
                self._cv.notify_all()

    def _sendctx(self):
        """Sender identity for transport ops: the background sender
        thread has no inherited identity, so declare the owner's."""
        if self.owner is None:
            return contextlib.nullcontext()
        return self.transport.act_as(self.owner)

    def _ship(self, last_seqno: int, data: bytes) -> None:
        head, rest = self.chain[0], self.chain[1:]
        region = f"slot/{self.proc_id}"

        def _attempt():
            ep = self.epoch_fn() if self.epoch_fn is not None else None
            with self._sendctx():
                self.transport.one_sided_write(head, region, data,
                                               _epoch=ep)
                if self.owner is not None:
                    self.transport.crashpoint("chain.mid", self.owner)
                return self.transport.rpc(head, "chain_continue",
                                          self.proc_id, data, rest,
                                          _epoch=ep)

        ack = with_retries(_attempt, stats=self.transport.stats,
                           deadline_s=self.deadline_s)
        assert ack >= last_seqno, (ack, last_seqno)

    # -- synchronous replicate (fsync/dsync path) ----------------------------
    def replicate(self, entries: List[Entry],
                  data: Optional[bytes] = None) -> int:
        """Synchronously chain-replicate; returns acked seqno.

        ``data``, when given, is the caller's pre-encoded byte range for
        ``entries`` (e.g. ``UpdateLog.encoded_since``) and is forwarded
        as-is — the zero-copy path. Without it the entries are encoded
        here (coalesced batches have no contiguous file range). Any
        pipelined slices still in flight are waited out first so the
        wire stream stays seqno-ordered."""
        if not entries:
            return self.replicated_seqno
        self.wait_acked(self.submitted_seqno)
        if not self.chain:
            self.mark_acked(entries[-1].seqno)
            return self.replicated_seqno
        if data is None:
            data = b"".join(e.encode() for e in entries)
        ack = self._ship_sync(entries[-1].seqno, data)
        self.mark_acked(entries[-1].seqno)
        assert ack >= entries[-1].seqno, (ack, entries[-1].seqno)
        return self.replicated_seqno

    def _ship_sync(self, last_seqno: int, data: bytes) -> int:
        head, rest = self.chain[0], self.chain[1:]
        region = f"slot/{self.proc_id}"

        def _attempt():
            ep = self.epoch_fn() if self.epoch_fn is not None else None
            with self._sendctx():
                self.transport.one_sided_write(head, region, data,
                                               _epoch=ep)
                if self.owner is not None:
                    # writer dies between the slot write and the continue
                    # RPC: the head holds the bytes, the ack never happened
                    self.transport.crashpoint("chain.mid", self.owner)
                return self.transport.rpc(head, "chain_continue",
                                          self.proc_id, data, rest,
                                          _epoch=ep)

        return with_retries(_attempt, stats=self.transport.stats,
                            deadline_s=self.deadline_s)

    def digest_fanout(self, through_seqno: int) -> None:
        """Make every replica digest its slot through ``through_seqno``
        with ONE writer RPC: the request forwards down the chain
        (``digest_slot_chain``) instead of the writer paying a
        round-trip per replica."""
        if not self.chain:
            return

        def _attempt():
            ep = self.epoch_fn() if self.epoch_fn is not None else None
            with self._sendctx():
                return self.transport.rpc(
                    self.chain[0], "digest_slot_chain", self.proc_id,
                    through_seqno, self.chain[1:], _epoch=ep)

        with_retries(_attempt, stats=self.transport.stats,
                     deadline_s=self.deadline_s)

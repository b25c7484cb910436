"""Operation-granularity persistent update log (the heart of CC-NVM).

Every mutating operation is appended *at its own granularity* — no block
rounding, no write amplification for small IO (paper §3.3). The log file
is the process's "NVM" region: entries carry a CRC and a strictly
increasing seqno, so replay after a crash recovers exactly the maximal
verifiable **prefix** of the write history (prefix semantics), stopping
at the first torn/corrupt record.

``OP_WRITE`` is the byte-range write: the entry carries an ``offset``
and only the written bytes, so a 64-byte update to a 4 MB object logs
(and replicates, and digests) 64 bytes. A whole-value ``OP_PUT`` is the
degenerate case (offset 0, full length). The log hashtable holds an
``ExtentOverlay`` for paths whose base value lives below the log.

``coalesce`` implements the optimistic-mode redundant-write elimination
(paper §3.3 / Strata): superseded PUTs to the same path are dropped when
no intervening rename/delete touches that path; range writes fold into a
pending PUT of the same path, and overlapping/adjacent ranges merge into
one entry instead of shipping each write separately.

The log is **double-buffered** for the digest pipeline (paper §3.1:
SharedFS digests in the background while LibFS keeps writing):
``seal()`` snapshots the current active region into an immutable
``SealedRegion`` and resets the active region, so a background digest
worker can replicate/apply the sealed entries while ``append`` keeps
landing new ones. Reads, ``entries_since`` and ``encoded_since`` span
the seal boundary; ``truncate_through`` (the post-digest reap) drops the
sealed region and rebuilds only the index entries its paths touched.
"""
from __future__ import annotations

import bisect
import os
import struct
import threading
import zlib
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional

from repro_torch.core.extents import apply_range_write, splice

# userspace append buffer: persist() is the durability point, so
# appends between persists should not pay a syscall each
_WRITE_BUF = 1 << 20

MAGIC = 0xA551_5E00
OP_PUT = 1
OP_DELETE = 2
OP_RENAME = 3
OP_TXN = 4  # transaction barrier wrapping a coalesced replication batch
OP_WRITE = 5  # byte-range write: data patched at Entry.offset

# magic, seqno, op, path_len, data_len, offset, crc
_HDR = struct.Struct("<IQBHIQi")
_OFF = struct.Struct("<Q")


@dataclass(frozen=True)
class Entry:
    seqno: int
    op: int
    path: str
    data: bytes
    offset: int = 0  # byte offset for OP_WRITE; 0 for whole-value ops

    def encode(self) -> bytes:
        p = self.path.encode()
        crc = zlib.crc32(_OFF.pack(self.offset) + p + self.data) & 0x7FFFFFFF
        return _HDR.pack(MAGIC, self.seqno, self.op, len(p), len(self.data),
                         self.offset, crc) + p + self.data

    @property
    def nbytes(self) -> int:
        return _HDR.size + len(self.path.encode()) + len(self.data)


def decode_stream(buf: bytes) -> List[Entry]:
    """Decode entries, stopping at the first corrupt/torn record (prefix)."""
    out, off = [], 0
    n = len(buf)
    while off + _HDR.size <= n:
        magic, seqno, op, plen, dlen, eoff, crc = _HDR.unpack_from(buf, off)
        if magic != MAGIC:
            break
        end = off + _HDR.size + plen + dlen
        if end > n:
            break  # torn write
        p = buf[off + _HDR.size: off + _HDR.size + plen]
        d = buf[off + _HDR.size + plen: end]
        if (zlib.crc32(_OFF.pack(eoff) + p + d) & 0x7FFFFFFF) != crc:
            break  # corruption: cut the history here
        out.append(Entry(seqno, op, p.decode(), bytes(d), eoff))
        off = end
    return out


def affected_paths(entries: Iterable[Entry]) -> set:
    """Every path whose index/mirror state the entries may have set
    (rename also lands state at its destination)."""
    out = set()
    for e in entries:
        out.add(e.path)
        if e.op == OP_RENAME:
            out.add(e.data.decode())
    return out


def renames_touch(entries: Iterable[Entry], paths: set) -> bool:
    """Whether any entry is a rename whose src or dst is in ``paths`` —
    the one case where a per-path restricted replay can't reproduce the
    full replay (renames move state *between* paths)."""
    for e in entries:
        if e.op == OP_RENAME and (e.path in paths
                                  or e.data.decode() in paths):
            return True
    return False


class SealedRegion:
    """Immutable snapshot of a log's sealed-but-undigested prefix.

    Handed to the SharedFS digest worker at seal time; the writer keeps
    appending to the log's fresh active region. All views are read-only
    so the worker needs no locks against the appending writer.
    """

    __slots__ = ("entries", "buf", "offsets", "seqnos", "nbytes")

    def __init__(self, entries: List[Entry], buf: bytes,
                 offsets: List[int], seqnos: List[int], nbytes: int):
        self.entries = entries
        self.buf = buf
        self.offsets = offsets
        self.seqnos = seqnos
        self.nbytes = nbytes

    @property
    def last_seqno(self) -> int:
        return self.seqnos[-1]

    def _idx_after(self, seqno: int) -> int:
        return bisect.bisect_right(self.seqnos, seqno)

    def entries_since(self, seqno: int) -> List[Entry]:
        return self.entries[self._idx_after(seqno):]

    def encoded_since(self, seqno: int) -> bytes:
        i = self._idx_after(seqno)
        if i >= len(self.entries):
            return b""
        return self.buf[self.offsets[i]:]


class UpdateLog:
    """File-backed, append-only update log with in-memory indexes.

    The in-memory ``index`` is the paper's "log hashtable" (Fig. 10):
    path -> latest value among un-digested entries, for O(1) read hits on
    recently written data.

    The replication path is indexed too: the undigested suffix of the
    file is mirrored in an in-memory byte buffer with a parallel
    ``seqno -> byte-offset`` index, so ``encoded_since`` hands the chain
    a contiguous pre-encoded byte range in one slice — no per-entry
    re-encode per replicate — and ``truncate_through`` rotates the
    suffix into a fresh segment file with one write + ``os.replace``
    instead of re-encoding every surviving entry.
    """

    def __init__(self, path: str, capacity_bytes: int = 1 << 30,
                 fsync_data: bool = False, start_seqno: int = 0):
        self.path = path
        self.capacity = capacity_bytes
        self.fsync_data = fsync_data
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self._f = open(path, "ab+", buffering=_WRITE_BUF)
        self._entries: List[Entry] = []
        self._buf = bytearray()    # encoded undigested suffix (= file)
        self._offsets: List[int] = []  # entry i -> offset into _buf
        self._seqnos: List[int] = []   # entry i -> seqno (bisect key)
        self._next_seq = 1
        self._base_seq = 0  # all entries <= base_seq have been digested
        self._sealed: Optional[SealedRegion] = None
        self.index = {}  # combined view: sealed + active entries
        self.bytes = 0   # ACTIVE-region bytes (digest-threshold metric)
        # file-handle lock: the digest worker rotates the backing file
        # (reap_files) while the writer keeps appending
        self._file_lock = threading.RLock()
        self._read_base()
        self._recover_from_file()
        if start_seqno >= self._next_seq:
            # failover continuation: a successor process must mint
            # seqnos past the dead predecessor's chain-acked watermark
            # (the replica slots dedup by seqno and would silently drop
            # a restarted stream). Persisted as the base so a later
            # *local* recovery of this log keeps the continuation too.
            self._next_seq = start_seqno + 1
            if not self._entries and start_seqno > self._base_seq:
                self._base_seq = start_seqno
                with self._file_lock:
                    self._write_base()

    # -- append path --------------------------------------------------------
    def append(self, op: int, path: str, data: bytes = b"",
               offset: int = 0) -> Entry:
        e = Entry(self._next_seq, op, path, data, offset)
        self._next_seq += 1
        enc = e.encode()
        with self._file_lock:
            self._f.write(enc)
            self._entries.append(e)
            self._offsets.append(len(self._buf))
            self._seqnos.append(e.seqno)
            self._buf += enc
        self.bytes += e.nbytes
        self._apply_to_index(e)
        return e

    def persist(self) -> None:
        """Flush to the persistence domain (CLWB+SFENCE analogue)."""
        with self._file_lock:
            self._f.flush()
            if self.fsync_data:
                os.fsync(self._f.fileno())

    def flush_to_os(self) -> None:
        """Flush buffered appends to the OS *without* forcing them to
        the persistence domain — the group-commit path skips the
        per-log fsync because the node's commit journal makes the whole
        batch durable with one fsync (see groupcommit.py)."""
        with self._file_lock:
            self._f.flush()

    def _apply_to_index(self, e: Entry) -> None:
        if e.op == OP_PUT:
            self.index[e.path] = e.data
        elif e.op == OP_DELETE:
            self.index[e.path] = None  # tombstone: authoritative miss
        elif e.op == OP_WRITE:
            apply_range_write(self.index, e.path, e.offset, e.data)
        elif e.op == OP_RENAME:
            dst = e.data.decode()
            val = self.index.get(e.path)
            self.index[e.path] = None  # tombstone first: self-rename safe
            if val is not None:
                self.index[dst] = val

    # -- seal (digest pipeline) ---------------------------------------------
    @property
    def sealed(self) -> Optional[SealedRegion]:
        return self._sealed

    def seal(self) -> Optional[SealedRegion]:
        """Snapshot the active region for a background digest and start a
        fresh one. At most one sealed region may exist (the pipeline's
        backpressure point): the caller must reap — ``truncate_through``
        past the sealed tail — before sealing again. The combined
        ``index`` is untouched, so reads keep seeing sealed entries until
        the reap (by which time they are digested into SharedFS)."""
        if self._sealed is not None:
            raise RuntimeError("seal already in flight: reap it first")
        if not self._entries:
            return None
        region = SealedRegion(self._entries, bytes(self._buf),
                              self._offsets, self._seqnos, self.bytes)
        self._entries, self._buf = [], bytearray()
        self._offsets, self._seqnos = [], []
        self.bytes = 0
        self._sealed = region
        return region

    # -- read/replication helpers -------------------------------------------
    @property
    def last_seqno(self) -> int:
        if self._entries:
            return self._entries[-1].seqno
        if self._sealed is not None:
            return self._sealed.last_seqno
        return self._base_seq

    def _idx_after(self, seqno: int) -> int:
        """Index of the first ACTIVE entry with seqno > the given seqno."""
        return bisect.bisect_right(self._seqnos, seqno)

    def entries_since(self, seqno: int) -> List[Entry]:
        active = self._entries[self._idx_after(seqno):]
        if self._sealed is None:
            return active
        return self._sealed.entries_since(seqno) + active

    def encoded_since(self, seqno: int) -> bytes:
        """The pre-encoded byte range for all entries past ``seqno`` —
        one buffer slice (two when spanning the seal boundary), zero
        re-encoding (the replication fast path)."""
        i = self._idx_after(seqno)
        active = bytes(self._buf[self._offsets[i]:]) \
            if i < len(self._entries) else b""
        if self._sealed is None:
            return active
        return self._sealed.encoded_since(seqno) + active

    @staticmethod
    def coalesce(entries: Iterable[Entry]) -> List[Entry]:
        """Drop superseded PUTs and merge byte ranges (optimistic-mode
        bandwidth elimination).

        Range rules: an OP_WRITE folds into a pending PUT of the same
        path (the PUT's bytes are patched; one entry ships); overlapping
        or adjacent OP_WRITEs merge into a single range entry; a PUT or
        DELETE kills every pending range for the path. Disjoint ranges
        are kept as-is — merging them would fabricate the gap bytes.
        """
        entries = list(entries)
        kept: List[Optional[Entry]] = list(entries)
        last_put: Dict[str, int] = {}     # path -> idx of pending PUT
        ranges: Dict[str, List[int]] = {}  # path -> idxs of pending WRITEs
        for i, e in enumerate(entries):
            if e.op == OP_PUT:
                j = last_put.get(e.path)
                if j is not None:
                    kept[j] = None
                for j in ranges.pop(e.path, []):
                    kept[j] = None
                last_put[e.path] = i
            elif e.op == OP_WRITE:
                j = last_put.get(e.path)
                if j is not None:
                    # fold the range into the pending PUT (single entry)
                    kept[i] = Entry(e.seqno, OP_PUT, e.path,
                                    splice(kept[j].data, e.offset, e.data))
                    kept[j] = None
                    last_put[e.path] = i
                    continue
                cur = e
                pend = ranges.setdefault(e.path, [])
                merged = True
                while merged:  # each merge widens cur; rescan until stable
                    merged = False
                    for j in list(pend):
                        w = kept[j]
                        ws, we = w.offset, w.offset + len(w.data)
                        cs, ce = cur.offset, cur.offset + len(cur.data)
                        if we < cs or ws > ce:
                            continue  # disjoint, not even adjacent
                        s = min(ws, cs)
                        buf = bytearray(max(we, ce) - s)
                        buf[ws - s:we - s] = w.data   # earlier: under
                        buf[cs - s:ce - s] = cur.data  # later wins
                        cur = Entry(cur.seqno, OP_WRITE, e.path,
                                    bytes(buf), s)
                        kept[j] = None
                        pend.remove(j)
                        merged = True
                kept[i] = cur
                pend.append(i)
            elif e.op == OP_DELETE:
                # PUT/WRITE then DELETE: the updates are dead weight; the
                # DELETE stays (lower tiers may still hold an older value).
                j = last_put.pop(e.path, None)
                if j is not None:
                    kept[j] = None
                for j in ranges.pop(e.path, []):
                    kept[j] = None
            elif e.op == OP_RENAME:
                # rename pins prior updates of src (they move), clears dst
                for p in (e.path, e.data.decode()):
                    last_put.pop(p, None)
                    ranges.pop(p, None)
        return [e for e in kept if e is not None]

    # -- digest / truncate ----------------------------------------------------
    def _read_base(self) -> None:
        try:
            with open(self.path + ".base") as f:
                self._base_seq = int(f.read().strip() or 0)
                self._next_seq = self._base_seq + 1
        except (FileNotFoundError, ValueError):
            pass

    def _write_base(self) -> None:
        with open(self.path + ".base", "w") as f:
            f.write(str(self._base_seq))

    def truncate_through(self, seqno: int) -> None:
        """Drop entries <= seqno (after digest) by rotating the suffix
        into a fresh segment file: one pre-encoded slice write + an
        atomic ``os.replace`` — no per-entry re-encode, and a crash
        leaves either the old or the new file, never a half-rewrite.
        The digested-through seqno is persisted so seqnos stay monotonic
        across process incarnations (chain slots rely on this).

        Doubles as the pipeline's reap: a sealed region whose tail is
        <= seqno is dropped wholesale; a partial cut folds the sealed
        remainder back into the active region first. Only index entries
        for paths the dropped entries touched are rebuilt (restricted
        replay of the survivors), not the whole hashtable."""
        dropped: List[Entry] = []
        s = self._sealed
        if s is not None:
            self._sealed = None
            j = s._idx_after(seqno)
            dropped.extend(s.entries[:j])
            if j < len(s.entries):
                # partial cut inside the sealed region: the remainder
                # rejoins the head of the active region
                cut = s.offsets[j]
                rem = s.buf[cut:]
                self._offsets = [o - cut for o in s.offsets[j:]] + \
                    [o + len(rem) for o in self._offsets]
                self._entries = s.entries[j:] + self._entries
                self._seqnos = s.seqnos[j:] + self._seqnos
                self._buf = bytearray(rem) + self._buf
        i = self._idx_after(seqno)
        cut = self._offsets[i] if i < len(self._entries) else len(self._buf)
        dropped.extend(self._entries[:i])
        self._entries = self._entries[i:]
        self._offsets = [o - cut for o in self._offsets[i:]]
        self._seqnos = self._seqnos[i:]
        self._buf = self._buf[cut:]
        self._base_seq = max(self._base_seq, seqno)
        with self._file_lock:
            self._write_base()
            self._f.flush()
            self._f.close()
            nxt = self.path + ".next"
            with open(nxt, "wb") as f:
                f.write(self._buf)
            os.replace(nxt, self.path)  # segment rotation
            self._f = open(self.path, "ab+", buffering=_WRITE_BUF)
        self.bytes = sum(e.nbytes for e in self._entries)
        affected = affected_paths(dropped)
        if renames_touch(self._entries, affected):
            # a surviving rename moves state across a dropped path:
            # restricted replay can't order that — full rebuild (rare)
            self.index = {}
            for e in self._entries:
                self._apply_to_index(e)
            return
        for p in affected:
            self.index.pop(p, None)
        for e in self._entries:
            if e.path in affected:
                self._apply_to_index(e)

    # -- pipeline reap (split between worker and writer) ----------------------
    def reap_files(self, through_seqno: int) -> None:
        """WORKER-side half of the reap, run right after the sealed
        region is digested: persist the digested-through watermark and
        rotate the backing file down to the active snapshot — the file
        IO leaves the put path entirely. The writer's half
        (``drop_sealed``) is pure in-memory bookkeeping."""
        with self._file_lock:
            self._base_seq = max(self._base_seq, through_seqno)
            self._write_base()
            snap = bytes(self._buf)  # active region at this instant
        nxt = self.path + ".next"
        with open(nxt, "wb") as f:
            f.write(snap)  # the bulk write: no lock held, appends flow
        with self._file_lock:
            delta = bytes(self._buf[len(snap):])  # appended meanwhile
            if delta:
                with open(nxt, "ab") as f:
                    f.write(delta)
            self._f.flush()
            self._f.close()
            os.replace(nxt, self.path)
            self._f = open(self.path, "ab+", buffering=_WRITE_BUF)

    def drop_sealed(self) -> None:
        """WRITER-side half of the reap: drop the digested sealed region
        from the in-memory view and fix up only the index entries its
        paths touched. No file IO (see ``reap_files``)."""
        s = self._sealed
        if s is None:
            return
        self._sealed = None
        affected = affected_paths(s.entries)
        if renames_touch(self._entries, affected):
            self.index = {}
            for e in self._entries:
                self._apply_to_index(e)
            return
        for p in affected:
            self.index.pop(p, None)
        for e in self._entries:
            if e.path in affected:
                self._apply_to_index(e)

    @property
    def full_beyond(self) -> bool:
        return self.bytes >= self.capacity

    # -- crash recovery --------------------------------------------------------
    def _recover_from_file(self) -> None:
        self._f.seek(0)
        buf = self._f.read()
        decoded = decode_stream(buf)
        valid = sum(e.nbytes for e in decoded)
        # a crash between the worker's .base write and its file rotation
        # can leave already-digested entries (seqno <= base) at the head
        # of the file: skip them — they live in the areas/replicas now
        skip = 0
        while skip < len(decoded) and decoded[skip].seqno <= self._base_seq:
            skip += 1
        cut = sum(e.nbytes for e in decoded[:skip])
        self._entries = decoded[skip:]
        self.bytes = sum(e.nbytes for e in self._entries)
        off = cut
        for e in self._entries:
            self._apply_to_index(e)
            self._offsets.append(off - cut)
            self._seqnos.append(e.seqno)
            off += e.nbytes
        self._buf = bytearray(buf[cut:valid])
        if self._entries:
            self._next_seq = max(self._next_seq,
                                 self._entries[-1].seqno + 1)
        # truncate any torn tail so future appends are clean
        if valid < len(buf):
            self._f.close()
            with open(self.path, "rb+") as f:
                f.truncate(valid)
            self._f = open(self.path, "ab+", buffering=_WRITE_BUF)

    def replay(self, apply_fn: Callable[[Entry], None],
               through: Optional[int] = None) -> int:
        n = 0
        for e in self.entries_since(0):
            if through is not None and e.seqno > through:
                break
            apply_fn(e)
            n += 1
        return n

    def close(self):
        self._f.close()

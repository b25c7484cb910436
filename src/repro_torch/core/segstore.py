"""Segment-log storage engine for SharedFS areas (Haystack-style).

The seed `Area` paid an ``open()/write()/close()`` plus a flushed
manifest line for *every* put — per-IO software amplification the paper
spends §3.3 eliminating. This engine removes it:

- values live as **needle** records appended to large segment files
  (rotated at ``segment_bytes``), so a put is one buffered append;
- an in-memory index maps ``path -> (segment_id, offset, length)`` so a
  get is one ``os.pread`` of exactly the value bytes — no per-path
  files, no per-path metadata IO (Haystack, OSDI'10);
- ``patch(path, byte_offset, data)`` appends a **delta needle**
  (op ``N_WRITE`` with the target byte offset) and links it into the
  index as a patch chain over the base needle; a get assembles
  latest-wins, ``get_range`` serves exact ranges with one ``pread``
  when a single needle covers them, and compaction (or a chain growing
  past ``max_patch_chain``) materializes the merged value — a small
  write into a large object never rewrites the object;
- deletes and renames are small metadata needles — the data bytes are
  never rewritten;
- durability is **batched**: callers group ops and call ``commit()``
  once per batch (SharedFS commits per digest), replacing the seed's
  per-op manifest flush;
- crash recovery needs no manifest at all: segments are replayed in id
  order with **prefix semantics** per segment (each needle carries a
  CRC; scanning stops at the first torn/corrupt record and the tail is
  truncated);
- compaction copies live needles into fresh segments once the dead-byte
  ratio from overwrites/deletes crosses a threshold, then unlinks the
  old segments. Old segments are removed only after the new ones are
  flushed, and replay order (ascending segment id) makes a crash
  mid-compaction harmless.

Needle wire format: see DESIGN.md §3.

``FileArea`` below preserves the seed's file-per-path engine verbatim —
it is the baseline `bench_segstore` measures the new engine against.
"""
from __future__ import annotations

import hashlib
import os
import threading
import struct
import time
import zlib
from collections import Counter
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.integrity import (full_sum, poison_sum, prefix_sums,
                                  range_sum)
from repro_torch.core.transport import next_rkey

# a segment accumulating more than this many verified mismatches is
# presumed to sit on failing media and is quarantined wholesale
# (salvage live needles, retire the file) instead of being repaired
# one extent at a time
QUARANTINE_BUDGET = 3

NEEDLE_MAGIC = 0xA551_6E0D
N_PUT = 1
N_DELETE = 2
N_RENAME = 3
N_WRITE = 4  # delta needle: data patched at byte `offset` of the value

# magic, op, path_len, data_len, offset, crc
_NEEDLE = struct.Struct("<IBHIQi")
_NOFF = struct.Struct("<Q")

# userspace append buffer: durability is batched at commit() anyway,
# so needle appends should not pay a syscall each
_WRITE_BUF = 1 << 20

_SEG_FMT = "seg-%08d.log"

# One flat "physical address space" over all segment files, so a remote
# peer can one-sided-read any located extent with a single integer
# address: addr = segment_id << _SEG_SHIFT | byte_offset. 2^40 bytes per
# segment is far above any configured segment_bytes.
_SEG_SHIFT = 40
_SEG_MASK = (1 << _SEG_SHIFT) - 1


def phys_addr(seg_id: int, off: int) -> int:
    return (seg_id << _SEG_SHIFT) | off


class _PatchChain:
    """Index entry for a patched value: a base needle location (or None
    for a zero-filled base) plus delta-needle locations in write order
    (latest wins on overlap)."""

    __slots__ = ("base", "patches", "length")

    def __init__(self, base, length: int):
        self.base = base  # (segment_id, value_offset, value_length) | None
        self.patches = []  # (byte_offset, segment_id, value_offset, length)
        self.length = length  # assembled value length


class SegmentStore:
    """A persistent path->bytes area backed by append-only segment files
    with an in-memory ``path -> (segment_id, offset, length)`` index.

    API-compatible with the seed ``Area`` (put/get/delete/rename/
    contains/paths/lru_victims, ``bytes``/``capacity``) plus ``commit()``
    for batched durability and ``compact()`` for space reclamation.
    """

    def __init__(self, root: str, capacity: int = 1 << 40, *,
                 segment_bytes: int = 8 << 20, fsync_data: bool = False,
                 compact_min_dead: int = 1 << 20,
                 compact_dead_ratio: float = 0.5,
                 max_patch_chain: int = 64):
        self.root = root
        self.capacity = capacity
        self.segment_bytes = segment_bytes
        self.fsync_data = fsync_data
        self.compact_min_dead = compact_min_dead
        self.compact_dead_ratio = compact_dead_ratio
        self.max_patch_chain = max_patch_chain
        os.makedirs(root, exist_ok=True)
        # path -> (segment_id, value_offset, value_length)
        self.index: Dict[str, Tuple[int, int, int]] = {}
        self.sizes: Dict[str, int] = {}
        self.lru: Dict[str, float] = {}
        self.bytes = 0        # live value bytes (tier accounting)
        self.disk_bytes = 0   # total appended needle bytes on disk
        self.dead_bytes = 0   # needle bytes superseded by overwrite/delete
        self.compactions = 0
        # one-sided region key: located extents stay byte-stable until
        # compaction reuses segment files, which bumps the key and
        # invalidates every outstanding handle (StaleHandle on read)
        self.rkey = next_rkey()
        # (segment_id, value_offset) -> checksum metadata: an int (the
        # full-value sum, computed from the bytes in hand at append/
        # replay — one cheap call on the write path) until the first
        # verified-read locate expands it into the chunk prefix-sum
        # list (integrity.prefix_sums), validated against the stored
        # full sum so rotten disk bytes never launder into the table
        # (see _chunk_sums). Keyed physically: renames keep their CRCs.
        self._crcs: Dict[Tuple[int, int], object] = {}
        self.mismatches: Counter = Counter()  # segment_id -> verified rot
        self.quarantine_budget = QUARANTINE_BUDGET
        self.quarantined_segments = 0
        self.repairs = 0
        self._read_fds: Dict[int, int] = {}  # segment_id -> O_RDONLY fd
        self._active_id = 0
        self._active = None
        self._active_off = 0
        self._dirty = False
        # guards segment files / fd cache / index mutation: the SharedFS
        # background digest worker appends and compacts concurrently
        # with reader threads (LibFS tier walks)
        self._lock = threading.RLock()
        self._recover()
        self._open_active()

    # -- segment files ------------------------------------------------------
    def _seg_path(self, seg_id: int) -> str:
        return os.path.join(self.root, _SEG_FMT % seg_id)

    def _seg_ids(self) -> List[int]:
        out = []
        for fn in os.listdir(self.root):
            if fn.startswith("seg-") and fn.endswith(".log"):
                try:
                    out.append(int(fn[4:-4]))
                except ValueError:
                    pass
        return sorted(out)

    def _open_active(self) -> None:
        ids = self._seg_ids()
        self._active_id = ids[-1] if ids else 1
        if ids and os.path.getsize(self._seg_path(self._active_id)) \
                >= self.segment_bytes:
            self._active_id += 1
        self._active = open(self._seg_path(self._active_id), "ab",
                            buffering=_WRITE_BUF)
        self._active_off = self._active.tell()

    def _rotate(self) -> None:
        self._active.flush()
        self._active.close()
        self._active_id += 1
        self._active = open(self._seg_path(self._active_id), "ab",
                            buffering=_WRITE_BUF)
        self._active_off = 0

    def _append(self, op: int, path: str, data: bytes,
                offset: int = 0) -> Tuple[int, int]:
        """Append one needle; returns (segment_id, value_offset)."""
        if self._active_off >= self.segment_bytes:
            self._rotate()
        p = path.encode()
        crc = zlib.crc32(_NOFF.pack(offset) + p + data) & 0x7FFFFFFF
        rec = _NEEDLE.pack(NEEDLE_MAGIC, op, len(p), len(data), offset,
                           crc) + p + data
        voff = self._active_off + _NEEDLE.size + len(p)
        self._active.write(rec)
        self._active_off += len(rec)
        self.disk_bytes += len(rec)
        self._dirty = True
        if op in (N_PUT, N_WRITE):
            self._crcs[(self._active_id, voff)] = full_sum(data)
        return self._active_id, voff

    # -- recovery -----------------------------------------------------------
    def _recover(self) -> None:
        for seg_id in self._seg_ids():
            sp = self._seg_path(seg_id)
            with open(sp, "rb") as f:
                buf = f.read()
            valid = self._replay_segment(seg_id, buf)
            if valid < len(buf):  # torn/corrupt tail: prefix semantics
                with open(sp, "rb+") as f:
                    f.truncate(valid)

    def _replay_segment(self, seg_id: int, buf: bytes) -> int:
        """Apply a segment's needles to the index; returns the byte
        length of the maximal verifiable prefix."""
        off, n = 0, len(buf)
        while off + _NEEDLE.size <= n:
            magic, op, plen, dlen, noff, crc = _NEEDLE.unpack_from(buf, off)
            if magic != NEEDLE_MAGIC:
                break
            end = off + _NEEDLE.size + plen + dlen
            if end > n:
                break  # torn write
            p = buf[off + _NEEDLE.size: off + _NEEDLE.size + plen]
            d = buf[off + _NEEDLE.size + plen: end]
            if (zlib.crc32(_NOFF.pack(noff) + p + d) & 0x7FFFFFFF) != crc:
                break  # corruption: cut the history here
            path = p.decode()
            if op in (N_PUT, N_WRITE):
                # rebuild the full-value sum from the needle-CRC-
                # verified bytes (chunk table expands lazily on locate)
                self._crcs[(seg_id, off + _NEEDLE.size + plen)] = \
                    full_sum(d)
            if op == N_PUT:
                self._index_put(path, seg_id,
                                off + _NEEDLE.size + plen, dlen)
            elif op == N_DELETE:
                self._index_drop(path)
            elif op == N_RENAME:
                self._index_rename(path, d.decode())
            elif op == N_WRITE:
                self._index_patch(path, seg_id,
                                  off + _NEEDLE.size + plen, dlen, noff)
            self.disk_bytes += end - off
            off = end
        return off

    # -- index maintenance (shared by live ops and replay) -------------------
    def _needle_overhead(self, path: str) -> int:
        return _NEEDLE.size + len(path.encode())

    def _loc_disk_bytes(self, path: str, loc) -> int:
        """On-disk needle bytes referenced by an index entry."""
        ovh = self._needle_overhead(path)
        if isinstance(loc, _PatchChain):
            n = (loc.base[2] + ovh) if loc.base is not None else 0
            return n + sum(p[3] + ovh for p in loc.patches)
        return loc[2] + ovh

    def _index_put(self, path: str, seg_id: int, voff: int,
                   vlen: int) -> None:
        old = self.index.get(path)
        if old is not None:
            self.dead_bytes += self._loc_disk_bytes(path, old)
            self.bytes -= self.sizes.get(path, 0)
        self.index[path] = (seg_id, voff, vlen)
        self.sizes[path] = vlen
        self.bytes += vlen
        self.lru.setdefault(path, 0.0)

    def _index_patch(self, path: str, seg_id: int, voff: int,
                     vlen: int, byte_off: int) -> None:
        """Link a delta needle into the path's patch chain."""
        cur = self.index.get(path)
        if isinstance(cur, _PatchChain):
            ch = cur
        elif cur is None:  # no base anywhere in this area: zeros base
            ch = _PatchChain(None, 0)
            self.index[path] = ch
            self.lru.setdefault(path, 0.0)
        else:
            ch = _PatchChain(cur, cur[2])
            self.index[path] = ch
        old_len = ch.length
        # no dead-byte charge per patch: the whole chain's needle bytes
        # are charged once when it is dropped or materialized (via
        # _loc_disk_bytes) — charging overlapped spans here too would
        # double-count and trigger compaction earlier than configured
        ch.patches.append((byte_off, seg_id, voff, vlen))
        ch.length = max(old_len, byte_off + vlen)
        self.bytes += ch.length - old_len
        self.sizes[path] = ch.length

    def _index_drop(self, path: str) -> None:
        old = self.index.pop(path, None)
        if old is not None:
            self.dead_bytes += self._loc_disk_bytes(path, old)
            self.bytes -= self.sizes.pop(path, 0)
            self.lru.pop(path, None)

    def _index_rename(self, src: str, dst: str) -> None:
        loc = self.index.pop(src, None)
        if loc is None:
            return
        if dst in self.index:
            self._index_drop(dst)
        self.index[dst] = loc
        sz = self.sizes.pop(src, None)
        if sz is None:
            sz = loc.length if isinstance(loc, _PatchChain) else loc[2]
        self.sizes[dst] = sz
        self.lru[dst] = self.lru.pop(src, 0.0)

    # -- data path ------------------------------------------------------------
    def put(self, path: str, data: bytes) -> None:
        with self._lock:
            seg_id, voff = self._append(N_PUT, path, data)
            self._index_put(path, seg_id, voff, len(data))
            self.lru[path] = time.monotonic()
            self._maybe_compact()

    def patch(self, path: str, offset: int, data: bytes) -> None:
        """Byte-range write: one delta-needle append, never a rewrite of
        the base value. Chains longer than ``max_patch_chain`` are
        materialized into a single fresh needle to bound read fan-in."""
        with self._lock:
            seg_id, voff = self._append(N_WRITE, path, data, offset)
            self._index_patch(path, seg_id, voff, len(data), offset)
            self.lru[path] = time.monotonic()
            ch = self.index.get(path)
            if isinstance(ch, _PatchChain) \
                    and len(ch.patches) > self.max_patch_chain:
                merged = self._assemble(ch)
                self.put(path, merged)  # old chain becomes dead bytes
                return
            self._maybe_compact()

    def get(self, path: str) -> Optional[bytes]:
        with self._lock:
            loc = self.index.get(path)
            if loc is None:
                return None
            self.lru[path] = time.monotonic()
            if isinstance(loc, _PatchChain):
                return self._assemble(loc)
            return self._read_loc(loc)

    def get_range(self, path: str, offset: int,
                  length: int) -> Optional[bytes]:
        """Exact-range read: one ``os.pread`` of just the requested
        bytes when a single needle covers the range (clamped at EOF)."""
        with self._lock:
            loc = self.index.get(path)
            if loc is None:
                return None
            self.lru[path] = time.monotonic()
            if not isinstance(loc, _PatchChain):
                seg_id, voff, vlen = loc
                if offset >= vlen:
                    return b""
                return self._read_at(seg_id, voff + offset,
                                     min(length, vlen - offset))
            overlapped = False
            for boff, seg_id, voff, vlen in reversed(loc.patches):
                if boff <= offset and offset + length <= boff + vlen:
                    # latest patch fully covering the range: direct
                    return self._read_at(seg_id, voff + (offset - boff),
                                         length)
                if boff < offset + length and offset < boff + vlen:
                    overlapped = True  # a newer patch partially overlaps
                    break
            if not overlapped:
                base = loc.base
                if base is not None and offset + length <= base[2]:
                    # range lies wholly in the base needle: one pread
                    return self._read_at(base[0], base[1] + offset, length)
                if base is None or offset >= base[2]:
                    # hole between/past patches: zeros, clamped to length
                    end = min(offset + length, loc.length)
                    return b"\x00" * max(0, end - offset)
            full = self._assemble(loc)
            return full[offset:offset + length]

    def locate(self, path: str, offset: int = 0,
               length: Optional[int] = None):
        """Resolve a byte range to its physical extent without reading
        it: ``("loc", addr, n, total, rkey, vsum)`` when a single needle
        covers the (clamped) range contiguously — the caller can then
        serve it with a one-sided region read of exactly ``n`` bytes at
        ``addr``, or a verified read of the chunk-aligned expansion
        described by ``vsum = (head, ext, c0, c1)`` (integrity.range_sum;
        None when no chunk CRCs cover the needle) —
        ``("frag", total)`` when the path exists but the
        range needs patch-chain assembly (or is a zero hole with no
        disk bytes), and ``None`` when the path is absent.
        ``length=None`` means through end-of-value. The rkey is
        captured under the store lock, so the (addr, rkey) pair is
        internally consistent even when a compaction lands right after
        locate returns — the stale pair then fails the transport's
        rkey check instead of reading rewritten segments."""
        with self._lock:
            loc = self.index.get(path)
            if loc is None:
                return None
            self.lru[path] = time.monotonic()
            if isinstance(loc, _PatchChain):
                total = loc.length
                if offset >= total:
                    return ("loc", 0, 0, total, self.rkey, None)
                n = total - offset if length is None \
                    else min(length, total - offset)
                for boff, seg_id, voff, vlen in reversed(loc.patches):
                    if boff <= offset and offset + n <= boff + vlen:
                        return ("loc",
                                phys_addr(seg_id, voff + offset - boff),
                                n, total, self.rkey,
                                self._range_vsum(seg_id, voff, vlen,
                                                 offset - boff, n))
                    if boff < offset + n and offset < boff + vlen:
                        return ("frag", total)
                base = loc.base
                if base is not None and offset + n <= base[2]:
                    return ("loc", phys_addr(base[0], base[1] + offset),
                            n, total, self.rkey,
                            self._range_vsum(base[0], base[1], base[2],
                                             offset, n))
                return ("frag", total)
            seg_id, voff, vlen = loc
            if offset >= vlen:
                return ("loc", 0, 0, vlen, self.rkey, None)
            n = vlen - offset if length is None \
                else min(length, vlen - offset)
            return ("loc", phys_addr(seg_id, voff + offset), n, vlen,
                    self.rkey,
                    self._range_vsum(seg_id, voff, vlen, offset, n))

    def read(self, addr: int, size: int) -> bytes:
        """One-sided region read (transport sink interface) at a
        physical address handed out by ``locate``."""
        if size == 0:
            return b""
        with self._lock:
            return self._read_at(addr >> _SEG_SHIFT, addr & _SEG_MASK,
                                 size)

    def _assemble(self, ch: _PatchChain) -> bytes:
        """Latest-wins assembly of a patch chain (zeros-filled base)."""
        buf = bytearray(ch.length)
        if ch.base is not None:
            base = self._read_loc(ch.base)
            buf[:len(base)] = base
        for boff, seg_id, voff, vlen in ch.patches:
            buf[boff:boff + vlen] = self._read_at(seg_id, voff, vlen)
        return bytes(buf)

    def _read_loc(self, loc: Tuple[int, int, int]) -> bytes:
        seg_id, voff, vlen = loc
        return self._read_at(seg_id, voff, vlen)

    def _read_at(self, seg_id: int, off: int, size: int) -> bytes:
        if seg_id == self._active_id and self._dirty:
            self._active.flush()
            self._dirty = False
        fd = self._read_fds.get(seg_id)
        if fd is None:
            fd = os.open(self._seg_path(seg_id), os.O_RDONLY)
            self._read_fds[seg_id] = fd
        return os.pread(fd, size, off)

    def delete(self, path: str) -> None:
        with self._lock:
            if path not in self.index:
                return
            self._append(N_DELETE, path, b"")
            self._index_drop(path)
            self._maybe_compact()

    def rename(self, src: str, dst: str) -> None:
        with self._lock:
            if src not in self.index:
                return
            self._append(N_RENAME, src, dst.encode())
            self._index_rename(src, dst)
            self.lru[dst] = time.monotonic()

    def commit(self) -> None:
        """Flush the batch to the persistence domain (one flush covers
        every append since the previous commit)."""
        with self._lock:
            if self._dirty:
                self._active.flush()
                if self.fsync_data:
                    os.fsync(self._active.fileno())
                self._dirty = False

    # -- integrity: verify / repair / quarantine ------------------------------
    def _chunk_sums(self, seg_id: int, voff: int, vlen: int):
        """Chunk prefix-sum table for one needle, expanded lazily: the
        write path stores only the full-value sum (one checksum call);
        the first verified-read locate expands the table from disk and
        validates the expansion against the write-time sum, so rotten
        at-rest bytes cannot launder into it. Returns the list, None
        (no metadata), or the full-sum int when the expansion failed —
        the needle is corrupt on disk."""
        pc = self._crcs.get((seg_id, voff))
        if not isinstance(pc, int):
            return pc
        expanded = prefix_sums(self._read_at(seg_id, voff, vlen))
        if expanded[-1] != pc:
            return pc  # rot: keep the write-time sum, don't cache lies
        self._crcs[(seg_id, voff)] = expanded
        return expanded

    def _range_vsum(self, seg_id: int, voff: int, vlen: int,
                    start: int, n: int):
        """Verification summary for a locate descriptor; a needle whose
        lazy expansion exposed at-rest rot gets a poison summary, so a
        verifying client detects it and falls back to the verified RPC
        (which read-repairs) instead of trusting the pull."""
        pc = self._chunk_sums(seg_id, voff, vlen)
        if isinstance(pc, int):
            return poison_sum(n)
        return range_sum(pc, vlen, start, n)

    def _loc_units(self, loc) -> List[Tuple[int, int, int]]:
        """The (segment_id, value_offset, value_length) needles an index
        entry references (base + every patch for a chain)."""
        if isinstance(loc, _PatchChain):
            units = [] if loc.base is None else [loc.base]
            units.extend((seg_id, voff, vlen)
                         for _boff, seg_id, voff, vlen in loc.patches)
            return units
        return [loc]

    def _verify_loc(self, loc) -> bool:
        """Disk bytes of every needle the entry references still match
        their write-time sums (one full-value checksum call per
        needle)."""
        for seg_id, voff, vlen in self._loc_units(loc):
            pc = self._crcs.get((seg_id, voff))
            if pc is None:
                continue  # no metadata (shouldn't happen): can't judge
            want = pc if isinstance(pc, int) else pc[-1]
            if full_sum(self._read_at(seg_id, voff, vlen)) != want:
                return False
        return True

    def verify(self, path: str) -> Optional[bool]:
        """Scrub check for one path: False = at-rest rot detected.
        None when the path is absent."""
        with self._lock:
            loc = self.index.get(path)
            if loc is None:
                return None
            return self._verify_loc(loc)

    def disk_crc(self, path: str) -> Optional[int]:
        """CRC32 of the value as currently served from disk (what a
        reader would get) — the unit of cross-replica checksum
        exchange. None when absent."""
        with self._lock:
            loc = self.index.get(path)
            if loc is None:
                return None
            data = self._assemble(loc) if isinstance(loc, _PatchChain) \
                else self._read_loc(loc)
            return zlib.crc32(data)

    def bump_rkey(self) -> None:
        """Fail outstanding one-sided handles closed (StaleHandle)."""
        with self._lock:
            self.rkey = next_rkey()

    def repair(self, path: str, data: bytes,
               refetch: Optional[Callable[[str], Optional[bytes]]] = None
               ) -> None:
        """Rewrite a corrupt extent with verified bytes: append a fresh
        needle, swap the index, and bump the rkey epoch so any handle
        still pointing at the rotten bytes fails closed. Charges the old
        location's segments against the mismatch budget; a segment over
        budget is quarantined (``refetch`` supplies verified replacement
        bytes for other paths salvaged out of it)."""
        with self._lock:
            old = self.index.get(path)
            bad_segs = sorted({u[0] for u in self._loc_units(old)}) \
                if old is not None else []
            seg_id, voff = self._append(N_PUT, path, data)
            self._index_put(path, seg_id, voff, len(data))
            self.commit()
            self.rkey = next_rkey()
            self.repairs += 1
            for s in bad_segs:
                self.mismatches[s] += 1
                if self.mismatches[s] > self.quarantine_budget:
                    self._quarantine(s, refetch)

    def quarantine_segment(self, seg_id: int,
                           refetch: Optional[Callable[
                               [str], Optional[bytes]]] = None) -> None:
        with self._lock:
            self._quarantine(seg_id, refetch)

    def _quarantine(self, seg_id: int, refetch) -> None:
        """Retire one segment file: every live entry referencing it is
        re-verified and re-appended elsewhere (from local bytes when
        clean, from ``refetch`` — a verified replica read — when not);
        unsalvageable entries are dropped from the index (the extent is
        excluded rather than served corrupt). The file is then unlinked
        and the rkey epoch bumped."""
        if seg_id == self._active_id:
            self._rotate()  # never unlink the file we append to
        if not os.path.exists(self._seg_path(seg_id)):
            return
        victims = [
            p for p, loc in self.index.items()
            if any(u[0] == seg_id for u in self._loc_units(loc))]
        for p in victims:
            loc = self.index[p]
            data = None
            if self._verify_loc(loc):
                data = self._assemble(loc) if isinstance(loc, _PatchChain) \
                    else self._read_loc(loc)
            elif refetch is not None:
                try:
                    data = refetch(p)
                except Exception:
                    data = None
            if data is None:
                self._index_drop(p)
            else:
                s2, v2 = self._append(N_PUT, p, data)
                self._index_put(p, s2, v2, len(data))
        self.commit()
        fd = self._read_fds.pop(seg_id, None)
        if fd is not None:
            os.close(fd)
        try:
            size = os.path.getsize(self._seg_path(seg_id))
            os.remove(self._seg_path(seg_id))
            self.disk_bytes = max(0, self.disk_bytes - size)
        except FileNotFoundError:
            pass
        for key in [k for k in self._crcs if k[0] == seg_id]:
            del self._crcs[key]
        self.mismatches.pop(seg_id, None)
        self.quarantined_segments += 1
        self.rkey = next_rkey()

    # -- queries (Area-compatible) ---------------------------------------------
    def contains(self, path: str) -> bool:
        return path in self.index

    def paths(self) -> List[str]:
        return list(self.index)

    def lru_victims(self, need_bytes: int) -> List[str]:
        out, freed = [], 0
        for p in sorted(self.lru, key=self.lru.get):
            out.append(p)
            freed += self.sizes.get(p, 0)
            if self.bytes - freed <= self.capacity - need_bytes:
                break
        return out

    # -- compaction --------------------------------------------------------------
    def _maybe_compact(self) -> None:
        if (self.dead_bytes >= self.compact_min_dead
                and self.dead_bytes > self.compact_dead_ratio
                * max(1, self.disk_bytes)):
            self.compact()

    @staticmethod
    def _loc_key(loc) -> Tuple[int, int]:
        """(segment, offset) sort key; chains sort by their base (or
        first patch) so compaction still reads old segments in order."""
        if isinstance(loc, _PatchChain):
            if loc.base is not None:
                return loc.base[0], loc.base[1]
            return loc.patches[0][1], loc.patches[0][2]
        return loc[0], loc[1]

    def compact(self) -> None:
        """Copy live needles into fresh segments, drop the old ones.
        Patch chains are **materialized**: the merged value is written
        as one plain needle, so reads after compaction are single-pread
        again.

        Crash-safe without a manifest: new segments get strictly higher
        ids and are flushed before the old files are unlinked, and
        replay applies segments in ascending id order — a crash at any
        point recovers either the old or the new (equivalent) state.
        """
        with self._lock:
            self._do_compact()

    def _do_compact(self) -> None:
        # invalidate outstanding one-sided handles up front: segment
        # files are about to be rewritten and unlinked, and a reader
        # that resolved before this point must fail its rkey check
        # rather than read recycled bytes
        self.rkey = next_rkey()
        self.commit()
        old_ids = self._seg_ids()
        self._active.close()
        self._active_id = (old_ids[-1] if old_ids else 0) + 1
        self._active = open(self._seg_path(self._active_id), "ab",
                            buffering=_WRITE_BUF)
        self._active_off = 0
        self.disk_bytes = 0
        # chunk-CRC table and mismatch tallies restart with the fresh
        # segments (_append repopulates per live needle below)
        self._crcs.clear()
        self.mismatches.clear()
        live = sorted(self.index.items(),
                      key=lambda kv: self._loc_key(kv[1]))
        for path, loc in live:  # old-segment order: sequential reads
            data = self._assemble(loc) if isinstance(loc, _PatchChain) \
                else self._read_loc(loc)
            seg_id, voff = self._append(N_PUT, path, data)
            self.index[path] = (seg_id, voff, len(data))
            self.sizes[path] = len(data)
        self._active.flush()
        if self.fsync_data:
            os.fsync(self._active.fileno())
        self._dirty = False
        for seg_id in old_ids:
            fd = self._read_fds.pop(seg_id, None)
            if fd is not None:
                os.close(fd)
            try:
                os.remove(self._seg_path(seg_id))
            except FileNotFoundError:
                pass
        self.dead_bytes = 0
        self.compactions += 1

    def close(self) -> None:
        self.commit()
        self._active.close()
        for fd in self._read_fds.values():
            os.close(fd)
        self._read_fds.clear()


def subtree_shard(path: str, n: int) -> int:
    """Stable shard assignment by top-level path component: every path
    under one subtree (the lease/digest unit) maps to one shard, so a
    shard's lock covers all intra-subtree ordering and cross-shard
    coordination is only ever needed for renames across subtrees."""
    if n <= 1:
        return 0
    top = path.lstrip("/").split("/", 1)[0]
    return zlib.crc32(top.encode()) % n


class ShardedSegmentStore:
    """N independent ``SegmentStore`` shards behind the Area interface,
    partitioned by ``subtree_shard``. Digest workers operating on
    different subtrees append/compact in different segment logs under
    different locks — the parallel-digest storage layout (fig17).

    Each shard lives in its own subdirectory and runs the full engine
    (append, patch chains, compaction, one-sided ``locate``/``read``
    with its own rkey); the facade routes by path and aggregates the
    accounting. Capacity is enforced at the facade level (SharedFS
    eviction uses the aggregate ``bytes``/``lru_victims``), so each
    shard is configured unbounded. A cross-shard rename has no single
    append-log to ride in — it materializes as get+delete+put (rare:
    renames across subtrees cross a lease boundary anyway)."""

    def __init__(self, root: str, capacity: int = 1 << 40, *,
                 n_shards: int = 4, fsync_data: bool = False, **kw):
        self.root = root
        self.capacity = capacity
        self.n_shards = max(1, n_shards)
        self.shards = [
            SegmentStore(os.path.join(root, f"shard-{i}"),
                         fsync_data=fsync_data, **kw)
            for i in range(self.n_shards)]

    def shard_index(self, path: str) -> int:
        return subtree_shard(path, self.n_shards)

    def shard_for(self, path: str) -> SegmentStore:
        return self.shards[self.shard_index(path)]

    # -- routed data path ---------------------------------------------------
    def put(self, path: str, data: bytes) -> None:
        self.shard_for(path).put(path, data)

    def patch(self, path: str, offset: int, data: bytes) -> None:
        self.shard_for(path).patch(path, offset, data)

    def get(self, path: str) -> Optional[bytes]:
        return self.shard_for(path).get(path)

    def get_range(self, path: str, offset: int,
                  length: int) -> Optional[bytes]:
        return self.shard_for(path).get_range(path, offset, length)

    def locate(self, path: str, offset: int = 0,
               length: Optional[int] = None):
        return self.shard_for(path).locate(path, offset, length)

    def delete(self, path: str) -> None:
        self.shard_for(path).delete(path)

    def verify(self, path: str) -> Optional[bool]:
        return self.shard_for(path).verify(path)

    def disk_crc(self, path: str) -> Optional[int]:
        return self.shard_for(path).disk_crc(path)

    def repair(self, path: str, data: bytes, refetch=None) -> None:
        self.shard_for(path).repair(path, data, refetch)

    def rename(self, src: str, dst: str) -> None:
        a, b = self.shard_for(src), self.shard_for(dst)
        if a is b:
            a.rename(src, dst)
            return
        data = a.get(src)
        if data is None:
            return
        a.delete(src)
        b.put(dst, data)

    def commit(self) -> None:
        for sh in self.shards:
            sh.commit()

    # -- queries / accounting ------------------------------------------------
    def contains(self, path: str) -> bool:
        return self.shard_for(path).contains(path)

    def paths(self) -> List[str]:
        out: List[str] = []
        for sh in self.shards:
            out.extend(sh.paths())
        return out

    @property
    def bytes(self) -> int:
        return sum(sh.bytes for sh in self.shards)

    @property
    def disk_bytes(self) -> int:
        return sum(sh.disk_bytes for sh in self.shards)

    @property
    def dead_bytes(self) -> int:
        return sum(sh.dead_bytes for sh in self.shards)

    @property
    def compactions(self) -> int:
        return sum(sh.compactions for sh in self.shards)

    @property
    def repairs(self) -> int:
        return sum(sh.repairs for sh in self.shards)

    @property
    def quarantined_segments(self) -> int:
        return sum(sh.quarantined_segments for sh in self.shards)

    def lru_victims(self, need_bytes: int) -> List[str]:
        """Globally LRU-ordered victims against the aggregate capacity
        (a hot shard must not force eviction while others sit cold)."""
        items = []
        for sh in self.shards:
            for p, t in sh.lru.items():
                items.append((t, p, sh.sizes.get(p, 0)))
        items.sort()
        out, freed = [], 0
        for _t, p, sz in items:
            out.append(p)
            freed += sz
            if self.bytes - freed <= self.capacity - need_bytes:
                break
        return out

    def compact(self) -> None:
        for sh in self.shards:
            if sh.dead_bytes > 0:
                sh.compact()

    def close(self) -> None:
        for sh in self.shards:
            sh.close()


class FileArea:
    """The seed's file-per-path engine (one file per value + a flushed
    manifest line per op). Kept verbatim as the benchmark baseline that
    `bench_segstore` compares the segment engine against."""

    def __init__(self, root: str, capacity: int = 1 << 40):
        self.root = root
        self.capacity = capacity
        os.makedirs(root, exist_ok=True)
        self.manifest_path = os.path.join(root, "MANIFEST")
        self.index: Dict[str, str] = {}
        self.sizes: Dict[str, int] = {}
        self.lru: Dict[str, float] = {}
        self.bytes = 0
        self._mf = None
        self._recover()
        self._mf = open(self.manifest_path, "a")

    def _recover(self) -> None:
        if not os.path.exists(self.manifest_path):
            return
        with open(self.manifest_path) as f:
            for line in f:
                if not line.endswith("\n"):
                    break  # torn manifest tail
                parts = line.rstrip("\n").split("\x00")
                if parts[0] == "put" and len(parts) == 3:
                    self.index[parts[1]] = parts[2]
                elif parts[0] == "del" and len(parts) == 2:
                    self.index.pop(parts[1], None)
        for p, fn in list(self.index.items()):
            fp = os.path.join(self.root, fn)
            if os.path.exists(fp):
                sz = os.path.getsize(fp)
                self.sizes[p] = sz
                self.bytes += sz
                self.lru[p] = 0.0
            else:
                del self.index[p]

    def _log(self, *parts: str) -> None:
        self._mf.write("\x00".join(parts) + "\n")
        self._mf.flush()

    @staticmethod
    def _fname(path: str) -> str:
        return hashlib.sha1(path.encode()).hexdigest()

    def put(self, path: str, data: bytes) -> None:
        fn = self._fname(path)
        with open(os.path.join(self.root, fn), "wb") as f:
            f.write(data)
        if path in self.sizes:
            self.bytes -= self.sizes[path]
        self.index[path] = fn
        self.sizes[path] = len(data)
        self.bytes += len(data)
        self.lru[path] = time.monotonic()
        self._log("put", path, fn)

    def get(self, path: str) -> Optional[bytes]:
        fn = self.index.get(path)
        if fn is None:
            return None
        self.lru[path] = time.monotonic()
        with open(os.path.join(self.root, fn), "rb") as f:
            return f.read()

    def delete(self, path: str) -> None:
        fn = self.index.pop(path, None)
        if fn is not None:
            self.bytes -= self.sizes.pop(path, 0)
            self.lru.pop(path, None)
            try:
                os.remove(os.path.join(self.root, fn))
            except FileNotFoundError:
                pass
            self._log("del", path)

    def rename(self, src: str, dst: str) -> None:
        fn = self.index.pop(src, None)
        if fn is None:
            return
        self.index[dst] = fn
        self.sizes[dst] = self.sizes.pop(src, 0)
        self.lru[dst] = time.monotonic()
        self._log("del", src)
        self._log("put", dst, fn)

    def contains(self, path: str) -> bool:
        return path in self.index

    def paths(self):
        return list(self.index)

    def lru_victims(self, need_bytes: int) -> List[str]:
        out, freed = [], 0
        for p in sorted(self.lru, key=self.lru.get):
            out.append(p)
            freed += self.sizes.get(p, 0)
            if self.bytes - freed <= self.capacity - need_bytes:
                break
        return out

    def commit(self) -> None:  # durability is per-op; nothing batched
        pass

    def close(self) -> None:
        self._mf.close()

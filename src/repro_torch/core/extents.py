"""Byte-range extents: the shared representation for OP_WRITE overlays.

Assise maintains consistency *at IO operation granularity* (paper §3):
a 64-byte write into a 4 MB object logs, replicates, and digests 64
bytes, not 4 MB. Every layer that used to hold whole values can now
hold a partial view instead — the update-log hashtable, a chain
replica's mirror, and the read path all share this module:

- ``splice(base, offset, data)``: patch a range into a full value,
  zero-filling any gap past the old end (POSIX pwrite-past-EOF holes);
- ``ExtentOverlay``: an ordered, non-overlapping set of written ranges
  for one path with **latest-wins** semantics. Overlapping or adjacent
  writes merge into a single contiguous extent, so N sequential appends
  collapse to one extent. ``from_zero`` marks overlays whose base is
  known to be empty (a range write after a tombstone): assembly then
  needs no lower tier at all.
"""
from __future__ import annotations

import bisect
from typing import List, Optional, Tuple


def splice(base: bytes, offset: int, data: bytes) -> bytes:
    """Patch ``data`` into ``base`` at ``offset`` (zero-filled gap)."""
    if not data:
        return bytes(base)
    buf = bytearray(max(len(base), offset + len(data)))
    buf[:len(base)] = base
    buf[offset:offset + len(data)] = data
    return bytes(buf)


def splice_inplace(base, offset: int, data: bytes) -> bytearray:
    """Like ``splice`` but mutating: patches into ``base`` itself when it
    is already a ``bytearray`` (copying only on first patch), so N small
    writes into a large in-memory value cost O(range) each instead of
    O(value). Callers own the returned buffer — hand out ``bytes(buf)``
    copies to the outside."""
    if not isinstance(base, bytearray):
        base = bytearray(base)
    if len(base) < offset + len(data):
        base.extend(b"\x00" * (offset + len(data) - len(base)))
    base[offset:offset + len(data)] = data
    return base


_MISS = object()


def apply_range_write(table: dict, path: str, offset: int,
                      data: bytes) -> None:
    """Shared OP_WRITE application for ``path -> value`` maps (the log
    hashtable and a replica slot's mirror): a known full value is
    patched in place (mutable buffer stays internal — readers must hand
    out ``bytes`` copies), an existing overlay extends, and otherwise a
    fresh overlay starts — ``from_zero`` when the current state is a
    tombstone (``None``), base-below when the path is absent."""
    cur = table.get(path, _MISS)
    if isinstance(cur, (bytes, bytearray)):
        table[path] = splice_inplace(cur, offset, data)
    elif isinstance(cur, ExtentOverlay):
        cur.write(offset, data)
    else:
        ov = ExtentOverlay(from_zero=(cur is None))
        ov.write(offset, data)
        table[path] = ov


class ExtentOverlay:
    """Latest-wins set of written byte ranges for a single path."""

    __slots__ = ("_ext", "from_zero")

    def __init__(self, from_zero: bool = False):
        # sorted, non-overlapping, non-adjacent (offset, data) pairs
        self._ext: List[Tuple[int, bytes]] = []
        self.from_zero = from_zero

    def __repr__(self) -> str:
        spans = [(o, o + len(d)) for o, d in self._ext]
        return f"ExtentOverlay({spans}, from_zero={self.from_zero})"

    def write(self, offset: int, data: bytes) -> None:
        """Apply one range write; merges overlapping/adjacent extents."""
        if not data:
            return
        end = offset + len(data)
        if self._ext:
            # append fast path: a write starting inside/at the tail of
            # the LAST extent grows it in place — N sequential appends
            # cost O(range) each, not an O(total) rebuild per write.
            # (Extents are sorted and non-adjacent, so nothing earlier
            # can overlap a range starting at or past the last start.)
            lo, ld = self._ext[-1]
            if lo <= offset <= lo + len(ld):
                if not isinstance(ld, bytearray):
                    ld = bytearray(ld)
                    self._ext[-1] = (lo, ld)
                if len(ld) < end - lo:
                    ld.extend(b"\x00" * (end - lo - len(ld)))
                ld[offset - lo:end - lo] = data
                return
        keep: List[Tuple[int, bytes]] = []
        merged_s, merged_e = offset, end
        under: List[Tuple[int, bytes]] = []
        for o, d in self._ext:
            oe = o + len(d)
            if oe < offset or o > end:  # disjoint and not adjacent
                keep.append((o, d))
            else:  # overlaps or touches: absorbed (old data sits under)
                merged_s = min(merged_s, o)
                merged_e = max(merged_e, oe)
                under.append((o, d))
        buf = bytearray(merged_e - merged_s)
        for o, d in under:
            buf[o - merged_s:o - merged_s + len(d)] = d
        buf[offset - merged_s:end - merged_s] = data  # latest wins
        bisect.insort(keep, (merged_s, bytes(buf)))
        self._ext = keep

    # -- queries -------------------------------------------------------------
    def extents(self) -> List[Tuple[int, bytes]]:
        return list(self._ext)

    @property
    def end(self) -> int:
        return self._ext[-1][0] + len(self._ext[-1][1]) if self._ext else 0

    @property
    def nbytes(self) -> int:
        return sum(len(d) for _, d in self._ext)

    def read_range(self, offset: int, length: int) -> Optional[bytes]:
        """The range's bytes if the overlay fully covers it, else None
        (a lower-tier base would be needed)."""
        for o, d in self._ext:
            if o <= offset and offset + length <= o + len(d):
                return bytes(d[offset - o:offset - o + length])
        if self.from_zero and offset >= self.end:
            return b""  # read past EOF: empty, like every other tier
        return None

    def patch_range(self, base_window: bytes, offset: int,
                    length: int) -> bytes:
        """Assemble the value's ``[offset, offset+length)`` window given
        the *base's* bytes for that window (already clamped at the
        base's EOF — a short window means the base ends inside it).
        Equivalent to ``apply_to(base)[offset:offset+length]`` without
        ever materializing the full value — the ranged read path's
        partial-overlay assembly."""
        base_total = offset + len(base_window) \
            if len(base_window) < length else offset + length
        end = min(offset + length, max(base_total, self.end))
        if end <= offset:
            return b""
        buf = bytearray(end - offset)
        buf[:len(base_window)] = base_window[:end - offset]
        for o, d in self._ext:
            s = max(o, offset)
            e = min(o + len(d), end)
            if s < e:
                buf[s - offset:e - offset] = d[s - o:e - o]
        return bytes(buf)

    def apply_to(self, base: bytes) -> bytes:
        """Assemble the full value: extents patched over ``base``."""
        buf = bytearray(max(len(base), self.end))
        buf[:len(base)] = base
        for o, d in self._ext:
            buf[o:o + len(d)] = d
        return bytes(buf)

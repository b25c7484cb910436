"""Chunk-granular integrity metadata for self-verifying one-sided reads.

One-sided ranged reads (fig14) pull raw sub-needle byte ranges out of a
remote region with zero server-side work — which also means they bypass
every record-level CRC in ``segstore``/``log``: a flipped bit in a
replica's NVM would reach the application unnoticed. This module is the
checksum layer that closes that hole (DESIGN.md §5.3):

- every needle's value gets **running prefix checksums at fixed chunk
  boundaries**: ``pc[k] = sum(value[:k*CHUNK])`` (and ``pc[-1]`` = the
  full-value checksum), kept in DRAM beside the location index. The
  write path computes only the **full-value sum** (one checksum call —
  the chunked table costs ~5x that in per-chunk call overhead, which
  would tax every append/apply); the chunk table expands **lazily on
  the first verified-read locate**, from the stored bytes, and the
  expansion is validated against the write-time full sum before it is
  cached — rotten at-rest bytes can never launder into the table (a
  failed expansion hands out ``poison_sum`` instead, see below);
- a locate descriptor for the range ``[s, s+n)`` of a value carries a
  compact verification summary ``(head, ext, c0, c1)``: the client
  reads the chunk-aligned expansion ``ext`` bytes starting ``head``
  bytes before ``s`` and checks ``sum(buf, seed=c0) == c1`` — **one**
  checksum call regardless of range size, because a seedable running
  checksum chains: seeding with the prefix sum at the expansion start
  yields the prefix sum at its end iff the bytes in between are intact;
- ``CHUNK`` is small (128B) so the expansion overhead is bounded by
  254 bytes per read and chunk-aligned IO (every benchmark size) pays
  zero extra wire bytes.

The chunk checksum is ``zlib.adler32``, not crc32: both chain through a
seed, but adler32 stays fast in pure software (~2x crc32 on machines
without hardware CRC), and the hot-path budget is one call per verified
one-sided read (fig18's <=1.1x p99 acceptance gate). Detection
strength: a single corrupted byte anywhere in the window always changes
the checksum (mod-65521 byte sums), which covers the bit-rot and
flipped-bit fault model exactly; the segment needle CRC32 remains the
at-rest authority, and cross-replica scrub exchanges hash full values
with crc32 independently.

A failed check raises ``CorruptExtent`` — the client falls back to a
verified RPC read and the serving node runs read-repair (see
``SharedFS.read_verified``).
"""
from __future__ import annotations

import zlib
from typing import List, Optional, Tuple

CHUNK = 128

_EMPTY = zlib.adler32(b"")  # adler32's initial running value (1)


class CorruptExtent(RuntimeError):
    """A read's bytes failed checksum verification (bit rot at rest, or
    a corrupt/torn one-sided payload in flight). Not retriable as-is:
    the caller must re-read through a verified path (RPC) and the owner
    of the bytes must repair them."""


def poison_sum(n: int) -> Tuple[int, int, int, int]:
    """A verification summary that can never verify: handed out by a
    store that already knows the extent is rotten at rest (a lazy
    chunk-table expansion failed its full-sum check), so a verifying
    client fails deterministically, counts the corruption, and falls
    back to the verified RPC — which read-repairs server-side. adler32
    is unsigned, so -1 never matches."""
    return (0, n, 0, -1)


def prefix_sums(data) -> List[int]:
    """Running checksum at every ``CHUNK`` boundary of ``data``:
    ``pc[0] = sum(b"")``, ``pc[k] = sum(data[:min(k*CHUNK, len)])``.
    The last entry is the full-value checksum."""
    crc = _EMPTY
    pc = [crc]
    mv = memoryview(data)
    for i in range(0, len(mv), CHUNK):
        crc = zlib.adler32(mv[i:i + CHUNK], crc)
        pc.append(crc)
    return pc


def value_sum(pc: List[int]) -> int:
    return pc[-1]


def full_sum(data) -> int:
    """Checksum of a whole value, comparable against ``pc[-1]``."""
    return zlib.adler32(data)


def range_sum(pc: Optional[List[int]], vlen: int, start: int,
              n: int) -> Optional[Tuple[int, int, int, int]]:
    """Verification summary for the sub-range ``[start, start+n)`` of a
    value of length ``vlen`` whose prefix sums are ``pc``:
    ``(head, ext, c0, c1)``. The reader must pull ``ext`` bytes starting
    at ``range_start - head`` (the chunk-aligned expansion, clamped at
    the value end) and check ``sum(buf, seed=c0) == c1``; the requested
    bytes are ``buf[head:head+n]``. Returns None when unverifiable
    (no checksums, empty range, or a range that overruns the value)."""
    if pc is None or n <= 0:
        return None
    end = start + n
    if end > vlen or len(pc) < (vlen + CHUNK - 1) // CHUNK + 1:
        return None
    a = (start // CHUNK) * CHUNK
    b = ((end + CHUNK - 1) // CHUNK) * CHUNK
    if b >= vlen:
        b = vlen
        c1 = pc[-1]
    else:
        c1 = pc[b // CHUNK]
    return (start - a, b - a, pc[a // CHUNK], c1)


def verify_range(buf: bytes, vsum: Tuple[int, int, int, int],
                 n: int) -> bytes:
    """Check a pulled chunk-aligned window against its summary and
    slice out the requested ``n`` bytes. A short buffer (torn read) or
    a checksum mismatch raises ``CorruptExtent``."""
    head, ext, c0, c1 = vsum
    if len(buf) != ext:
        raise CorruptExtent(
            f"torn read: got {len(buf)} of {ext} bytes")
    if zlib.adler32(buf, c0) != c1:
        raise CorruptExtent("checksum mismatch")
    return bytes(buf[head:head + n])

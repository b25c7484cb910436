"""Block-delta encoding for checkpoint shards.

The Assise insight applied to training state: a step's checkpoint is an
*operation-granularity update*, not a monolithic blob. Most tensors
change everywhere each step (dense optimizer updates), but embedding
rows, cold MoE experts, and serving KV snapshots are sparse-update — so
we delta-encode at block granularity and log only changed blocks.

kernels/delta_encode.py is the TPU Pallas version of the changed-block
scan (computed on-device before D2H transfer); this module is the host
reference and wire format.

Wire format:  u32 n_blocks | u32 block_size | u64 total_len
              | n_changed * (u32 idx | u32 len | bytes)
"""
from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

_HDR = struct.Struct("<IIQ")
_BLK = struct.Struct("<II")


def changed_blocks(new: bytes, old: Optional[bytes],
                   block: int) -> List[int]:
    if old is None or len(old) != len(new):
        return list(range((len(new) + block - 1) // block))
    nv = np.frombuffer(new, np.uint8)
    ov = np.frombuffer(old, np.uint8)
    n = len(new)
    nb = (n + block - 1) // block
    pad = nb * block - n
    if pad:
        nv = np.pad(nv, (0, pad))
        ov = np.pad(ov, (0, pad))
    diff = (nv.reshape(nb, block) != ov.reshape(nb, block)).any(axis=1)
    return np.nonzero(diff)[0].tolist()


def changed_extents(new: bytes, old: Optional[bytes], block: int,
                    idxs: Optional[List[int]] = None
                    ) -> List[Tuple[int, int]]:
    """Changed-block indices merged into byte ranges: ``(offset, length)``
    runs of consecutive changed blocks, clamped to ``len(new)``. This is
    the bridge from a changed-block bitmap (host scan or the Pallas
    ``delta_mask`` kernel) to ``LibState.write`` range writes."""
    if idxs is None:
        idxs = changed_blocks(new, old, block)
    runs: List[Tuple[int, int]] = []
    start = prev = None
    for i in idxs:
        if prev is not None and i == prev + 1:
            prev = i
            continue
        if start is not None:
            runs.append((start * block,
                         min((prev + 1) * block, len(new)) - start * block))
        start = prev = i
    if start is not None:
        runs.append((start * block,
                     min((prev + 1) * block, len(new)) - start * block))
    return runs


def block_delta_encode(new: bytes, old: Optional[bytes],
                       block: int = 1 << 16) -> Tuple[bytes, int]:
    """Returns (wire_bytes, n_changed_blocks)."""
    idxs = changed_blocks(new, old, block)
    nb = (len(new) + block - 1) // block
    parts = [_HDR.pack(nb, block, len(new))]
    for i in idxs:
        chunk = new[i * block:(i + 1) * block]
        parts.append(_BLK.pack(i, len(chunk)))
        parts.append(chunk)
    return b"".join(parts), len(idxs)


def block_delta_apply(wire: bytes, old: Optional[bytes]) -> bytes:
    nb, block, total = _HDR.unpack_from(wire, 0)
    if old is None or len(old) != total:
        base = bytearray(total)
    else:
        base = bytearray(old)
    off = _HDR.size
    while off < len(wire):
        i, ln = _BLK.unpack_from(wire, off)
        off += _BLK.size
        base[i * block: i * block + ln] = wire[off: off + ln]
        off += ln
    return bytes(base)

"""Changed-block scan on the card: the wrapper of ``csrc/delta_mask.cu``.

Port of ``repro/kernels/delta_encode.py`` (the Pallas ``delta_mask``).
The checkpointer's delta mode needs a changed-block bitmap over each
encoded leaf; the scan is pure memory bandwidth (read 2n bytes, write
n/block flags). ``ops.delta_mask`` dispatches here for CUDA tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build


def check_args(new: torch.Tensor, old: torch.Tensor, block: int,
               bpt: int) -> None:
    """The Pallas kernel's contract: 1-D uint8 arrays of equal shape whose
    length is a multiple of ``block * bpt``."""
    if new.ndim != 1 or new.shape != old.shape:
        raise ValueError(f"delta_mask wants two equal 1-D arrays, got "
                         f"{tuple(new.shape)} and {tuple(old.shape)}")
    if new.dtype != torch.uint8 or old.dtype != torch.uint8:
        raise ValueError(f"delta_mask wants uint8, got {new.dtype}, "
                         f"{old.dtype}")
    if block <= 0 or bpt <= 0 or new.shape[0] % (block * bpt):
        raise ValueError(f"delta_mask: length {new.shape[0]} is not a "
                         f"multiple of block*bpt = {block}*{bpt}")
    if new.device != old.device:
        raise ValueError(f"delta_mask: inputs on {new.device} and "
                         f"{old.device}")


def work(n: int, block: int) -> tuple:
    """(flops, bytes) of the scan of two ``n``-byte arrays in ``block``-byte
    blocks: each input read once and one flag a block written; byte
    compares only, no floating-point operations."""
    return 0, 2 * n + n // block


def delta_mask_cuda(new: torch.Tensor, old: torch.Tensor,
                    block: int) -> torch.Tensor:
    """Launch the kernel on ``new.device``; returns the int8 mask."""
    if block % 16:
        raise ValueError(f"delta_mask on the card reads 16-byte vectors: "
                         f"block {block} is not a multiple of 16")
    if not (new.is_contiguous() and old.is_contiguous()):
        raise ValueError("delta_mask wants contiguous inputs")
    if new.data_ptr() % 16 or old.data_ptr() % 16:
        raise ValueError("delta_mask wants 16-byte aligned inputs")
    n = new.shape[0]
    if n // block >= 2 ** 31:
        raise ValueError(f"delta_mask: {n // block} blocks exceed the grid")
    lib = _build.load("delta_mask")
    lib.delta_mask.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_longlong,
                               ctypes.c_longlong, ctypes.c_void_p]
    lib.delta_mask.restype = ctypes.c_int
    mask = torch.empty(n // block, dtype=torch.int8, device=new.device)
    stream = torch.cuda.current_stream(new.device).cuda_stream
    err = lib.delta_mask(new.data_ptr(), old.data_ptr(), mask.data_ptr(), n,
                         block, stream)
    _build.check(lib, err, "delta_mask launch")
    _build.LAUNCHES["delta_mask"] += 1
    return mask

"""Public kernel entry points, dispatched by the tensor's device.

A CPU tensor goes to the plain PyTorch version in ``ref.py``; a CUDA
tensor goes to the hand-written kernel, which either launches or raises.
There is no fallback from the card to the plain version. ``LAUNCHES``
counts the kernel launches per kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import delta_encode as _delta
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ref
from repro_torch.kernels._build import LAUNCHES

__all__ = ["LAUNCHES", "delta_mask", "delta_pack", "flash_attention"]


def _route(t: torch.Tensor, name: str) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no implementation for device {t.device}")
    return t.device.type


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    scale=None):
    """q: (B, H, S, D), k: (B, Hk, S, D), v: (B, Hk, S, Dv) -> (B, H, S, Dv)
    in ``q.dtype``. H % Hk == 0; query head h reads kv head h // (H/Hk)."""
    _flash.check_args(q, k, v)
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window {window} must be positive")
    if _route(q, "flash_attention") == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       scale=scale)
    return _flash.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                       scale=scale)


def delta_mask(new, old, *, block: int = 2048, bpt: int = 8):
    """new, old: 1-D uint8 tensors of equal length, a multiple of
    ``block * bpt``. Returns the int8 mask of length n_blocks
    (1 = block changed)."""
    _delta.check_args(new, old, block, bpt)
    if _route(new, "delta_mask") == "cpu":
        return ref.delta_mask_ref(new, old, block)
    return _delta.delta_mask_cuda(new, old, block)


def delta_pack(new, mask, block: int):
    """Host-side companion to delta_mask: gather changed blocks.

    Returns (indices (k,), blocks (k, block)) as numpy arrays."""
    if isinstance(new, torch.Tensor):
        new = new.cpu().numpy()
    if isinstance(mask, torch.Tensor):
        mask = mask.cpu().numpy()
    new = np.asarray(new).reshape(-1, block)
    idx = np.nonzero(np.asarray(mask, bool))[0]
    return idx, new[idx]

"""Plain PyTorch versions of the kernels (the correctness yardstick).

Twins of ``repro/kernels/ref.py``: each is the mathematical definition,
written for clarity, not speed. The CPU tests run them, and
``chip_smoke.py`` holds each CUDA kernel against them on the card. On the
main path they run only for tensors that lie on the CPU.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True, window=None,
                        scale=None):
    """q: (B, H, S, D), k: (B, Hk, S, D), v: (B, Hk, S, Dv) with H % Hk == 0
    -> (B, H, S, Dv). Full-matrix f32 softmax, finite ``-1e30`` mask,
    output cast to ``q.dtype``. Query head h reads kv head h // (H/Hk)."""
    b, h, s, d = q.shape
    hk = k.shape[1]
    if h != hk:
        k = k.repeat_interleave(h // hk, dim=1)
        v = v.repeat_interleave(h // hk, dim=1)
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    qi = torch.arange(s, device=q.device)[:, None]
    ki = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= (qi - ki) < window
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)


def delta_mask_ref(new, old, block: int):
    """int8 changed-block bitmap of two equal 1-D arrays (1 = differs)."""
    n = new.shape[0] // block
    return (new.reshape(n, block) != old.reshape(n, block)).any(
        dim=1).to(torch.int8)


def delta_encode_ref(new, old, block: int):
    """Changed-block scan oracle.

    new, old: 1-D tensors, length divisible by ``block``.
    Returns (mask: (n_blocks,) bool -- block differs,
             packed: same shape as new -- changed blocks compacted to the
             front (stable order), zero-padded)."""
    n = new.shape[0] // block
    nb = new.reshape(n, block)
    mask = delta_mask_ref(new, old, block).bool()
    order = torch.argsort((~mask).to(torch.int8), stable=True)
    packed = torch.where(mask[order][:, None], nb[order],
                         torch.zeros_like(nb[order]))
    return mask, packed.reshape(-1)

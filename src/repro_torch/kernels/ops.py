"""Public kernel entry points, dispatched by the tensor's device.

A CPU tensor goes to the plain PyTorch version in ``ref.py``; a CUDA
tensor goes to the hand-written kernel, which either launches or raises.
There is no fallback from the card to the plain version. ``LAUNCHES``
counts the kernel launches per kernel. ``flash_attention`` and
``ssm_scan`` are differentiable: where a gradient is wanted, each backward
runs its plain version (``flash_attention_bwd_ref``, ``ssm_scan_bwd_ref``)
on the CPU and its backward kernel on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import delta_encode as _delta
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ref
from repro_torch.kernels import ssm_scan as _ssm
from repro_torch.kernels._build import LAUNCHES

__all__ = ["LAUNCHES", "delta_mask", "delta_pack", "flash_attention",
           "ssm_scan"]


def _route(t: torch.Tensor, name: str) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no implementation for device {t.device}")
    return t.device.type


def _flash_forward(q, k, v, causal, window, scale):
    if _route(q, "flash_attention") == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       scale=scale)
    return _flash.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                       scale=scale)


class _FlashAttention(torch.autograd.Function):
    """The forward and backward of ``flash_attention``, each dispatched by
    device: the plain versions on the CPU, the kernels on the card."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        lse = None
        if _route(q, "flash_attention") == "cuda" \
                and q.dtype == torch.float32:
            # the f32 kernel keeps each row's log-sum-exp for the backward
            out, lse = _flash.flash_attention_cuda(
                q, k, v, causal=causal, window=window, scale=scale,
                with_lse=True)
        else:
            out = _flash_forward(q, k, v, causal, window, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = dict(causal=causal, window=window, scale=scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if _route(q, "flash_attention") == "cpu":
            grads = ref.flash_attention_bwd_ref(q, k, v, out, dout,
                                                **ctx.args)
        else:
            if dout.stride(-1) != 1:
                dout = dout.contiguous()
            grads = _flash.flash_attention_bwd_cuda(q, k, v, out, dout, lse,
                                                    **ctx.args)
        return (*grads, None, None, None)


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    scale=None):
    """q: (B, H, S, D), k: (B, Hk, S, D), v: (B, Hk, S, Dv) -> (B, H, S, Dv)
    in ``q.dtype``. H % Hk == 0; query head h reads kv head h // (H/Hk).
    Differentiable in q, k and v; without a gradient (serving) it runs the
    forward alone and keeps nothing for a backward."""
    _flash.check_args(q, k, v)
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window {window} must be positive")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, scale)
    return _flash_forward(q, k, v, causal, window, scale)


class _SSMScan(torch.autograd.Function):
    """The forward and backward of ``ssm_scan``, each dispatched by device:
    the plain versions on the CPU, the kernels on the card. On the card the
    forward keeps the state entering every ``CHUNK`` steps, from which the
    backward kernel recomputes the states (never from decay, which may be
    0)."""

    @staticmethod
    def forward(ctx, decay, u, c, state0):
        ctx.set_materialize_grads(False)  # the final state's may be None
        if _route(decay, "ssm_scan") == "cpu":
            y, final = ref.ssm_scan_ref(decay, u, c, state0)
            ctx.save_for_backward(decay, u, c, state0)
        else:
            y, final, bounds = _ssm.ssm_scan_cuda(decay, u, c, state0,
                                                  with_bounds=True)
            ctx.save_for_backward(decay, u, c, bounds)
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        decay, u, c, start = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(decay.shape[:3], dtype=torch.float32,
                             device=decay.device)
        if _route(decay, "ssm_scan") == "cpu":
            return ref.ssm_scan_bwd_ref(decay, u, c, start, dy, dfinal)
        if dfinal is not None:
            dfinal = dfinal.contiguous()
        return _ssm.ssm_scan_bwd_cuda(decay, u, c, start, dy.contiguous(),
                                      dfinal)


def ssm_scan(decay, u, c, state0):
    """decay, u: (B, S, D, N), decay in [0, 1]; c: (B, S, N); state0:
    (B, D, N). Returns (y (B, S, D) f32, final state (B, D, N) f32):
    ``s_t = decay_t*s_{t-1} + u_t``, ``y_t = sum_n s_t[..., n]*c_t[n]``.
    Differentiable in decay, u, c and state0; without a gradient (serving)
    it runs the forward alone and keeps nothing for a backward."""
    _ssm.check_args(decay, u, c, state0)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (decay, u, c, state0)):
        return _SSMScan.apply(decay, u, c, state0)
    if _route(decay, "ssm_scan") == "cpu":
        return ref.ssm_scan_ref(decay, u, c, state0)
    return _ssm.ssm_scan_cuda(decay, u, c, state0)


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

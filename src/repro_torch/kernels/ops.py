"""Public kernel entry points, dispatched by the tensor's device.

A CPU tensor goes to the plain PyTorch version in ``ref.py``; a CUDA
tensor goes to the hand-written kernel, which either launches or raises.
There is no fallback from the card to the plain version. ``LAUNCHES``
counts the kernel launches per kernel. ``flash_attention`` and
``ssm_scan`` are differentiable: where a gradient is wanted, each backward
runs its plain version (``flash_attention_bwd_ref``, ``ssm_scan_bwd_ref``)
on the CPU and its backward kernel on the card.

A ``meta`` tensor (``repro_torch.roofline`` counts a step on the meta
device) runs neither: each op returns empty meta outputs of the card's
shapes, dtypes and layouts, and adds its kernel's analytic ``(flops,
bytes)`` to every recorder that ``record_work`` holds open. The plain
versions would count the wrong work (the plain flash computes every one
of the S x S scores, not the causal or window band), and a meta call is
no launch, so ``LAUNCHES`` does not move.

A DTensor (``launch/sharding.py`` lays a step out over a mesh) runs the op
on each rank's local shard and is wrapped back with the inputs'
placements, differentiably: on meta the recorded work is the local
shard's (what one chip computes), on the card the kernel launches on the
local shard. Only placements that the kernel computes shard by shard are
taken: ``flash_attention`` batch and heads, ``ssm_scan`` batch and D,
``delta_mask`` none. A shard of S, of the head dim or a ``Partial`` sum
raises; nothing is redistributed behind the caller's back.
``decode_attention`` takes plain tensors only: the model's decode
attention lays its DTensors out and calls it on the local shards.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import delta_encode as _delta
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ref
from repro_torch.kernels import ssm_scan as _ssm
from repro_torch.kernels._build import LAUNCHES

__all__ = ["LAUNCHES", "SHARDED", "decode_attention", "delta_mask",
           "delta_pack", "flash_attention", "record_work", "ssm_scan",
           "wrap_local"]

_RECORDERS: list = []  # the lists that record_work holds open
# calls of each op on DTensors (each runs the op once on its local shard)
SHARDED = {"delta_mask": 0, "flash_attention": 0, "ssm_scan": 0}


@contextlib.contextmanager
def record_work():
    """Yields a list to which every kernel op on a ``meta`` tensor appends
    ``(kernel name, flops, bytes)`` while the block runs."""
    rows: list = []
    _RECORDERS.append(rows)
    try:
        yield rows
    finally:
        _RECORDERS.remove(rows)


def _meta_work(name: str, work) -> None:
    for rows in _RECORDERS:
        rows.append((name, *work))


def _route(t: torch.Tensor, name: str) -> str:
    if t.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{name}: no implementation for device {t.device}")
    return t.device.type


def _bshd(shape, dtype) -> torch.Tensor:
    """An empty meta (B, H, S, D) tensor laid out as (B, S, H, D), as the
    flash kernels write their outputs and gradients."""
    b, h, s, d = shape
    return torch.empty((b, s, h, d), dtype=dtype,
                       device="meta").transpose(1, 2)


def _flash_meta(q, k, v, causal, window, backward=False):
    b, h, s, d = q.shape
    hk, dv = k.shape[1], v.shape[-1]
    if backward:
        _meta_work("flash_attention_bwd", _flash.bwd_work(
            b, h, hk, s, d, dv, window, q.element_size(), causal))
        return tuple(_bshd(t.shape, t.dtype) for t in (q, k, v))
    _meta_work("flash_attention", _flash.work(
        b, h, hk, s, d, dv, window, q.element_size(), causal))
    return _bshd((b, h, s, dv), q.dtype)


def _flash_forward(q, k, v, causal, window, scale):
    if q.is_cuda:  # the card's path first: it is the one that runs hot
        return _flash.flash_attention_cuda(q, k, v, causal=causal,
                                           window=window, scale=scale)
    route = _route(q, "flash_attention")
    if route == "meta":
        return _flash_meta(q, k, v, causal, window)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
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
        route = _route(q, "flash_attention")
        if route == "meta":
            return (*_flash_meta(q, k, v, ctx.args["causal"],
                                 ctx.args["window"], backward=True),
                    None, None, None)
        if route == "cpu":
            grads = ref.flash_attention_bwd_ref(q, k, v, out, dout,
                                                **ctx.args)
        else:
            # the kernel reads dout by TMA: a copy where it breaks the rule
            if dout.stride(-1) != 1 \
                    or _flash.layout_error("dout", dout) is not None:
                dout = torch.empty_like(
                    dout, memory_format=torch.contiguous_format).copy_(dout)
            grads = _flash.flash_attention_bwd_cuda(q, k, v, out, dout, lse,
                                                    **ctx.args)
        return (*grads, None, None, None)


def _placements(name: str, tensors, allowed) -> tuple:
    """(mesh, placements) shared by the DTensors among ``tensors``, or
    None if there are none. Every tensor must be a DTensor on one mesh with
    the same placements, each ``Replicate`` or a ``Shard`` of a dim in
    ``allowed``."""
    dts = [t for t in tensors if isinstance(t, DTensor)]
    if not dts:
        return None
    if len(dts) != len(tensors):
        raise TypeError(f"{name}: DTensor and plain tensor inputs mixed")
    mesh, pl = dts[0].device_mesh, dts[0].placements
    for t in dts[1:]:
        if t.device_mesh != mesh or t.placements != pl:
            raise ValueError(f"{name}: inputs laid out differently: "
                             f"{[t.placements for t in dts]}")
    for p in pl:
        if not (isinstance(p, Replicate)
                or (isinstance(p, Shard) and p.dim in allowed)):
            raise ValueError(
                f"{name}: placement {p} of {pl} cannot be computed shard "
                f"by shard (allowed: Replicate, Shard of dims "
                f"{sorted(allowed)}); redistribute first")
    return mesh, pl


def wrap_local(local: torch.Tensor, mesh, placements) -> DTensor:
    """Each rank's ``local`` result as a DTensor (differentiable), its
    global shape from the shards' even split and its global strides laid
    out as the local tensor's (a size-1 dim included), so that the ops
    that follow decide as they would on a plain tensor (``torch.matmul``
    folds a 3-D operand into one product only if its strides say it is
    contiguous)."""
    shape = list(local.shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            shape[p.dim] *= mesh.shape[i]
    order = sorted(range(local.ndim), key=lambda d: (-local.stride(d), d))
    stride, step = [0] * local.ndim, 1
    for d in reversed(order):
        stride[d] = step
        step *= shape[d]
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    scale=None):
    """q: (B, H, S, D), k: (B, Hk, S, D), v: (B, Hk, S, Dv) -> (B, H, S, Dv)
    in ``q.dtype``. H % Hk == 0; query head h reads kv head h // (H/Hk).
    Differentiable in q, k and v; without a gradient (serving) it runs the
    forward alone and keeps nothing for a backward. DTensor inputs share
    their placements, sharded over batch (dim 0) or heads (dim 1) only."""
    laid = _placements("flash_attention", (q, k, v), {0, 1})
    if laid is not None:
        if any(isinstance(p, Shard) and p.dim == 1 for p in laid[1]) \
                and q.shape[1] != k.shape[1]:
            # a rank's query heads would read other ranks' kv heads
            raise ValueError("flash_attention: heads sharded with H != Hk; "
                             "expand k and v to H first")
        SHARDED["flash_attention"] += 1
        return wrap_local(flash_attention(q.to_local(), k.to_local(),
                                          v.to_local(), causal=causal,
                                          window=window, scale=scale),
                          *laid)
    _flash.check_args(q, k, v)
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window {window} must be positive")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, scale)
    return _flash_forward(q, k, v, causal, window, scale)


def decode_attention(q, k_cache, v_cache, *, cur_pos, window=None,
                     scale=None):
    """One decode step's attention: q (B, 1, H, D) against caches
    (B, S, Hk, D) at the positions up to ``cur_pos`` (B,) int64 (and
    within ``window`` of it) -> (B, 1, H, D) in ``q.dtype``. H % Hk == 0;
    query head h reads kv head h // (H/Hk). Not differentiable (serving
    only). On meta the recorded work is the most a step can read, at the
    cache's last position (``cur_pos`` is not read there)."""
    if isinstance(q, DTensor):
        raise TypeError("decode_attention takes plain tensors; call it on "
                        "the local shards")
    if q.is_cuda:  # the card's path first: it is the one that runs hot
        return _decode.decode_attention_cuda(q, k_cache, v_cache,
                                             cur_pos=cur_pos, window=window,
                                             scale=scale)
    _decode.check_args(q, k_cache, v_cache, cur_pos)
    if _route(q, "decode_attention") == "meta":
        b, _, h, d = q.shape
        _meta_work("decode_attention", _decode.work(
            b, h, k_cache.shape[2], k_cache.shape[1], d, window,
            k_cache.element_size(), q.element_size()))
        return torch.empty(q.shape, dtype=q.dtype, device="meta")
    return ref.decode_attention_ref(q, k_cache, v_cache, cur_pos=cur_pos,
                                    window=window, scale=scale)


class _SSMScan(torch.autograd.Function):
    """The forward and backward of ``ssm_scan``, each dispatched by device:
    the plain versions on the CPU, the kernels on the card. On the card the
    forward keeps the state entering every ``CHUNK`` steps, from which the
    backward kernel recomputes the states (never from decay, which may be
    0)."""

    @staticmethod
    def forward(ctx, decay, u, c, state0):
        ctx.set_materialize_grads(False)  # the final state's may be None
        route = _route(decay, "ssm_scan")
        if route != "cuda":
            y, final = (_ssm_meta(decay) if route == "meta"
                        else ref.ssm_scan_ref(decay, u, c, state0))
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
        route = _route(decay, "ssm_scan")
        if route == "meta":  # start is state0 there, as on the CPU
            _meta_work("ssm_scan_bwd", _ssm.bwd_work(*decay.shape))
            return tuple(map(torch.empty_like, (decay, u, c, start)))
        if route == "cpu":
            return ref.ssm_scan_bwd_ref(decay, u, c, start, dy, dfinal)
        if dfinal is not None:
            dfinal = dfinal.contiguous()
        return _ssm.ssm_scan_bwd_cuda(decay, u, c, start, dy.contiguous(),
                                      dfinal)


def _ssm_meta(decay):
    b, s, d, n = decay.shape
    _meta_work("ssm_scan", _ssm.work(b, s, d, n))
    return (torch.empty((b, s, d), device="meta"),
            torch.empty((b, d, n), device="meta"))


def ssm_scan(decay, u, c, state0):
    """decay, u: (B, S, D, N), decay in [0, 1]; c: (B, S, N); state0:
    (B, D, N). Returns (y (B, S, D) f32, final state (B, D, N) f32):
    ``s_t = decay_t*s_{t-1} + u_t``, ``y_t = sum_n s_t[..., n]*c_t[n]``.
    Differentiable in decay, u, c and state0; without a gradient (serving)
    it runs the forward alone and keeps nothing for a backward. DTensor
    inputs are sharded over batch or D only (c and state0 accordingly)."""
    if any(isinstance(t, DTensor) for t in (decay, u, c, state0)):
        return _ssm_scan_dtensor(decay, u, c, state0)
    _ssm.check_args(decay, u, c, state0)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (decay, u, c, state0)):
        return _SSMScan.apply(decay, u, c, state0)
    route = _route(decay, "ssm_scan")
    if route == "meta":
        return _ssm_meta(decay)
    if route == "cpu":
        return ref.ssm_scan_ref(decay, u, c, state0)
    return _ssm.ssm_scan_cuda(decay, u, c, state0)


def _ssm_scan_dtensor(decay, u, c, state0):
    """``ssm_scan`` on each rank's shard: per mesh dim, decay and u are
    Shard(0) (batch) or Shard(2) (D) or Replicate; c follows the batch
    shard alone, state0 both."""
    mesh, pl = _placements("ssm_scan", (decay, u), {0, 2})
    c_pl, s_pl, y_pl = ssm_scan_placements(pl)
    want = {"c": c_pl, "state0": s_pl}
    for name, t in (("c", c), ("state0", state0)):
        if not isinstance(t, DTensor) or t.device_mesh != mesh \
                or t.placements != want[name]:
            raise ValueError(
                f"ssm_scan: {name} laid out as "
                f"{getattr(t, 'placements', 'a plain tensor')}, decay and "
                f"u as {pl}: want {want[name]}")
    SHARDED["ssm_scan"] += 1
    y, final = ssm_scan(decay.to_local(), u.to_local(), c.to_local(),
                        state0.to_local())
    return wrap_local(y, mesh, y_pl), wrap_local(final, mesh, s_pl)


def ssm_scan_placements(pl) -> tuple:
    """(c's, state0's and the final state's, y's) placements for decay and
    u laid out as ``pl`` (each Replicate, Shard(0) or Shard(2))."""
    return (tuple(Shard(0) if p == Shard(0) else Replicate() for p in pl),
            tuple(Shard(0) if p == Shard(0) else Shard(1) if p == Shard(2)
                  else Replicate() for p in pl),
            tuple(p if p in (Shard(0), Shard(2)) else Replicate()
                  for p in pl))


def delta_mask(new, old, *, block: int = 2048, bpt: int = 8):
    """new, old: 1-D uint8 tensors of equal length, a multiple of
    ``block * bpt``. Returns the int8 mask of length n_blocks
    (1 = block changed). A DTensor input must be replicated: a shard's
    blocks would not be the snapshot's."""
    laid = _placements("delta_mask", (new, old), set())
    if laid is not None:
        SHARDED["delta_mask"] += 1
        return wrap_local(delta_mask(new.to_local(), old.to_local(),
                                     block=block, bpt=bpt), *laid)
    _delta.check_args(new, old, block, bpt)
    route = _route(new, "delta_mask")
    if route == "meta":
        _meta_work("delta_mask", _delta.work(new.shape[0], block))
        return torch.empty(new.shape[0] // block, dtype=torch.int8,
                           device="meta")
    if route == "cpu":
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

"""Shared layer primitives: norms, activations, positional encodings, init.

Port of ``repro/models/layers.py``. Weights keep the JAX layout ``x @ W``
with ``W`` of shape ``(d_in, d_out)``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard


def normal_init(gen: torch.Generator, shape, dtype, device,
                std: float = 0.02) -> torch.Tensor:
    """f32 normal samples times ``std``, cast to ``dtype``. Scaled in
    place: making a leaf costs its f32 size once (12.9 GB for one of
    Jamba's (16, 8192, 24576) expert leaves), not twice."""
    t = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=device)
    return t.mul_(std).to(dtype)


# ---------------------------------------------------------------------------
# Reshapes and partial sums of DTensors (a step laid out over a mesh)
# ---------------------------------------------------------------------------


def reshape(x: torch.Tensor, *shape) -> torch.Tensor:
    """``x.reshape(*shape)``. A DTensor first gathers each mesh dim that
    shards a dim the reshape cannot keep sharded, where a DTensor raises
    and XLA regathers: a dim inside a merged or split group other than
    the group's first, or a first whose new size the shards do not divide
    (a head split of a dim that carries fewer heads than the model axis)."""
    if not isinstance(x, DTensor):
        return x.reshape(*shape)
    shape = list(shape)
    if -1 in shape:
        i = shape.index(-1)
        shape[i] = x.numel() // math.prod(n for n in shape if n != -1)
    lead = 0
    while lead < min(x.ndim, len(shape)) and x.shape[lead] == shape[lead]:
        lead += 1
    trail = 0
    while trail < min(x.ndim, len(shape)) - lead \
            and x.shape[-1 - trail] == shape[-1 - trail]:
        trail += 1
    touched = range(lead, x.ndim - trail)
    shards = [x.device_mesh.shape[i] for i, p in enumerate(x.placements)
              if isinstance(p, Shard) and p.dim == lead]
    keep_lead = lead < len(shape) and shape[lead] % math.prod(shards) == 0
    pl = [Replicate() if isinstance(p, Shard) and p.dim in touched
          and not (p.dim == lead and keep_lead) else p
          for p in x.placements]
    if list(x.placements) != pl:
        x = x.redistribute(x.device_mesh, pl)
    return x.reshape(*shape)


def shard_offset(x: DTensor, dim: int) -> int:
    """Where this rank's shard of ``x``'s ``dim`` starts in the global
    dim (the slices nest in mesh order)."""
    coord, offset = x.device_mesh.get_coordinate(), 0
    for i, p in enumerate(x.placements):
        if p == Shard(dim):
            offset = offset * x.device_mesh.shape[i] + coord[i]
    return offset * x.to_local().shape[dim]


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's pending partial sums (the output of a contraction over a
    sharded dim) summed now; anything else unchanged."""
    if isinstance(x, DTensor) and any(isinstance(p, Partial)
                                      for p in x.placements):
        return x.redistribute(x.device_mesh, [
            Replicate() if isinstance(p, Partial) else p
            for p in x.placements])
    return x


# ---------------------------------------------------------------------------
# Norms (computed in f32, cast back)
# ---------------------------------------------------------------------------


def init_norm(kind: str, dim: int, dtype, device, lead=()) -> dict:
    p = {"scale": torch.ones((*lead, dim), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((*lead, dim), dtype=dtype, device=device)
    return p


def apply_norm(kind: str, params: dict, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    elif kind == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
    else:
        raise ValueError(kind)
    y = y * params["scale"].float()
    if "bias" in params:
        y = y + params["bias"].float()
    return y.to(x.dtype)


def rms_normalize(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS normalization without a weight (MLA's latents), in f32, cast
    back to x's dtype."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {
        "silu": F.silu,
        "gelu": _gelu,
        "relu2": lambda x: torch.square(F.relu(x)),
    }[name]


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D) with rotary over D; positions: (..., S). Rotates
    the two halves of D (not interleaved pairs), as the JAX package."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)  # (d/2,)
    angles = positions[..., None].float() * freqs  # (..., S, d/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, d/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos_emb(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """positions: (..., S) -> (..., S, dim) f32, [sin | cos]."""
    half = dim // 2
    freqs = torch.exp(-math.log(10_000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Dense / gated MLP
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, act: str, dtype,
             device, lead=()) -> dict:
    if act in ("swiglu", "geglu"):
        return {
            "w_gate": normal_init(gen, (*lead, d_model, d_ff), dtype, device),
            "w_up": normal_init(gen, (*lead, d_model, d_ff), dtype, device),
            "w_down": normal_init(gen, (*lead, d_ff, d_model), dtype, device),
        }
    return {  # plain (non-gated) MLP
        "w_up": normal_init(gen, (*lead, d_model, d_ff), dtype, device),
        "w_down": normal_init(gen, (*lead, d_ff, d_model), dtype, device),
    }


def apply_mlp(params: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    up = x @ params["w_up"]
    if "w_gate" in params:
        gate = x @ params["w_gate"]
        inner = {"swiglu": F.silu, "geglu": _gelu}[act]
        h = inner(gate.float()).to(x.dtype) * up
    else:
        h = _gelu(up.float()).to(x.dtype)
    return h @ params["w_down"]


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return logits
    lf = logits.float()
    return (torch.tanh(lf / cap) * cap).to(logits.dtype)

"""Shared layer primitives: norms, activations, rotary embeddings, init.

Port of ``repro/models/layers.py``. Weights keep the JAX layout ``x @ W``
with ``W`` of shape ``(d_in, d_out)``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def normal_init(gen: torch.Generator, shape, dtype, device,
                std: float = 0.02) -> torch.Tensor:
    """f32 normal samples times ``std``, cast to ``dtype``. Scaled in
    place: making a leaf costs its f32 size once (12.9 GB for one of
    Jamba's (16, 8192, 24576) expert leaves), not twice."""
    t = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=device)
    return t.mul_(std).to(dtype)


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


# ---------------------------------------------------------------------------
# Dense / gated MLP
# ---------------------------------------------------------------------------


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


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

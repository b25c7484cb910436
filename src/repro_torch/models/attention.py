"""Attention, GQA path: projections, rotary, prefill through the
flash-attention kernel, and single-step decode against the KV cache.

Port of the GQA part of ``repro/models/attention.py``. Prefill attention
calls ``kernels.ops.flash_attention`` (the CUDA kernel on the card, its
plain version on the CPU), where the JAX package computes the same
function in jnp. MLA and the JAX package's ``chunked``/``tri``/``naive``/
``window`` strategies are not ported yet (ROADMAP, Queue 1).

The KV cache is updated in place (prefill writes [0, S), decode writes one
position), where the JAX package returns updated copies: this saves a
copy of every cache leaf per layer and step. The functions still return
the cache so that callers read like the reference.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import AttnSpec
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, normal_init

NEG_INF = -1e30


def init_attn(gen: torch.Generator, d_model: int, spec: AttnSpec, dtype,
              device, lead=()) -> dict:
    if spec.mla is not None:
        raise NotImplementedError(
            "MLA is not ported yet (ROADMAP: Queue 1, remaining mixers)")
    p = {
        "wq": normal_init(gen, (*lead, d_model, spec.q_dim), dtype, device),
        "wk": normal_init(gen, (*lead, d_model, spec.kv_dim), dtype, device),
        "wv": normal_init(gen, (*lead, d_model, spec.kv_dim), dtype, device),
        "wo": normal_init(gen, (*lead, spec.q_dim, d_model), dtype, device),
    }
    if spec.qkv_bias:
        for name, dim in (("bq", spec.q_dim), ("bk", spec.kv_dim),
                          ("bv", spec.kv_dim)):
            p[name] = torch.zeros((*lead, dim), dtype=dtype, device=device)
    return p


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B,S,Hk,D) -> (B,S,H,D) by repeating each kv head over its group
    (``jnp.repeat`` along heads: query head h reads kv head h // (H/Hk))."""
    hk = k.shape[2]
    if hk == n_heads:
        return k
    return k.repeat_interleave(n_heads // hk, dim=2)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              window: Optional[int] = None,
              scale: Optional[float] = None) -> torch.Tensor:
    """Causal self-attention over positions 0..S-1 (train/prefill).
    q: (B,S,H,D), k,v: (B,S,Hk,D[v]). Returns (B,S,H,Dv). The kernel reads
    the kv head of each query head itself, so k and v are not expanded."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=True, window=window,
                              scale=scale)
    return out.transpose(1, 2)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, cur_pos: torch.Tensor,
                     window: Optional[int] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-step decode. q:(B,1,H,D), caches:(B,S,Hk,D), cur_pos:(B,)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    k_cache = _expand_kv(k_cache, q.shape[2])
    v_cache = _expand_kv(v_cache, q.shape[2])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_cache.float()) * scale
    kpos = torch.arange(k_cache.shape[1], device=q.device)
    mask = kpos[None, :] <= cur_pos[:, None]
    if window is not None:
        mask &= (cur_pos[:, None] - kpos[None, :]) < window
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bhqd", p, v_cache.float())
    return out.transpose(1, 2).to(q.dtype)


# ---------------------------------------------------------------------------
# Full GQA layer (projections + rope + attention [+ cache])
# ---------------------------------------------------------------------------


def _project_qkv(params, x, spec: AttnSpec):
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if spec.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    b, s, _ = x.shape
    q = q.reshape(b, s, -1, spec.head_dim)
    k = k.reshape(b, s, -1, spec.head_dim)
    v = v.reshape(b, s, -1, spec.head_dim)
    return q, k, v


def gqa_forward(params: dict, x: torch.Tensor, spec: AttnSpec, *,
                positions: torch.Tensor, cache: Optional[dict] = None):
    """Train/prefill path. positions: (S,) = 0..S-1. Returns
    (out, cache|None); a given cache is filled at [0, S) in place."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, x, spec)
    if spec.rope:
        q = apply_rope(q, positions[None, :], spec.rope_theta)
        k = apply_rope(k, positions[None, :], spec.rope_theta)
    if cache is not None:  # prefill: write into the cache at [0, s)
        cache["k"][:, :s] = k.to(cache["k"].dtype)
        cache["v"][:, :s] = v.to(cache["v"].dtype)
    out = attention(q, k, v, window=spec.window)
    return out.reshape(b, s, -1) @ params["wo"], cache


def gqa_decode(params: dict, x: torch.Tensor, spec: AttnSpec, *, pos: int,
               cache: dict):
    """Decode. x:(B,1,d), pos: step index shared by the batch. Writes the
    new key and value at ``pos`` of the cache in place."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, x, spec)
    posv = torch.full((1, 1), pos, dtype=torch.int64, device=x.device)
    if spec.rope:
        q = apply_rope(q, posv, spec.rope_theta)
        k = apply_rope(k, posv, spec.rope_theta)
    cache["k"][:, pos:pos + 1] = k.to(cache["k"].dtype)
    cache["v"][:, pos:pos + 1] = v.to(cache["v"].dtype)
    cur = torch.full((b,), pos, dtype=torch.int64, device=x.device)
    out = decode_attention(q, cache["k"], cache["v"], cur_pos=cur,
                           window=spec.window)
    return out.reshape(b, s, -1) @ params["wo"], cache

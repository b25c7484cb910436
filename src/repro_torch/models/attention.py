"""Attention, GQA and MLA: projections, rotary, prefill through the
flash-attention kernel, and single-step decode against the cache.

Port of ``repro/models/attention.py``. Prefill attention calls
``kernels.ops.flash_attention`` (the CUDA kernel on the card, its plain
version on the CPU), where the JAX package computes the same function in
jnp; MLA's heads reach it with D = nope + rope and Dv = v. MLA caches the
compressed latent ``c_kv`` and one shared rope key a token, and decodes
either in the latent space (``absorb``, the default) or by expanding K and
V from the latent. The JAX package's ``chunked``/``tri``/``naive``/
``window`` strategies are one kernel here.

The caches are updated in place (prefill writes [0, S), decode writes one
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
from repro_torch.models.layers import apply_rope, normal_init, rms_normalize

NEG_INF = -1e30


def init_attn(gen: torch.Generator, d_model: int, spec: AttnSpec, dtype,
              device, lead=()) -> dict:
    if spec.mla is not None:
        m = spec.mla
        qk_dim = m.qk_nope_dim + m.qk_rope_dim
        return {
            "q_a": normal_init(gen, (*lead, d_model, m.q_lora_rank), dtype,
                               device),
            "q_a_norm": torch.ones((*lead, m.q_lora_rank), dtype=dtype,
                                   device=device),
            "q_b": normal_init(gen, (*lead, m.q_lora_rank,
                                     spec.n_heads * qk_dim), dtype, device),
            "kv_a": normal_init(gen, (*lead, d_model,
                                      m.kv_lora_rank + m.qk_rope_dim),
                                dtype, device),
            "kv_a_norm": torch.ones((*lead, m.kv_lora_rank), dtype=dtype,
                                    device=device),
            "kv_b": normal_init(gen, (*lead, m.kv_lora_rank, spec.n_heads
                                      * (m.qk_nope_dim + m.v_head_dim)),
                                dtype, device),
            "wo": normal_init(gen, (*lead, spec.n_heads * m.v_head_dim,
                                    d_model), dtype, device),
        }
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


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention)
# ---------------------------------------------------------------------------


def _mla_q(params, x, spec: AttnSpec):
    """Returns (q_nope, q_rope): (B,S,H,nope), (B,S,H,rope); ``q_b`` gives
    each head [nope | rope]."""
    m = spec.mla
    b, s, _ = x.shape
    q_c = rms_normalize(x @ params["q_a"]) * params["q_a_norm"]
    q = (q_c @ params["q_b"]).reshape(b, s, -1,
                                      m.qk_nope_dim + m.qk_rope_dim)
    return q.split([m.qk_nope_dim, m.qk_rope_dim], dim=-1)


def _mla_kv_compress(params, x, spec: AttnSpec, positions):
    """Returns (c_kv (B,S,r), k_rope (B,S,1,rope)): ``kv_a`` gives
    [c_kv | k_rope]; the one rope key is shared by every head."""
    m = spec.mla
    c_kv, k_rope = (x @ params["kv_a"]).split(
        [m.kv_lora_rank, m.qk_rope_dim], dim=-1)
    c_kv = rms_normalize(c_kv) * params["kv_a_norm"]
    k_rope = apply_rope(k_rope[:, :, None, :], positions, spec.rope_theta)
    return c_kv, k_rope


def _mla_expand(params, c_kv, spec: AttnSpec):
    """(B,S,r) -> (k_nope (B,S,H,nope), v (B,S,H,v)); ``kv_b`` gives each
    head [k_nope | v]."""
    m = spec.mla
    b, s, _ = c_kv.shape
    kvb = (c_kv @ params["kv_b"]).reshape(
        b, s, -1, m.qk_nope_dim + m.v_head_dim)
    return kvb.split([m.qk_nope_dim, m.v_head_dim], dim=-1)


def _mla_scale(spec: AttnSpec) -> float:
    return 1.0 / math.sqrt(spec.mla.qk_nope_dim + spec.mla.qk_rope_dim)


def mla_forward(params: dict, x: torch.Tensor, spec: AttnSpec, *,
                positions: torch.Tensor, cache: Optional[dict] = None):
    """Train/prefill. positions: (S,) = 0..S-1. Returns (out, cache|None);
    a given cache gets the compressed latent and the rope key at [0, S) in
    place. Attention runs with D = nope + rope and Dv = v."""
    m = spec.mla
    b, s, _ = x.shape
    q_nope, q_rope = _mla_q(params, x, spec)
    q_rope = apply_rope(q_rope, positions[None, :], spec.rope_theta)
    c_kv, k_rope = _mla_kv_compress(params, x, spec, positions[None, :])
    k_nope, v = _mla_expand(params, c_kv, spec)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(*k_nope.shape[:3], m.qk_rope_dim)],
                  dim=-1)
    if cache is not None:  # the compressed kv, not K and V (MLA's saving)
        cache["c_kv"][:, :s] = c_kv.to(cache["c_kv"].dtype)
        cache["k_rope"][:, :s] = k_rope[:, :, 0].to(cache["k_rope"].dtype)
    out = attention(q, k, v, scale=_mla_scale(spec))
    return out.reshape(b, s, -1) @ params["wo"], cache


def mla_decode(params: dict, x: torch.Tensor, spec: AttnSpec, *, pos: int,
               cache: dict, absorb: bool = True):
    """Decode against the compressed cache, which gets this step's latent
    and rope key at ``pos`` in place. ``absorb`` scores in the latent space
    (``kv_b`` folded into the query and the output; no per-token K or V);
    otherwise K and V are expanded from the cache."""
    m = spec.mla
    b, s, _ = x.shape
    posv = torch.full((1, 1), pos, dtype=torch.int64, device=x.device)
    q_nope, q_rope = _mla_q(params, x, spec)
    q_rope = apply_rope(q_rope, posv, spec.rope_theta)
    c_kv_new, k_rope_new = _mla_kv_compress(params, x, spec, posv)
    cache["c_kv"][:, pos:pos + 1] = c_kv_new.to(cache["c_kv"].dtype)
    cache["k_rope"][:, pos:pos + 1] = k_rope_new[:, :, 0].to(
        cache["k_rope"].dtype)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    kpos = torch.arange(c_kv.shape[1], device=x.device)
    mask = (kpos <= pos)[None, None, None, :]
    if absorb:
        w_kb = params["kv_b"].reshape(m.kv_lora_rank, -1,
                                      m.qk_nope_dim + m.v_head_dim)
        w_k, w_v = w_kb.split([m.qk_nope_dim, m.v_head_dim], dim=-1)
        q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope, w_k)
        sc = torch.einsum("bqhr,bkr->bhqk", q_lat.float(), c_kv.float()) \
            + torch.einsum("bqhn,bkn->bhqk", q_rope.float(), k_rope.float())
        sc = torch.where(mask, sc * _mla_scale(spec),
                         torch.full_like(sc, NEG_INF))
        p = torch.softmax(sc, dim=-1)
        o_lat = torch.einsum("bhqk,bkr->bqhr", p, c_kv.float())
        out = torch.einsum("bqhr,rhv->bqhv", o_lat.to(x.dtype), w_v)
    else:
        k_nope, v = _mla_expand(params, c_kv.to(x.dtype), spec)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope[:, :, None, :].to(x.dtype).expand(
            *k_nope.shape[:3], m.qk_rope_dim)], dim=-1)
        sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        sc = torch.where(mask, sc * _mla_scale(spec),
                         torch.full_like(sc, NEG_INF))
        p = torch.softmax(sc, dim=-1)
        out = torch.einsum("bhqk,bkhv->bqhv", p, v.float()).to(x.dtype)
    return out.reshape(b, s, -1) @ params["wo"], cache

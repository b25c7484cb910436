"""Attention, GQA and MLA: projections, rotary, prefill through the
flash-attention kernel, and single-step decode against the cache.

Port of ``repro/models/attention.py``. Prefill attention calls
``kernels.ops.flash_attention`` and GQA decode attention
``kernels.ops.decode_attention`` (the CUDA kernels on the card, their plain
versions on the CPU), where the JAX package computes the same functions in
jnp; MLA's heads reach the flash kernel with D = nope + rope and Dv = v.
MLA caches the compressed latent ``c_kv`` and one shared rope key a
token, and decodes either in the latent space (``absorb``, the default) or
by expanding K and V from the latent. The JAX package's ``chunked``/
``tri``/``naive``/``window`` strategies are one kernel here.

The caches are updated in place (prefill writes [0, S), decode writes one
position), where the JAX package returns updated copies: this saves a
copy of every cache leaf per layer and step. The functions still return
the cache so that callers read like the reference.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import AttnSpec
from repro_torch.core import obs_model
from repro_torch.kernels import ops
from repro_torch.models.layers import (apply_rope, normal_init, reshape,
                                       rms_normalize, shard_offset)

NEG_INF = -1e30


def padded_heads(n_heads: int, head_pad: int) -> int:
    return (n_heads + head_pad - 1) // head_pad * head_pad


def _pad_dim(w: torch.Tensor, dim: int, extra: int) -> torch.Tensor:
    """``w`` with ``extra`` zero columns (``dim=-1``) or rows (``-2``)."""
    if not extra:
        return w
    pad = [0, extra] if dim == -1 else [0, 0, 0, extra]
    return torch.nn.functional.pad(w, pad)


def init_attn(gen: torch.Generator, d_model: int, spec: AttnSpec, dtype,
              device, lead=(), head_pad: int = 1) -> dict:
    """``head_pad > 1`` zero-pads the head count to a multiple of it, as the
    JAX package's ``init_attn`` (Megatron-style TP divisibility): the
    columns of ``wq``, ``q_b`` and ``kv_b``, the rows of ``wo``, the
    biases, and for MHA ``wk``/``wv`` in lockstep. Each leaf draws its
    unpadded values from ``gen`` first, so the real heads equal those of
    ``head_pad=1`` bit for bit; the padded heads' v is zero, so their
    outputs are exactly zero and ``wo``'s padded rows never contribute."""
    extra = padded_heads(spec.n_heads, head_pad) - spec.n_heads
    if spec.mla is not None:
        m = spec.mla
        qk_dim = m.qk_nope_dim + m.qk_rope_dim
        return {
            "q_a": normal_init(gen, (*lead, d_model, m.q_lora_rank), dtype,
                               device),
            "q_a_norm": torch.ones((*lead, m.q_lora_rank), dtype=dtype,
                                   device=device),
            "q_b": _pad_dim(normal_init(gen, (*lead, m.q_lora_rank,
                                              spec.n_heads * qk_dim),
                                        dtype, device), -1, extra * qk_dim),
            "kv_a": normal_init(gen, (*lead, d_model,
                                      m.kv_lora_rank + m.qk_rope_dim),
                                dtype, device),
            "kv_a_norm": torch.ones((*lead, m.kv_lora_rank), dtype=dtype,
                                    device=device),
            "kv_b": _pad_dim(normal_init(
                gen, (*lead, m.kv_lora_rank,
                      spec.n_heads * (m.qk_nope_dim + m.v_head_dim)),
                dtype, device), -1, extra * (m.qk_nope_dim + m.v_head_dim)),
            "wo": _pad_dim(normal_init(gen, (*lead, spec.n_heads
                                             * m.v_head_dim, d_model),
                                       dtype, device),
                           -2, extra * m.v_head_dim),
        }
    kv_extra = extra if spec.n_kv_heads == spec.n_heads else 0  # MHA
    dh = spec.head_dim
    p = {
        "wq": _pad_dim(normal_init(gen, (*lead, d_model, spec.q_dim), dtype,
                                   device), -1, extra * dh),
        "wk": _pad_dim(normal_init(gen, (*lead, d_model, spec.kv_dim), dtype,
                                   device), -1, kv_extra * dh),
        "wv": _pad_dim(normal_init(gen, (*lead, d_model, spec.kv_dim), dtype,
                                   device), -1, kv_extra * dh),
        "wo": _pad_dim(normal_init(gen, (*lead, spec.q_dim, d_model), dtype,
                                   device), -2, extra * dh),
    }
    if spec.qkv_bias:
        for name, dim in (("bq", spec.q_dim + extra * dh),
                          ("bk", spec.kv_dim + kv_extra * dh),
                          ("bv", spec.kv_dim + kv_extra * dh)):
            p[name] = torch.zeros((*lead, dim), dtype=dtype, device=device)
    return p


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B,S,Hk,D) -> (B,S,H,D) by repeating each kv head over its group
    (``jnp.repeat`` along heads: query head h reads kv head h // (H/Hk))."""
    hk = k.shape[2]
    if hk == n_heads:
        return k
    return k.repeat_interleave(n_heads // hk, dim=2)


def _write(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst[...] = src`` in ``dst``'s dtype (a view of a cache, written in
    place). A DTensor source is first laid out as its destination, which
    an in-place op cannot change."""
    src = src.to(dst.dtype)
    if isinstance(dst, DTensor) and isinstance(src, DTensor):
        src = src.redistribute(dst.device_mesh, dst.placements)
    dst.copy_(src)


def _heads_out(out: torch.Tensor, shard: Optional[Callable]) -> torch.Tensor:
    """The (B,S,H*Dv) attention output, kept head-sharded under a hook
    (``wo``'s rows are sharded the same way)."""
    return out if shard is None else shard(out, ("data", None, "model"))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              window: Optional[int] = None, scale: Optional[float] = None,
              shard: Optional[Callable] = None) -> torch.Tensor:
    """Causal self-attention over positions 0..S-1 (train/prefill).
    q: (B,S,H,D), k,v: (B,S,Hk,D[v]). Returns (B,S,H,Dv). The kernel reads
    the kv head of each query head itself, so k and v are not expanded;
    under a ``shard`` hook they are, to H, before q, k and v are sharded
    (batch over the data axes, heads over ``model``), as in the JAX
    package: a rank's local query head i is global head r*H/m + i, which a
    kernel over Hk replicated kv heads would pair with the wrong one."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if shard is not None:
        k = _expand_kv(k, q.shape[2])
        v = _expand_kv(v, q.shape[2])
        q, k, v = (shard(t, ("data", None, "model", None))
                   for t in (q, k, v))
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=True, window=window,
                              scale=scale)
    return out.transpose(1, 2)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, cur_pos: torch.Tensor,
                     window: Optional[int] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-step decode. q:(B,1,H,D), caches:(B,S,Hk,D), cur_pos:(B,).
    ``kernels.ops.decode_attention``: the decode kernel on the card, which
    reads each kv head's live rows once for its group of query heads, and
    its plain version (the cache repeated over the group, two f32 einsums)
    on the CPU."""
    if isinstance(q, DTensor):
        return _decode_attention_shards(q, k_cache, v_cache, cur_pos=cur_pos,
                                        window=window, scale=scale)
    return ops.decode_attention(q, k_cache, v_cache, cur_pos=cur_pos,
                                window=window, scale=scale)


def _decode_attention_shards(q, k_cache, v_cache, *, cur_pos, window,
                             scale):
    """Decode attention of DTensors on each rank's rows and heads, wrapped
    back. The caches are laid out as q's batch shards; a cache whose heads
    are sharded as q's is attended as it is, and one whose heads are not
    (fewer kv heads than the model axis) gives each rank the kv head of
    each of its query heads (``jnp.repeat``'s grouping, without expanding
    the whole cache). Every row shares one position."""
    mesh = q.device_mesh
    pl = tuple(p if p in (Shard(0), Shard(2)) else Replicate()
               for p in q.placements)  # q's batch and head shards
    h, hk = q.shape[2], k_cache.shape[2]
    q = q.redistribute(mesh, pl)
    q_loc = q.to_local()
    if hk == h or all(p != Shard(2) for p in pl):
        k, v = (_expand_kv(t, h).redistribute(mesh, pl).to_local()
                for t in (k_cache, v_cache))
    else:
        rows = tuple(Shard(0) if p == Shard(0) else Replicate() for p in pl)
        first = shard_offset(q, 2)
        kv = torch.arange(first, first + q_loc.shape[2],
                          device=q_loc.device) // (h // hk)
        k, v = (t.redistribute(mesh, rows).to_local()[:, :, kv]
                for t in (k_cache, v_cache))
    out = decode_attention(q_loc, k, v, cur_pos=cur_pos[:q_loc.shape[0]],
                           window=window, scale=scale)
    return ops.wrap_local(out, mesh, pl)


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
    q = reshape(q, b, s, -1, spec.head_dim)
    k = reshape(k, b, s, -1, spec.head_dim)
    v = reshape(v, b, s, -1, spec.head_dim)
    return q, k, v


def gqa_forward(params: dict, x: torch.Tensor, spec: AttnSpec, *,
                positions: torch.Tensor, cache: Optional[dict] = None,
                shard: Optional[Callable] = None):
    """Train/prefill path. positions: (S,) = 0..S-1. Returns
    (out, cache|None); a given cache is filled at [0, S) in place."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, x, spec)
    if spec.rope:
        q = apply_rope(q, positions[None, :], spec.rope_theta)
        k = apply_rope(k, positions[None, :], spec.rope_theta)
    if cache is not None:  # prefill: write into the cache at [0, s)
        _write(cache["k"][:, :s], k)
        _write(cache["v"][:, :s], v)
    with obs_model.span("attn.core", q) as sp:
        out = sp.output(attention(sp.input(q), k, v, window=spec.window,
                                  shard=shard))
    return _heads_out(out.reshape(b, s, -1), shard) @ params["wo"], cache


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
    _write(cache["k"][:, pos:pos + 1], k)
    _write(cache["v"][:, pos:pos + 1], v)
    cur = torch.full((b,), pos, dtype=torch.int64, device=x.device)
    with obs_model.span("attn.core", q, alloc=True):
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
    q = reshape(q_c @ params["q_b"], b, s, -1, m.qk_nope_dim + m.qk_rope_dim)
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
    kvb = reshape(c_kv @ params["kv_b"], b, s, -1,
                  m.qk_nope_dim + m.v_head_dim)
    return kvb.split([m.qk_nope_dim, m.v_head_dim], dim=-1)


def _mla_scale(spec: AttnSpec) -> float:
    return 1.0 / math.sqrt(spec.mla.qk_nope_dim + spec.mla.qk_rope_dim)


def mla_forward(params: dict, x: torch.Tensor, spec: AttnSpec, *,
                positions: torch.Tensor, cache: Optional[dict] = None,
                shard: Optional[Callable] = None):
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
        _write(cache["c_kv"][:, :s], c_kv)
        _write(cache["k_rope"][:, :s], k_rope[:, :, 0])
    with obs_model.span("attn.core", q) as sp:
        out = sp.output(attention(sp.input(q), k, v, scale=_mla_scale(spec),
                                  shard=shard))
    return _heads_out(out.reshape(b, s, -1), shard) @ params["wo"], cache


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
    _write(cache["c_kv"][:, pos:pos + 1], c_kv_new)
    _write(cache["k_rope"][:, pos:pos + 1], k_rope_new[:, :, 0])
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    kpos = torch.arange(c_kv.shape[1], device=x.device)
    mask = (kpos <= pos)[None, None, None, :]
    if absorb:
        w_kb = reshape(params["kv_b"], m.kv_lora_rank, -1,
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

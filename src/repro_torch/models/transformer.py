"""Decoder-only model over stages of repeated superblocks.

Port of ``repro/models/transformer.py``. An architecture is a sequence of
stages; each stage is a superblock (tuple of LayerSpec) repeated R times.
As in the JAX package, a stage with R > 1 keeps its parameters and caches
stacked along a leading dim of size R, so leaf names and shapes match the
reference one to one; where JAX scans over that dim, this module loops
over it in Python, and in training (``RunConfig.remat``, on by default)
recomputes each repeat in the backward (``torch.utils.checkpoint``) where
JAX wraps the scan body in ``jax.checkpoint``.

Mixers are GQA attention, MLA (latent attention with a compressed
cache), Mamba and RWKV6; MLPs are dense or MoE (RWKV's channel mix takes
the MLP's place), so hybrid stacks such as Jamba's run as they are.
A modality front end hands in precomputed embeddings (``frontend``,
(B, Nf, d_model)), which are prepended to the token embeddings, so the
tokens sit at positions Nf.. in the sequence and in the cache; an
architecture with sinusoidal positions adds them to both.

Three modes share one code path:
  - train:   full sequence, no cache; ``loss_fn`` takes the seq-chunked
             vocab cross-entropy plus the MoE aux loss
  - prefill: full sequence, writes the decode cache (in place)
  - decode:  single token at position ``pos`` against the cache (in place)
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch import device as device_mod
from repro_torch.configs.base import ArchConfig, LayerSpec, Stage
from repro_torch.core import obs_model
from repro_torch.kernels import ops
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (apply_mlp, apply_norm, init_mlp,
                                       init_norm, normal_init, shard_offset,
                                       sinusoidal_pos_emb, softcap)
from repro_torch.weights import tree_leaves

VOCAB_PAD = 256  # pad vocab to a multiple of this (TP divisibility)


def padded_vocab(v: int) -> int:
    return (v + VOCAB_PAD - 1) // VOCAB_PAD * VOCAB_PAD


@dataclass(frozen=True)
class RunConfig:
    """Runtime knobs the serving and training paths read."""

    param_dtype: Any = torch.bfloat16
    cache_dtype: Any = torch.bfloat16
    loss_chunk: int = 1024  # seq-chunked vocab xent (recomputed)
    rwkv_chunk: int = 64  # wkv recurrence chunk (train and prefill)
    capacity_factor: float = 1.25  # MoE slots an expert: S*k*factor/E + 1
    moe_groups: int = 0  # 0 = auto policy (per-seq train, 16-token decode)
    remat: bool = True  # recompute each repeat of a stage in the backward
    mla_absorb: bool = True  # MLA decode in the latent space
    head_pad: int = 1  # pad head counts to this multiple (TP divisibility)
    # set by the launch layer (launch/sharding.run_config_for):
    # shard(x, partition_tuple) -> x laid out over the mesh
    shard: Optional[Callable] = None


# ===========================================================================
# Init
# ===========================================================================


def _init_block(cfg: ArchConfig, spec: LayerSpec, gen, dtype, device,
                lead, head_pad: int = 1) -> dict:
    p = {"ln1": init_norm(cfg.norm, cfg.d_model, dtype, device, lead),
         "ln2": init_norm(cfg.norm, cfg.d_model, dtype, device, lead)}
    if spec.kind == "attn":
        p["mixer"] = attn_mod.init_attn(gen, cfg.d_model, spec.attn, dtype,
                                        device, lead, head_pad)
    elif spec.kind == "mamba":
        p["mixer"] = ssm_mod.init_mamba_full(gen, cfg.d_model, spec.mamba,
                                             dtype, device, lead)
    else:
        p["mixer"] = ssm_mod.init_rwkv(gen, cfg.d_model, spec.rwkv, dtype,
                                       device, lead)
    if spec.mlp.kind == "dense":
        p["mlp"] = init_mlp(gen, cfg.d_model, spec.mlp.d_ff, spec.mlp.act,
                            dtype, device, lead)
    elif spec.mlp.kind == "moe":
        p["mlp"] = moe_mod.init_moe(gen, cfg.d_model, spec.mlp.moe,
                                    spec.mlp.act, dtype, device, lead)
    elif spec.kind == "rwkv":  # the channel mix, in the MLP's place
        p["mlp"] = ssm_mod.init_rwkv_channel(gen, cfg.d_model, spec.rwkv,
                                             dtype, device, lead)
    else:
        p["mlp"] = {}
    return p


def _init_superblock(cfg, stage: Stage, gen, dtype, device, lead,
                     head_pad: int = 1) -> dict:
    return {f"L{i}": _init_block(cfg, spec, gen, dtype, device, lead,
                                 head_pad)
            for i, spec in enumerate(stage.block)}


def init_params(cfg: ArchConfig, gen: torch.Generator,
                rc: RunConfig = RunConfig(), device="cuda") -> dict:
    """Random weights from ``gen`` (which must live on ``device``), with the
    leaf names and shapes of the JAX package's ``init_params``: a stage
    with repeat R > 1 has every leaf stacked along a leading dim of R."""
    device = device_mod.resolve(device)
    dtype = rc.param_dtype
    vp = padded_vocab(cfg.vocab_size)
    params = {"embed": normal_init(gen, (vp, cfg.d_model), dtype, device),
              "final_norm": init_norm(cfg.norm, cfg.d_model, dtype, device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal_init(gen, (cfg.d_model, vp), dtype, device)
    params["stages"] = [
        _init_superblock(cfg, stage, gen, dtype, device,
                         () if stage.repeat == 1 else (stage.repeat,),
                         rc.head_pad)
        for stage in cfg.stages]
    return params


# ===========================================================================
# Cache init
# ===========================================================================


def _init_layer_cache(cfg, spec: LayerSpec, batch: int, max_len: int, rc,
                      device, lead):
    cd = rc.cache_dtype
    if spec.kind == "attn" and spec.attn.mla is not None:
        m = spec.attn.mla  # the compressed latent and the shared rope key
        return {"c_kv": torch.zeros((*lead, batch, max_len, m.kv_lora_rank),
                                    dtype=cd, device=device),
                "k_rope": torch.zeros((*lead, batch, max_len,
                                       m.qk_rope_dim), dtype=cd,
                                      device=device)}
    if spec.kind == "attn":
        a = spec.attn
        nkv = a.n_kv_heads
        if nkv == a.n_heads:  # MHA: kv padded in lockstep with q
            nkv = attn_mod.padded_heads(nkv, rc.head_pad)
        shape = (*lead, batch, max_len, nkv, a.head_dim)
        return {name: torch.zeros(shape, dtype=cd, device=device)
                for name in ("k", "v")}
    if spec.kind == "rwkv":
        h, dh = cfg.d_model // spec.rwkv.head_dim, spec.rwkv.head_dim
        return {"shift_tm": torch.zeros((*lead, batch, cfg.d_model),
                                        dtype=cd, device=device),
                "shift_cm": torch.zeros((*lead, batch, cfg.d_model),
                                        dtype=cd, device=device),
                "wkv": torch.zeros((*lead, batch, h, dh, dh),
                                   dtype=torch.float32, device=device)}
    di = spec.mamba.d_inner(cfg.d_model)
    return {"conv": torch.zeros((*lead, batch, spec.mamba.d_conv - 1, di),
                                dtype=cd, device=device),
            "ssm": torch.zeros((*lead, batch, di, spec.mamba.d_state),
                               dtype=torch.float32, device=device)}


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               rc: RunConfig = RunConfig(), device="cuda"):
    device = device_mod.resolve(device)
    caches = []
    for stage in cfg.stages:
        lead = () if stage.repeat == 1 else (stage.repeat,)
        caches.append({f"L{i}": _init_layer_cache(cfg, spec, batch, max_len,
                                                  rc, device, lead)
                       for i, spec in enumerate(stage.block)})
    return caches


# ===========================================================================
# Apply
# ===========================================================================


def _apply_mixer(cfg, spec: LayerSpec, rc: RunConfig, params, x, *, mode,
                 positions, pos, cache):
    if spec.kind == "attn" and spec.attn.mla is not None:
        if mode == "decode":
            return attn_mod.mla_decode(params, x, spec.attn, pos=pos,
                                       cache=cache, absorb=rc.mla_absorb)
        return attn_mod.mla_forward(params, x, spec.attn,
                                    positions=positions, cache=cache,
                                    shard=rc.shard)
    if spec.kind == "attn":
        if mode == "decode":
            return attn_mod.gqa_decode(params, x, spec.attn, pos=pos,
                                       cache=cache)
        return attn_mod.gqa_forward(params, x, spec.attn,
                                    positions=positions, cache=cache,
                                    shard=rc.shard)
    if spec.kind == "rwkv":
        return ssm_mod.rwkv_time_mix(params, x, spec.rwkv,
                                     chunk=rc.rwkv_chunk, cache=cache,
                                     mode=mode)
    if mode == "decode":
        return ssm_mod.mamba_decode(params, x, spec.mamba, cfg.d_model,
                                    cache=cache)
    return ssm_mod.mamba_forward(params, x, spec.mamba, cfg.d_model,
                                 cache=cache)


def _apply_block(cfg, spec: LayerSpec, rc, params, x, *, mode, positions,
                 pos, cache, n_groups):
    """Returns (x, the MoE aux loss: a plain 0.0 for a dense MLP, so that
    a dense model's serving launches nothing for it). An RWKV layer's one
    cache dict holds both its mixes' state. Attention and the MLP run
    inside ``obs_model`` spans (``<mode>/attn``, ``<mode>/mlp``), which
    record only under the profiler."""
    h = apply_norm(cfg.norm, params["ln1"], x, cfg.norm_eps)
    sp = obs_model.span("attn", h, mode) if spec.kind == "attn" \
        else obs_model.NO_SPAN
    with sp:
        mix_out, _ = _apply_mixer(cfg, spec, rc, params["mixer"],
                                  sp.input(h), mode=mode,
                                  positions=positions, pos=pos, cache=cache)
        mix_out = sp.output(mix_out)
    x = x + mix_out
    if rc.shard is not None:  # the row-parallel output's partial sums
        x = rc.shard(x, ("data", None, None))
    aux = 0.0
    h = apply_norm(cfg.norm, params["ln2"], x, cfg.norm_eps)
    if spec.mlp.kind in ("dense", "moe"):
        with obs_model.span("mlp", h, mode) as sp:
            if spec.mlp.kind == "dense":
                y = apply_mlp(params["mlp"], sp.input(h), spec.mlp.act)
            else:
                y, aux = moe_mod.apply_moe(
                    params["mlp"], sp.input(h), spec.mlp.moe, spec.mlp.act,
                    n_groups=n_groups, capacity_factor=rc.capacity_factor,
                    shard=rc.shard)
            y = sp.output(y)
        x = x + y
    elif spec.kind == "rwkv":
        y, _ = ssm_mod.rwkv_channel_mix(params["mlp"], h, cache=cache,
                                        mode=mode)
        x = x + y
    if rc.shard is not None:
        x = rc.shard(x, ("data", None, None))
    return x, aux


def _apply_superblock(cfg, stage: Stage, rc, params, x, *, mode, positions,
                      pos, cache, n_groups):
    aux_total = 0.0
    for i, spec in enumerate(stage.block):
        li = f"L{i}"
        x, aux = _apply_block(cfg, spec, rc, _gathered(rc, params[li]), x,
                              mode=mode,
                              positions=positions, pos=pos,
                              cache=None if cache is None else cache[li],
                              n_groups=n_groups)
        aux_total = aux_total + aux
    return x, aux_total


def _gathered(rc: RunConfig, params):
    """A layer's parameters as it computes with them: under a mesh hook
    with FSDP, their shards over the data axes all-gathered first (ZeRO-3;
    XLA inserts the same all-gather for the JAX package). Without a hook
    the tree itself."""
    gather = getattr(rc.shard, "gather_fsdp", None)
    return params if gather is None else gather(params)


def _index(tree, r: int):
    """Views of repeat ``r`` of a stacked stage (writes go through)."""
    return {k: _index(v, r) if isinstance(v, dict) else v[r]
            for k, v in tree.items()}


def _apply_stage(cfg, stage: Stage, rc, params, x, *, mode, positions, pos,
                 cache, n_groups):
    """Returns (x, the stage's summed MoE aux loss). In train mode with
    ``rc.remat`` each repeat of a stacked stage is recomputed in the
    backward, as the JAX package's ``jax.checkpoint`` of its scan body;
    without it autograd keeps every repeat's activations. A stage of one
    repeat is not recomputed, as there."""
    if stage.repeat == 1:
        return _apply_superblock(cfg, stage, rc, params, x, mode=mode,
                                 positions=positions, pos=pos, cache=cache,
                                 n_groups=n_groups)
    aux_total = 0.0
    for r in range(stage.repeat):  # the JAX package's lax.scan
        def body(x_, r=r):
            return _apply_superblock(
                cfg, stage, rc, _index(params, r), x_, mode=mode,
                positions=positions, pos=pos,
                cache=None if cache is None else _index(cache, r),
                n_groups=n_groups)
        if rc.remat and mode == "train":
            x, aux = checkpoint(body, x, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x, aux = body(x)
        aux_total = aux_total + aux
    return x, aux_total


def _embed(cfg: ArchConfig, params, tokens, frontend, positions,
           rc: RunConfig = RunConfig()):
    """Token embeddings (scaled in f32 where the arch asks), the front end's
    embeddings cast to their dtype and prepended, then sinusoidal positions
    added in f32 where the arch has them."""
    x = _lookup(_gathered(rc, params["embed"]), tokens)
    if cfg.scale_embed:
        x = (x.float() * math.sqrt(cfg.d_model)).to(x.dtype)
    if frontend is not None:
        x = torch.cat([frontend.to(x.dtype), x], dim=1)
    if cfg.pos_emb == "sinusoidal":
        pe = sinusoidal_pos_emb(positions, cfg.d_model)
        x = (x.float() + pe).to(x.dtype)
    return x


def _logits(cfg: ArchConfig, params, x, rc: RunConfig = RunConfig()):
    head = _gathered(rc, params["embed"]).T if cfg.tie_embeddings \
        else _gathered(rc, params["lm_head"])
    logits = x @ head
    if rc.shard is not None:
        logits = rc.shard(logits, ("data", None, "model"))
    logits = softcap(logits, cfg.logit_softcap)
    vp = padded_vocab(cfg.vocab_size)
    if vp != cfg.vocab_size:  # mask padded vocab rows
        valid = torch.arange(vp, device=x.device) < cfg.vocab_size
        logits = torch.where(valid, logits,
                             torch.full_like(logits, -1e30))
    return logits


def forward(cfg: ArchConfig, params, tokens, *, frontend=None,
            mode: str = "prefill", caches=None, pos: Optional[int] = None,
            rc: RunConfig = RunConfig()):
    """tokens: (B,S) [decode: (B,1)]; frontend: None or (B,Nf,d_model)
    embeddings prepended in train and prefill. Returns (hidden, caches,
    aux): hidden is the final-norm output over all S + Nf rows; the caches,
    when given, are updated in place; aux is the summed MoE aux loss (0.0
    without MoE). ``rc`` gives the RWKV chunk, the MLA decode path, the MoE
    capacity factor and groups, and whether training recomputes."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode {mode!r}: the port runs train, prefill and "
                         "decode")
    b, s = tokens.shape
    if mode == "decode":
        positions = None
        x = _embed(cfg, params, tokens, None,
                   torch.full((b, 1), pos, dtype=torch.int64,
                              device=tokens.device)
                   if cfg.pos_emb == "sinusoidal" else None, rc)
    else:
        total = s + (frontend.shape[1] if frontend is not None else 0)
        positions = torch.arange(total, device=tokens.device)
        x = _embed(cfg, params, tokens, frontend, positions[None], rc)
    n_groups = rc.moe_groups or moe_mod.default_groups(b, x.shape[1], mode)
    if rc.shard is not None:
        x = rc.shard(x, ("data", None, None))
    aux_total = 0.0
    for i, stage in enumerate(cfg.stages):
        x, aux = _apply_stage(cfg, stage, rc, params["stages"][i], x,
                              mode=mode,
                              positions=positions, pos=pos,
                              cache=None if caches is None else caches[i],
                              n_groups=n_groups)
        aux_total = aux_total + aux
    x = apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    return x, caches, aux_total


# ===========================================================================
# Entry points
# ===========================================================================


def _lookup(table, tokens):
    """``table[tokens]``. For DTensors, each rank looks its own tokens up
    in its own rows of the table and the result is wrapped back: sharded
    as the tokens' batch, and for a vocab-sharded table zero outside the
    rank's rows, with the partial sums pending (Megatron's vocab-parallel
    embedding). DTensor's own ``index`` takes no token batch split over
    two mesh dims in some torch releases."""
    if not isinstance(table, DTensor):
        return table[tokens]
    mesh = table.device_mesh
    vocab = [i for i, p in enumerate(table.placements) if p == Shard(0)]
    rows = tuple(Shard(0) if p == Shard(0) and i not in vocab
                 else Replicate() for i, p in enumerate(tokens.placements))
    tok = tokens.redistribute(mesh, rows).to_local()
    local = table.redistribute(mesh, tuple(
        Shard(0) if i in vocab else Replicate()
        for i in range(mesh.ndim))).to_local()
    if not vocab:
        return ops.wrap_local(local[tok], mesh, rows)
    n = local.shape[0]
    rel = tok - shard_offset(table, 0)
    inside = (rel >= 0) & (rel < n)
    x = local[rel.clamp(0, n - 1)] * inside[..., None]
    return ops.wrap_local(x, mesh, tuple(
        Partial() if i in vocab else p for i, p in enumerate(rows)))


def _label_logits(logits, labels):
    """``logits.gather(-1, labels[..., None])[..., 0]``. For a DTensor
    whose vocab dim is sharded, the vocab-parallel gather (Megatron's):
    each rank gathers the labels inside its vocab slice, zero elsewhere,
    and the partial sums reduce once, on the (B, C) result."""
    vdim = logits.ndim - 1
    if not (isinstance(logits, DTensor)
            and Shard(vdim) in logits.placements):
        return logits.gather(-1, labels[..., None])[..., 0]
    mesh = logits.device_mesh
    rows = tuple(Shard(0) if p == Shard(0) else Replicate()
                 for p in logits.placements)
    lab = labels.redistribute(mesh, rows).to_local()
    local = logits.redistribute(mesh, tuple(
        Shard(vdim) if p == Shard(vdim) else r
        for p, r in zip(logits.placements, rows))).to_local()
    n = local.shape[-1]
    rel = lab - shard_offset(logits, vdim)
    inside = (rel >= 0) & (rel < n)
    ll = local.gather(-1, rel.clamp(0, n - 1)[..., None])[..., 0] * inside
    return ops.wrap_local(ll, mesh, tuple(
        Partial() if p == Shard(vdim) else r
        for p, r in zip(logits.placements, rows)))


def _xent_chunk(cfg: ArchConfig, rc: RunConfig, params, x_c, lab_c):
    """One chunk's head and cross-entropy, in a ``train/head`` span: the
    function that ``_chunked_xent`` checkpoints, so that the chunk's
    recompute in the backward is a span of its own."""
    with obs_model.span("head", x_c, "train") as sp:
        logits = _logits(cfg, params, sp.input(x_c), rc).float()
        lse = torch.logsumexp(logits, dim=-1)
        ll = _label_logits(logits, lab_c.clamp_min(0))
        mask = (lab_c >= 0).float()
        return sp.output(((lse - ll) * mask).sum()), mask.sum()


def _chunked_xent(cfg: ArchConfig, rc: RunConfig, params, x, labels):
    """Seq-chunked vocab cross-entropy: the (B,S,V) logits never exist.
    Each chunk's logits are recomputed in the backward
    (``torch.utils.checkpoint``, the JAX package's ``jax.checkpoint``);
    the sequence is padded to whole chunks with label -1 (masked).
    Returns (sum_xent, sum_mask)."""
    b, s, _ = x.shape
    c = min(rc.loss_chunk, s)
    nc = math.ceil(s / c)
    pad = nc * c - s
    labels = labels.long()
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    sum_e = torch.zeros((), dtype=torch.float32, device=x.device)
    sum_m = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(nc):  # the JAX package's lax.scan over chunks
        e, m = checkpoint(_xent_chunk, cfg, rc, params,
                          x[:, i * c:(i + 1) * c],
                          labels[:, i * c:(i + 1) * c], use_reentrant=False,
                          preserve_rng_state=False)
        sum_e, sum_m = sum_e + e, sum_m + m
    return sum_e, sum_m


def loss_fn(cfg: ArchConfig, rc: RunConfig, params, batch,
            aux_coef: float = 0.01):
    """batch: tokens (B,S), labels (B,S) (-1 = masked), integer tensors;
    optional frontend_embeds (B,Nf,d_model), float. The loss covers the
    token rows only. Returns (loss, {"xent", "aux"})."""
    frontend = batch.get("frontend_embeds")
    hidden, _, aux = forward(cfg, params, batch["tokens"],
                             frontend=frontend, mode="train", rc=rc)
    nf = frontend.shape[1] if frontend is not None else 0
    hidden = hidden[:, nf:]  # token positions only
    aux = torch.as_tensor(aux, dtype=torch.float32, device=hidden.device)
    sum_e, sum_m = _chunked_xent(cfg, rc, params, hidden, batch["labels"])
    xent = sum_e / torch.clamp(sum_m, min=1.0)
    loss = xent + aux_coef * aux
    return loss, {"xent": xent, "aux": aux}


@torch.no_grad()
def prefill(cfg: ArchConfig, params, tokens, caches,
            rc: RunConfig = RunConfig(), frontend=None):
    """Returns (last-position logits (B,V), filled caches). With a
    ``frontend`` (B,Nf,d_model) the cache holds Nf + S positions, and
    decode continues at Nf + S. A ``prefill/step`` span under the
    profiler."""
    with obs_model.span("step", tokens, "prefill"):
        hidden, caches, _ = forward(cfg, params, tokens, frontend=frontend,
                                    mode="prefill", caches=caches, rc=rc)
        with obs_model.span("head", hidden):
            return _logits(cfg, params, hidden[:, -1:], rc)[:, -1], caches


@torch.no_grad()
def decode_step(cfg: ArchConfig, params, tokens, pos: int, caches,
                rc: RunConfig = RunConfig()):
    """tokens (B,1), pos: int. Returns (logits (B,V), caches). A
    ``decode/step`` span under the profiler."""
    with obs_model.span("step", tokens, "decode"):
        hidden, caches, _ = forward(cfg, params, tokens, mode="decode",
                                    caches=caches, pos=pos, rc=rc)
        with obs_model.span("head", hidden):
            return _logits(cfg, params, hidden, rc)[:, -1], caches


class Model:
    """``Model(cfg, rc, device)``: weights, caches, the training loss and
    the two serving steps on one device (``"cuda"`` unless the caller asks
    otherwise)."""

    def __init__(self, cfg: ArchConfig, rc: RunConfig = RunConfig(),
                 device="cuda"):
        self.cfg = cfg
        self.rc = rc
        self.device = device_mod.resolve(device)

    def init(self, seed: int) -> dict:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return init_params(self.cfg, gen, self.rc, self.device)

    def init_cache(self, batch: int, max_len: int):
        return init_cache(self.cfg, batch, max_len, self.rc, self.device)

    def loss(self, params, batch):
        return loss_fn(self.cfg, self.rc, params, batch)

    def prefill(self, params, tokens, caches, frontend=None):
        return prefill(self.cfg, params, tokens, caches, self.rc,
                       frontend=frontend)

    def decode_step(self, params, tokens, pos: int, caches):
        return decode_step(self.cfg, params, tokens, pos, caches, self.rc)


def count_params(cfg: ArchConfig, rc: RunConfig = RunConfig()) -> int:
    """Elements of every parameter leaf, counted on the ``meta`` device
    (nothing is allocated)."""
    params = init_params(cfg, torch.Generator(), rc, device="meta")
    return sum(math.prod(leaf.shape) for leaf in tree_leaves(params))


def count_active_params(cfg: ArchConfig) -> int:
    """Params touched per token: total minus inactive routed experts."""
    total = count_params(cfg)
    inactive = 0
    for spec in cfg.layer_specs():
        if spec.mlp.kind == "moe":
            m = spec.mlp.moe
            gated = 3  # swiglu/geglu experts have 3 matrices
            per_expert = gated * cfg.d_model * m.d_expert
            inactive += (m.n_experts - m.top_k) * per_expert
    return total - inactive

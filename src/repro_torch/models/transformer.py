"""Decoder-only model over stages of repeated superblocks.

Port of ``repro/models/transformer.py``. An architecture is a sequence of
stages; each stage is a superblock (tuple of LayerSpec) repeated R times.
As in the JAX package, a stage with R > 1 keeps its parameters and caches
stacked along a leading dim of size R, so leaf names and shapes match the
reference one to one; where JAX scans over that dim, this module loops
over it in Python, and in training recomputes each repeat in the backward
(``torch.utils.checkpoint``) where JAX wraps the scan body in
``jax.checkpoint``.

Mixers are GQA attention and Mamba; MLPs are dense or MoE, so hybrid
stacks such as Jamba's run as they are.

Three modes share one code path:
  - train:   full sequence, no cache; ``loss_fn`` takes the seq-chunked
             vocab cross-entropy plus the MoE aux loss
  - prefill: full sequence, writes the decode cache (in place)
  - decode:  single token at position ``pos`` against the cache (in place)

RWKV, MLA, modality front ends and additive position embeddings are not
ported yet: they raise ``NotImplementedError`` (ROADMAP, Queue 1).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import device as device_mod
from repro_torch.configs.base import ArchConfig, LayerSpec, Stage
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (apply_mlp, apply_norm, init_mlp,
                                       init_norm, normal_init, softcap)

VOCAB_PAD = 256  # pad vocab to a multiple of this (TP divisibility)


def padded_vocab(v: int) -> int:
    return (v + VOCAB_PAD - 1) // VOCAB_PAD * VOCAB_PAD


@dataclass(frozen=True)
class RunConfig:
    """Runtime knobs the serving and training paths read."""

    param_dtype: Any = torch.bfloat16
    cache_dtype: Any = torch.bfloat16
    loss_chunk: int = 1024  # seq-chunked vocab xent (recomputed)


def check_supported(cfg: ArchConfig, mode: str = "prefill") -> None:
    """Raise for the parts of ``cfg`` that the port does not run yet in
    ``mode``."""
    if cfg.n_frontend or cfg.pos_emb == "sinusoidal":
        raise NotImplementedError(
            f"{cfg.name}: modality front ends and sinusoidal position "
            "embeddings are not ported yet (ROADMAP: Queue 1)")
    for spec in cfg.layer_specs():
        if spec.kind not in ("attn", "mamba"):
            raise NotImplementedError(
                f"{cfg.name}: {spec.kind} mixers are not ported yet "
                "(ROADMAP: Queue 1, remaining mixers)")
        if spec.kind == "attn" and spec.attn.mla is not None:
            raise NotImplementedError(
                f"{cfg.name}: MLA is not ported yet "
                "(ROADMAP: Queue 1, remaining mixers)")


# ===========================================================================
# Init
# ===========================================================================


def _init_block(cfg: ArchConfig, spec: LayerSpec, gen, dtype, device,
                lead) -> dict:
    p = {"ln1": init_norm(cfg.norm, cfg.d_model, dtype, device, lead),
         "ln2": init_norm(cfg.norm, cfg.d_model, dtype, device, lead)}
    if spec.kind == "attn":
        p["mixer"] = attn_mod.init_attn(gen, cfg.d_model, spec.attn, dtype,
                                        device, lead)
    else:
        p["mixer"] = ssm_mod.init_mamba_full(gen, cfg.d_model, spec.mamba,
                                             dtype, device, lead)
    if spec.mlp.kind == "dense":
        p["mlp"] = init_mlp(gen, cfg.d_model, spec.mlp.d_ff, spec.mlp.act,
                            dtype, device, lead)
    elif spec.mlp.kind == "moe":
        p["mlp"] = moe_mod.init_moe(gen, cfg.d_model, spec.mlp.moe,
                                    spec.mlp.act, dtype, device, lead)
    else:
        p["mlp"] = {}
    return p


def _init_superblock(cfg, stage: Stage, gen, dtype, device, lead) -> dict:
    return {f"L{i}": _init_block(cfg, spec, gen, dtype, device, lead)
            for i, spec in enumerate(stage.block)}


def init_params(cfg: ArchConfig, gen: torch.Generator,
                rc: RunConfig = RunConfig(), device="cuda") -> dict:
    """Random weights from ``gen`` (which must live on ``device``), with the
    leaf names and shapes of the JAX package's ``init_params``: a stage
    with repeat R > 1 has every leaf stacked along a leading dim of R."""
    check_supported(cfg)
    device = device_mod.resolve(device)
    dtype = rc.param_dtype
    vp = padded_vocab(cfg.vocab_size)
    params = {"embed": normal_init(gen, (vp, cfg.d_model), dtype, device),
              "final_norm": init_norm(cfg.norm, cfg.d_model, dtype, device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal_init(gen, (cfg.d_model, vp), dtype, device)
    params["stages"] = [
        _init_superblock(cfg, stage, gen, dtype, device,
                         () if stage.repeat == 1 else (stage.repeat,))
        for stage in cfg.stages]
    return params


# ===========================================================================
# Cache init
# ===========================================================================


def _init_layer_cache(cfg, spec: LayerSpec, batch: int, max_len: int, rc,
                      device, lead):
    cd = rc.cache_dtype
    if spec.kind == "attn":
        shape = (*lead, batch, max_len, spec.attn.n_kv_heads,
                 spec.attn.head_dim)
        return {name: torch.zeros(shape, dtype=cd, device=device)
                for name in ("k", "v")}
    di = spec.mamba.d_inner(cfg.d_model)
    return {"conv": torch.zeros((*lead, batch, spec.mamba.d_conv - 1, di),
                                dtype=cd, device=device),
            "ssm": torch.zeros((*lead, batch, di, spec.mamba.d_state),
                               dtype=torch.float32, device=device)}


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               rc: RunConfig = RunConfig(), device="cuda"):
    check_supported(cfg)
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


def _apply_mixer(cfg, spec: LayerSpec, params, x, *, mode, positions, pos,
                 cache):
    if spec.kind == "attn":
        if mode == "decode":
            return attn_mod.gqa_decode(params, x, spec.attn, pos=pos,
                                       cache=cache)
        return attn_mod.gqa_forward(params, x, spec.attn,
                                    positions=positions, cache=cache)
    if mode == "decode":
        return ssm_mod.mamba_decode(params, x, spec.mamba, cfg.d_model,
                                    cache=cache)
    return ssm_mod.mamba_forward(params, x, spec.mamba, cfg.d_model,
                                 cache=cache)


def _apply_block(cfg, spec: LayerSpec, params, x, *, mode, positions, pos,
                 cache, n_groups):
    """Returns (x, the MoE aux loss: a plain 0.0 for a dense MLP, so that
    a dense model's serving launches nothing for it)."""
    h = apply_norm(cfg.norm, params["ln1"], x, cfg.norm_eps)
    mix_out, _ = _apply_mixer(cfg, spec, params["mixer"], h, mode=mode,
                              positions=positions, pos=pos, cache=cache)
    x = x + mix_out
    aux = 0.0
    h = apply_norm(cfg.norm, params["ln2"], x, cfg.norm_eps)
    if spec.mlp.kind == "dense":
        x = x + apply_mlp(params["mlp"], h, spec.mlp.act)
    elif spec.mlp.kind == "moe":
        y, aux = moe_mod.apply_moe(params["mlp"], h, spec.mlp.moe,
                                   spec.mlp.act, n_groups=n_groups)
        x = x + y
    return x, aux


def _apply_superblock(cfg, stage: Stage, params, x, *, mode, positions, pos,
                      cache, n_groups):
    aux_total = 0.0
    for i, spec in enumerate(stage.block):
        li = f"L{i}"
        x, aux = _apply_block(cfg, spec, params[li], x, mode=mode,
                              positions=positions, pos=pos,
                              cache=None if cache is None else cache[li],
                              n_groups=n_groups)
        aux_total = aux_total + aux
    return x, aux_total


def _index(tree, r: int):
    """Views of repeat ``r`` of a stacked stage (writes go through)."""
    return {k: _index(v, r) if isinstance(v, dict) else v[r]
            for k, v in tree.items()}


def _apply_stage(cfg, stage: Stage, params, x, *, mode, positions, pos,
                 cache, n_groups):
    """Returns (x, the stage's summed MoE aux loss). In train mode each
    repeat of a stacked stage is recomputed in the backward, as the JAX
    package's ``jax.checkpoint`` of its scan body; a stage of one repeat is
    not recomputed, as there."""
    if stage.repeat == 1:
        return _apply_superblock(cfg, stage, params, x, mode=mode,
                                 positions=positions, pos=pos, cache=cache,
                                 n_groups=n_groups)
    aux_total = 0.0
    for r in range(stage.repeat):  # the JAX package's lax.scan
        def body(x_, r=r):
            return _apply_superblock(
                cfg, stage, _index(params, r), x_, mode=mode,
                positions=positions, pos=pos,
                cache=None if cache is None else _index(cache, r),
                n_groups=n_groups)
        if mode == "train":
            x, aux = checkpoint(body, x, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x, aux = body(x)
        aux_total = aux_total + aux
    return x, aux_total


def _embed(cfg: ArchConfig, params, tokens):
    x = params["embed"][tokens]
    if cfg.scale_embed:
        x = (x.float() * math.sqrt(cfg.d_model)).to(x.dtype)
    return x


def _logits(cfg: ArchConfig, params, x):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = softcap(x @ head, cfg.logit_softcap)
    vp = padded_vocab(cfg.vocab_size)
    if vp != cfg.vocab_size:  # mask padded vocab rows
        valid = torch.arange(vp, device=x.device) < cfg.vocab_size
        logits = torch.where(valid, logits,
                             torch.full_like(logits, -1e30))
    return logits


def forward(cfg: ArchConfig, params, tokens, *, mode: str = "prefill",
            caches=None, pos: Optional[int] = None):
    """tokens: (B,S) [decode: (B,1)]. Returns (hidden, caches, aux): hidden
    is the final-norm output; the caches, when given, are updated in place;
    aux is the summed MoE aux loss (0.0 without MoE)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode {mode!r}: the port runs train, prefill and "
                         "decode")
    check_supported(cfg, mode)
    positions = None
    if mode != "decode":
        positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = _embed(cfg, params, tokens)
    n_groups = moe_mod.default_groups(tokens.shape[0], tokens.shape[1], mode)
    aux_total = 0.0
    for i, stage in enumerate(cfg.stages):
        x, aux = _apply_stage(cfg, stage, params["stages"][i], x, mode=mode,
                              positions=positions, pos=pos,
                              cache=None if caches is None else caches[i],
                              n_groups=n_groups)
        aux_total = aux_total + aux
    x = apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    return x, caches, aux_total


# ===========================================================================
# Entry points
# ===========================================================================


def _xent_chunk(cfg: ArchConfig, params, x_c, lab_c):
    logits = _logits(cfg, params, x_c).float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, lab_c.clamp_min(0)[..., None])[..., 0]
    mask = (lab_c >= 0).float()
    return ((lse - ll) * mask).sum(), mask.sum()


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
        e, m = checkpoint(_xent_chunk, cfg, params, x[:, i * c:(i + 1) * c],
                          labels[:, i * c:(i + 1) * c], use_reentrant=False,
                          preserve_rng_state=False)
        sum_e, sum_m = sum_e + e, sum_m + m
    return sum_e, sum_m


def loss_fn(cfg: ArchConfig, rc: RunConfig, params, batch,
            aux_coef: float = 0.01):
    """batch: tokens (B,S), labels (B,S) (-1 = masked), integer tensors.
    Returns (loss, {"xent", "aux"})."""
    hidden, _, aux = forward(cfg, params, batch["tokens"], mode="train")
    aux = torch.as_tensor(aux, dtype=torch.float32, device=hidden.device)
    sum_e, sum_m = _chunked_xent(cfg, rc, params, hidden, batch["labels"])
    xent = sum_e / torch.clamp(sum_m, min=1.0)
    loss = xent + aux_coef * aux
    return loss, {"xent": xent, "aux": aux}


@torch.no_grad()
def prefill(cfg: ArchConfig, params, tokens, caches):
    """Returns (last-position logits (B,V), filled caches)."""
    hidden, caches, _ = forward(cfg, params, tokens, mode="prefill",
                                caches=caches)
    return _logits(cfg, params, hidden[:, -1:])[:, -1], caches


@torch.no_grad()
def decode_step(cfg: ArchConfig, params, tokens, pos: int, caches):
    """tokens (B,1), pos: int. Returns (logits (B,V), caches)."""
    hidden, caches, _ = forward(cfg, params, tokens, mode="decode",
                                caches=caches, pos=pos)
    return _logits(cfg, params, hidden)[:, -1], caches


class Model:
    """``Model(cfg, rc, device)``: weights, caches, the training loss and
    the two serving steps on one device (``"cuda"`` unless the caller asks
    otherwise)."""

    def __init__(self, cfg: ArchConfig, rc: RunConfig = RunConfig(),
                 device="cuda"):
        check_supported(cfg)
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

    def prefill(self, params, tokens, caches):
        return prefill(self.cfg, params, tokens, caches)

    def decode_step(self, params, tokens, pos: int, caches):
        return decode_step(self.cfg, params, tokens, pos, caches)

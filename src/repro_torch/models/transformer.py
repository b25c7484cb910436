"""Decoder-only model over stages of repeated superblocks.

Port of ``repro/models/transformer.py`` for serving. An
architecture is a sequence of stages; each stage is a superblock (tuple of
LayerSpec) repeated R times. As in the JAX package, a stage with R > 1
keeps its parameters and caches stacked along a leading dim of size R, so
leaf names and shapes match the reference one to one; where JAX scans
over that dim, this module loops over it in Python.

Mixers are GQA attention and Mamba; MLPs are dense or MoE, so hybrid
stacks such as Jamba's run as they are.

Two modes share one code path:
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
    """Runtime knobs the serving path reads."""

    param_dtype: Any = torch.bfloat16
    cache_dtype: Any = torch.bfloat16


def check_supported(cfg: ArchConfig) -> None:
    """Raise for the parts of ``cfg`` that the port does not run yet."""
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
    h = apply_norm(cfg.norm, params["ln1"], x, cfg.norm_eps)
    mix_out, _ = _apply_mixer(cfg, spec, params["mixer"], h, mode=mode,
                              positions=positions, pos=pos, cache=cache)
    x = x + mix_out
    h = apply_norm(cfg.norm, params["ln2"], x, cfg.norm_eps)
    if spec.mlp.kind == "dense":
        x = x + apply_mlp(params["mlp"], h, spec.mlp.act)
    elif spec.mlp.kind == "moe":
        y, _ = moe_mod.apply_moe(params["mlp"], h, spec.mlp.moe,
                                 spec.mlp.act, n_groups=n_groups)
        x = x + y
    return x


def _apply_superblock(cfg, stage: Stage, params, x, *, mode, positions, pos,
                      cache, n_groups):
    for i, spec in enumerate(stage.block):
        li = f"L{i}"
        x = _apply_block(cfg, spec, params[li], x, mode=mode,
                         positions=positions, pos=pos,
                         cache=None if cache is None else cache[li],
                         n_groups=n_groups)
    return x


def _index(tree, r: int):
    """Views of repeat ``r`` of a stacked stage (writes go through)."""
    return {k: _index(v, r) if isinstance(v, dict) else v[r]
            for k, v in tree.items()}


def _apply_stage(cfg, stage: Stage, params, x, *, mode, positions, pos,
                 cache, n_groups):
    if stage.repeat == 1:
        return _apply_superblock(cfg, stage, params, x, mode=mode,
                                 positions=positions, pos=pos, cache=cache,
                                 n_groups=n_groups)
    for r in range(stage.repeat):  # the JAX package's lax.scan
        x = _apply_superblock(cfg, stage, _index(params, r), x,
                              mode=mode, positions=positions, pos=pos,
                              cache=None if cache is None
                              else _index(cache, r), n_groups=n_groups)
    return x


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
    """tokens: (B,S) [decode: (B,1)]. Returns (hidden, caches): hidden is
    the final-norm output; the caches, when given, are updated in place."""
    check_supported(cfg)
    if mode not in ("prefill", "decode"):
        raise ValueError(f"mode {mode!r}: the port runs prefill and decode "
                         "(training is ROADMAP Queue 1)")
    positions = None
    if mode == "prefill":
        positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = _embed(cfg, params, tokens)
    n_groups = moe_mod.default_groups(tokens.shape[0], tokens.shape[1], mode)
    for i, stage in enumerate(cfg.stages):
        x = _apply_stage(cfg, stage, params["stages"][i], x, mode=mode,
                         positions=positions, pos=pos,
                         cache=None if caches is None else caches[i],
                         n_groups=n_groups)
    x = apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    return x, caches


# ===========================================================================
# Entry points
# ===========================================================================


@torch.no_grad()
def prefill(cfg: ArchConfig, params, tokens, caches):
    """Returns (last-position logits (B,V), filled caches)."""
    hidden, caches = forward(cfg, params, tokens, mode="prefill",
                             caches=caches)
    return _logits(cfg, params, hidden[:, -1:])[:, -1], caches


@torch.no_grad()
def decode_step(cfg: ArchConfig, params, tokens, pos: int, caches):
    """tokens (B,1), pos: int. Returns (logits (B,V), caches)."""
    hidden, caches = forward(cfg, params, tokens, mode="decode",
                             caches=caches, pos=pos)
    return _logits(cfg, params, hidden)[:, -1], caches


class Model:
    """``Model(cfg, rc, device)``: weights, caches and the two serving
    steps on one device (``"cuda"`` unless the caller asks otherwise)."""

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

    def prefill(self, params, tokens, caches):
        return prefill(self.cfg, params, tokens, caches)

    def decode_step(self, params, tokens, pos: int, caches):
        return decode_step(self.cfg, params, tokens, pos, caches)

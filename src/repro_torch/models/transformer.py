"""Decoder-only model over stages of repeated superblocks: dense stages.

Port of the dense part of ``repro/models/transformer.py``. An
architecture is a sequence of stages; each stage is a superblock (tuple of
LayerSpec) repeated R times. As in the JAX package, a stage with R > 1
keeps its parameters and caches stacked along a leading dim of size R, so
leaf names and shapes match the reference one to one; where JAX scans
over that dim, this module loops over it in Python.

Two modes share one code path:
  - prefill: full sequence, writes the decode cache (in place)
  - decode:  single token at position ``pos`` against the cache (in place)

Mamba, RWKV, MoE, MLA, modality front ends and additive position
embeddings are not ported yet: they raise ``NotImplementedError``
(ROADMAP, Queue 1).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch import device as device_mod
from repro_torch.configs.base import ArchConfig, LayerSpec, Stage
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (apply_mlp, apply_norm, init_mlp,
                                       init_norm, normal_init, softcap)

VOCAB_PAD = 256  # pad vocab to a multiple of this (TP divisibility)


def padded_vocab(v: int) -> int:
    return (v + VOCAB_PAD - 1) // VOCAB_PAD * VOCAB_PAD


@dataclass(frozen=True)
class RunConfig:
    """Runtime knobs the dense serving path reads."""

    param_dtype: Any = torch.bfloat16
    cache_dtype: Any = torch.bfloat16


def check_supported(cfg: ArchConfig) -> None:
    """Raise for the parts of ``cfg`` that the port does not run yet."""
    if cfg.n_frontend or cfg.pos_emb == "sinusoidal":
        raise NotImplementedError(
            f"{cfg.name}: modality front ends and sinusoidal position "
            "embeddings are not ported yet (ROADMAP: Queue 1)")
    for spec in cfg.layer_specs():
        if spec.kind != "attn":
            raise NotImplementedError(
                f"{cfg.name}: {spec.kind} mixers are not ported yet "
                "(ROADMAP: Queue 1, remaining mixers)")
        if spec.attn.mla is not None:
            raise NotImplementedError(
                f"{cfg.name}: MLA is not ported yet "
                "(ROADMAP: Queue 1, remaining mixers)")
        if spec.mlp.kind != "dense":
            raise NotImplementedError(
                f"{cfg.name}: {spec.mlp.kind} MLPs are not ported yet "
                "(ROADMAP: Queue 1, remaining mixers)")


# ===========================================================================
# Init
# ===========================================================================


def _init_block(cfg: ArchConfig, spec: LayerSpec, gen, dtype, device,
                lead) -> dict:
    return {"ln1": init_norm(cfg.norm, cfg.d_model, dtype, device, lead),
            "ln2": init_norm(cfg.norm, cfg.d_model, dtype, device, lead),
            "mixer": attn_mod.init_attn(gen, cfg.d_model, spec.attn, dtype,
                                        device, lead),
            "mlp": init_mlp(gen, cfg.d_model, spec.mlp.d_ff, spec.mlp.act,
                            dtype, device, lead)}


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


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               rc: RunConfig = RunConfig(), device="cuda"):
    check_supported(cfg)
    device = device_mod.resolve(device)
    caches = []
    for stage in cfg.stages:
        lead = () if stage.repeat == 1 else (stage.repeat,)
        caches.append({
            f"L{i}": {name: torch.zeros(
                (*lead, batch, max_len, spec.attn.n_kv_heads,
                 spec.attn.head_dim), dtype=rc.cache_dtype, device=device)
                for name in ("k", "v")}
            for i, spec in enumerate(stage.block)})
    return caches


# ===========================================================================
# Apply
# ===========================================================================


def _apply_block(cfg, spec: LayerSpec, params, x, *, mode, positions, pos,
                 cache):
    h = apply_norm(cfg.norm, params["ln1"], x, cfg.norm_eps)
    if mode == "decode":
        mix_out, cache = attn_mod.gqa_decode(params["mixer"], h, spec.attn,
                                             pos=pos, cache=cache)
    else:
        mix_out, cache = attn_mod.gqa_forward(params["mixer"], h, spec.attn,
                                              positions=positions,
                                              cache=cache)
    x = x + mix_out
    h = apply_norm(cfg.norm, params["ln2"], x, cfg.norm_eps)
    return x + apply_mlp(params["mlp"], h, spec.mlp.act), cache


def _apply_superblock(cfg, stage: Stage, params, x, *, mode, positions, pos,
                      cache):
    for i, spec in enumerate(stage.block):
        li = f"L{i}"
        x, _ = _apply_block(cfg, spec, params[li], x, mode=mode,
                            positions=positions, pos=pos,
                            cache=None if cache is None else cache[li])
    return x


def _index(tree, r: int):
    """Views of repeat ``r`` of a stacked stage (writes go through)."""
    return {k: _index(v, r) if isinstance(v, dict) else v[r]
            for k, v in tree.items()}


def _apply_stage(cfg, stage: Stage, params, x, *, mode, positions, pos,
                 cache):
    if stage.repeat == 1:
        return _apply_superblock(cfg, stage, params, x, mode=mode,
                                 positions=positions, pos=pos, cache=cache)
    for r in range(stage.repeat):  # the JAX package's lax.scan
        x = _apply_superblock(cfg, stage, _index(params, r), x, mode=mode,
                              positions=positions, pos=pos,
                              cache=None if cache is None
                              else _index(cache, r))
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
    for i, stage in enumerate(cfg.stages):
        x = _apply_stage(cfg, stage, params["stages"][i], x, mode=mode,
                         positions=positions, pos=pos,
                         cache=None if caches is None else caches[i])
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

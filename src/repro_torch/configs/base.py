"""Architecture configuration system.

Every assigned architecture is expressed as an ``ArchConfig``: a sequence of
*stages*, where each stage is a homogeneous *superblock* (tuple of
``LayerSpec``) repeated ``repeat`` times. Homogeneous superblocks let the
model scan over the repeat dimension (``jax.lax.scan``), keeping compile
time O(1) in depth even for hybrid patterns (Jamba's 1-attn:7-mamba,
Gemma3's 5-local:1-global).

Shapes are the assigned input-shape set; ``shape_applicable`` encodes the
long_500k sub-quadratic rule from DESIGN.md.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Layer-level specs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MLASpec:
    """Multi-head latent attention (DeepSeek-V2 / MiniCPM3 style)."""

    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_dim: int = 64
    qk_rope_dim: int = 32
    v_head_dim: int = 64


@dataclass(frozen=True)
class AttnSpec:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope: bool = True
    rope_theta: float = 10_000.0
    window: Optional[int] = None  # sliding-window size; None = global
    mla: Optional[MLASpec] = None

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim


@dataclass(frozen=True)
class MambaSpec:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> d_model // 16

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank or max(1, d_model // 16)


@dataclass(frozen=True)
class RWKVSpec:
    head_dim: int = 64
    decay_lora: int = 64  # low-rank dim of the data-dependent decay (Finch)
    mix_lora: int = 32  # low-rank dim of the token-shift mixing
    d_ffn: int = 0  # channel-mix hidden size


@dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0  # shared (always-on) experts, DeepSeekMoE style


@dataclass(frozen=True)
class MLPSpec:
    kind: str = "dense"  # dense | moe | none
    d_ff: int = 0
    act: str = "swiglu"  # swiglu | geglu | gelu (non-gated)
    moe: Optional[MoESpec] = None


@dataclass(frozen=True)
class LayerSpec:
    kind: str  # attn | mamba | rwkv
    mlp: MLPSpec
    attn: Optional[AttnSpec] = None
    mamba: Optional[MambaSpec] = None
    rwkv: Optional[RWKVSpec] = None


@dataclass(frozen=True)
class Stage:
    block: Tuple[LayerSpec, ...]
    repeat: int

    @property
    def n_layers(self) -> int:
        return len(self.block) * self.repeat


# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    d_model: int
    vocab_size: int
    stages: Tuple[Stage, ...]
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    pos_emb: str = "rope"  # rope | sinusoidal | none (mixer-level rope still
    #                        controlled per-AttnSpec; this is the additive one)
    n_frontend: int = 0  # stub modality-frontend embeddings prepended
    max_seq: int = 32_768
    sub_quadratic: bool = False  # eligible for long_500k
    logit_softcap: float = 0.0
    scale_embed: bool = False  # multiply embeddings by sqrt(d_model) (Gemma)

    @property
    def n_layers(self) -> int:
        return sum(s.n_layers for s in self.stages)

    def layer_specs(self):
        for s in self.stages:
            for _ in range(s.repeat):
                for l in s.block:
                    yield l


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeSpec) -> bool:
    """Which (arch x shape) cells run. long_500k needs sub-quadratic attention."""
    if shape.name == "long_500k":
        return cfg.sub_quadratic
    return True  # all assigned archs are decoder-only: decode shapes apply


# ---------------------------------------------------------------------------
# Builders / helpers
# ---------------------------------------------------------------------------


def dense_layer(
    d_model: int,
    n_heads: int,
    n_kv_heads: int,
    d_ff: int,
    *,
    head_dim: int = 0,
    qkv_bias: bool = False,
    rope: bool = True,
    rope_theta: float = 10_000.0,
    window: Optional[int] = None,
    act: str = "swiglu",
    mla: Optional[MLASpec] = None,
) -> LayerSpec:
    return LayerSpec(
        kind="attn",
        attn=AttnSpec(
            n_heads=n_heads,
            n_kv_heads=n_kv_heads,
            head_dim=head_dim or d_model // n_heads,
            qkv_bias=qkv_bias,
            rope=rope,
            rope_theta=rope_theta,
            window=window,
            mla=mla,
        ),
        mlp=MLPSpec(kind="dense", d_ff=d_ff, act=act),
    )


def uniform_dense(cfg_name, family, n_layers, d_model, n_heads, n_kv_heads,
                  d_ff, vocab, **kw) -> ArchConfig:
    layer_kw = {k: kw.pop(k) for k in
                ("head_dim", "qkv_bias", "rope", "rope_theta", "window",
                 "act", "mla") if k in kw}
    layer = dense_layer(d_model, n_heads, n_kv_heads, d_ff, **layer_kw)
    return ArchConfig(
        name=cfg_name,
        family=family,
        d_model=d_model,
        vocab_size=vocab,
        stages=(Stage(block=(layer,), repeat=n_layers),),
        **kw,
    )


# ---------------------------------------------------------------------------
# Reduced (smoke-test) configs
# ---------------------------------------------------------------------------


def _shrink_attn(a: AttnSpec) -> AttnSpec:
    n_heads = min(a.n_heads, 4)
    n_kv = max(1, min(a.n_kv_heads, n_heads))
    while n_heads % n_kv:
        n_kv -= 1
    mla = MLASpec(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=8,
                  qk_rope_dim=8, v_head_dim=8) if a.mla else None
    return dataclasses.replace(
        a, n_heads=n_heads, n_kv_heads=n_kv, head_dim=16 if mla is None else 16,
        window=min(a.window, 32) if a.window else None, mla=mla)


def _shrink_mlp(m: MLPSpec) -> MLPSpec:
    if m.kind == "moe":
        moe = m.moe
        return dataclasses.replace(
            m, moe=MoESpec(n_experts=min(moe.n_experts, 4),
                           top_k=min(moe.top_k, 2),
                           d_expert=32,
                           n_shared=min(moe.n_shared, 1)))
    if m.kind == "dense":
        return dataclasses.replace(m, d_ff=64)
    return m


def _shrink_layer(l: LayerSpec) -> LayerSpec:
    return LayerSpec(
        kind=l.kind,
        attn=_shrink_attn(l.attn) if l.attn else None,
        mamba=MambaSpec(d_state=4, d_conv=4, expand=2, dt_rank=8)
        if l.mamba else None,
        rwkv=RWKVSpec(head_dim=8, decay_lora=8, mix_lora=4, d_ffn=64)
        if l.rwkv else None,
        mlp=_shrink_mlp(l.mlp),
    )


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests (one superblock per stage)."""
    stages = tuple(
        Stage(block=tuple(_shrink_layer(l) for l in s.block), repeat=1)
        for s in cfg.stages
    )
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        d_model=64,
        vocab_size=512,
        stages=stages,
        n_frontend=min(cfg.n_frontend, 4),
        max_seq=128,
    )

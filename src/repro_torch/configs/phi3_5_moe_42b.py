"""Phi-3.5-MoE (42B total / 6.6B active) — 16 experts top-2, every layer MoE.

[hf:microsoft/Phi-3.5-MoE-instruct] 32L, d_model=4096, 32H (GQA kv=8),
expert d_ff=6400, vocab=32064.
"""
from repro_torch.configs.base import (ArchConfig, AttnSpec, LayerSpec, MLPSpec,
                                MoESpec, Stage)


def config() -> ArchConfig:
    layer = LayerSpec(
        kind="attn",
        attn=AttnSpec(n_heads=32, n_kv_heads=8, head_dim=128, rope=True),
        mlp=MLPSpec(kind="moe", act="swiglu",
                    moe=MoESpec(n_experts=16, top_k=2, d_expert=6400)),
    )
    return ArchConfig(
        name="phi3.5-moe-42b-a6.6b",
        family="moe",
        d_model=4096,
        vocab_size=32_064,
        stages=(Stage(block=(layer,), repeat=32),),
        norm="layernorm",
        max_seq=131_072,
        sub_quadratic=False,
    )

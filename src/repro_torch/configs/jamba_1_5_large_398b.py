"""Jamba-1.5-Large (398B) — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887] 72L, d_model=8192, 64H (GQA kv=8), d_ff=24576, vocab=65536.
Structure: 8-layer superblocks (1 attention at index 3, 7 Mamba), MoE every
other layer (odd indices). 72 layers = 9 superblocks, scanned.
"""
from repro_torch.configs.base import (ArchConfig, AttnSpec, LayerSpec, MLPSpec,
                                MambaSpec, MoESpec, Stage)

D = 8192
FF = 24_576
MOE = MoESpec(n_experts=16, top_k=2, d_expert=FF, n_shared=0)


def _mlp(i: int) -> MLPSpec:
    if i % 2 == 1:
        return MLPSpec(kind="moe", act="swiglu", moe=MOE)
    return MLPSpec(kind="dense", d_ff=FF, act="swiglu")


def _layer(i: int) -> LayerSpec:
    if i == 3:  # the single attention layer in each 8-layer superblock
        return LayerSpec(
            kind="attn",
            attn=AttnSpec(n_heads=64, n_kv_heads=8, head_dim=128,
                          rope=False),  # Jamba uses no positional encoding
            mlp=_mlp(i),
        )
    return LayerSpec(kind="mamba", mamba=MambaSpec(d_state=16, d_conv=4,
                                                   expand=2), mlp=_mlp(i))


def config() -> ArchConfig:
    block = tuple(_layer(i) for i in range(8))
    return ArchConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        d_model=D,
        vocab_size=65_536,
        stages=(Stage(block=block, repeat=9),),
        norm="rmsnorm",
        tie_embeddings=False,
        pos_emb="none",
        max_seq=524_288,
        sub_quadratic=True,  # 7/8 of layers are Mamba (O(1) state)
    )

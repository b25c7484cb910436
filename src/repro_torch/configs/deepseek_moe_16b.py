"""DeepSeekMoE-16B — fine-grained MoE: 2 shared + 64 routed top-6.

[arXiv:2401.06066] 28L, d_model=2048, 16H (MHA), expert d_ff=1408,
vocab=102400. Layer 0 is dense (d_ff=10944); layers 1-27 are MoE.
"""
from repro_torch.configs.base import (ArchConfig, AttnSpec, LayerSpec, MLPSpec,
                                MoESpec, Stage)

ATTN = AttnSpec(n_heads=16, n_kv_heads=16, head_dim=128, rope=True)


def config() -> ArchConfig:
    dense0 = LayerSpec(kind="attn", attn=ATTN,
                       mlp=MLPSpec(kind="dense", d_ff=10_944, act="swiglu"))
    moe = LayerSpec(
        kind="attn", attn=ATTN,
        mlp=MLPSpec(kind="moe", act="swiglu",
                    moe=MoESpec(n_experts=64, top_k=6, d_expert=1408,
                                n_shared=2)))
    return ArchConfig(
        name="deepseek-moe-16b",
        family="moe",
        d_model=2048,
        vocab_size=102_400,
        stages=(Stage(block=(dense0,), repeat=1),
                Stage(block=(moe,), repeat=27)),
        norm="rmsnorm",
        max_seq=16_384,
        sub_quadratic=False,
    )

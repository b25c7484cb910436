"""StableLM-2-12B — dense GQA. [hf:stabilityai/stablelm-2-*]

40L, d_model=5120, 32H (GQA kv=8), d_ff=13824, vocab=100352.
StableLM-2 uses LayerNorm (no bias) rather than RMSNorm.
"""
from repro_torch.configs.base import uniform_dense


def config():
    return uniform_dense(
        "stablelm-12b", "dense",
        n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
        d_ff=13_824, vocab=100_352,
        qkv_bias=False, rope_theta=10_000.0, act="swiglu",
        norm="layernorm", max_seq=16_384, sub_quadratic=False,
    )

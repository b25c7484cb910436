"""Qwen1.5-32B — dense, QKV bias. [hf:Qwen/Qwen1.5-*]

64L, d_model=5120, 40H (kv=40 per assignment), d_ff=27392, vocab=152064.
"""
from repro_torch.configs.base import uniform_dense


def config():
    return uniform_dense(
        "qwen1.5-32b", "dense",
        n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40,
        d_ff=27_392, vocab=152_064,
        qkv_bias=True, rope_theta=1_000_000.0, act="swiglu",
        norm="rmsnorm", max_seq=32_768, sub_quadratic=False,
    )

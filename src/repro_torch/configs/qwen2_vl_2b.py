"""Qwen2-VL-2B — VLM backbone only (vision frontend is a stub).

[arXiv:2409.12191] 28L, d_model=1536, 12H (GQA kv=2), d_ff=8960,
vocab=151936. M-RoPE is carried as standard RoPE on the text axis (the 3D
decomposition needs real image geometry, which the stub frontend does not
have) — see DESIGN.md adaptations. input_specs() supplies 256 precomputed
patch embeddings per sample.
"""
from repro_torch.configs.base import uniform_dense


def config():
    return uniform_dense(
        "qwen2-vl-2b", "vlm",
        n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
        d_ff=8960, vocab=151_936, head_dim=128,
        qkv_bias=True, rope_theta=1_000_000.0, act="swiglu",
        norm="rmsnorm", tie_embeddings=True,
        n_frontend=256, max_seq=32_768, sub_quadratic=False,
    )

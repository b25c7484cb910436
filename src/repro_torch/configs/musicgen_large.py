"""MusicGen-large — decoder-only over EnCodec tokens (codec frontend stubbed).

[arXiv:2306.05284] 48L, d_model=2048, 32H (MHA), d_ff=8192 (plain GELU MLP),
vocab=2048 (one EnCodec codebook stream). Sinusoidal positions (no RoPE).
64 precomputed conditioning embeddings stand in for the text encoder.
"""
from repro_torch.configs.base import uniform_dense


def config():
    return uniform_dense(
        "musicgen-large", "audio",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab=2048, head_dim=64,
        rope=False, act="gelu",
        norm="layernorm", pos_emb="sinusoidal",
        n_frontend=64, max_seq=32_768, sub_quadratic=False,
    )

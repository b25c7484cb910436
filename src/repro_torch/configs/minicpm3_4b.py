"""MiniCPM3-4B — dense with Multi-head Latent Attention (MLA).

[hf:openbmb/MiniCPM3-4B] 62L, d_model=2560, 40H, d_ff=6400, vocab=73448.
MLA dims follow the HF config: q_lora 768, kv_lora 256, qk_nope 64,
qk_rope 32, v_head 64.
"""
from repro_torch.configs.base import MLASpec, uniform_dense


def config():
    return uniform_dense(
        "minicpm3-4b", "dense",
        n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40,
        d_ff=6400, vocab=73_448,
        mla=MLASpec(q_lora_rank=768, kv_lora_rank=256, qk_nope_dim=64,
                    qk_rope_dim=32, v_head_dim=64),
        act="swiglu", norm="rmsnorm", tie_embeddings=True,
        max_seq=32_768, sub_quadratic=False,
    )

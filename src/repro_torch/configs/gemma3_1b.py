"""Gemma3-1B — dense, 5:1 local:global sliding-window. [hf:google/gemma-3-1b-pt]

26L, d_model=1152, 4H (GQA kv=1), head_dim=256, d_ff=6912 (geglu),
vocab=262144, local window 512. 26 = 4 x (5 local + 1 global) + 2 local.
"""
from repro_torch.configs.base import ArchConfig, Stage, dense_layer

D = 1152
LOCAL = dict(d_model=D, n_heads=4, n_kv_heads=1, d_ff=6912, head_dim=256,
             act="geglu", window=512, rope_theta=10_000.0)
GLOBAL = dict(LOCAL, window=None, rope_theta=1_000_000.0)


def config() -> ArchConfig:
    superblock = tuple(dense_layer(**LOCAL) for _ in range(5)) + (
        dense_layer(**GLOBAL),)
    tail = tuple(dense_layer(**LOCAL) for _ in range(2))
    return ArchConfig(
        name="gemma3-1b",
        family="dense",
        d_model=D,
        vocab_size=262_144,
        stages=(Stage(block=superblock, repeat=4), Stage(block=tail, repeat=1)),
        norm="rmsnorm",
        tie_embeddings=True,
        max_seq=524_288,  # 128k in the release; long_500k exercises window attn
        sub_quadratic=True,  # 5:1 sliding-window; single global layer data-sharded
        logit_softcap=30.0,
        scale_embed=True,
    )

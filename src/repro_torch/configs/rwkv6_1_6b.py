"""RWKV6 "Finch" 1.6B — attention-free, data-dependent decay.

[arXiv:2404.05892] 24L, d_model=2048, channel-mix d_ffn=7168, vocab=65536,
wkv head_dim=64 (32 heads).
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, MLPSpec, RWKVSpec, Stage


def config() -> ArchConfig:
    layer = LayerSpec(
        kind="rwkv",
        rwkv=RWKVSpec(head_dim=64, decay_lora=64, mix_lora=32, d_ffn=7168),
        mlp=MLPSpec(kind="none"),  # channel-mix lives inside the rwkv block
    )
    return ArchConfig(
        name="rwkv6-1.6b",
        family="ssm",
        d_model=2048,
        vocab_size=65_536,
        stages=(Stage(block=(layer,), repeat=24),),
        norm="layernorm",
        pos_emb="none",
        max_seq=524_288,
        sub_quadratic=True,  # recurrent: O(1) state per token
    )

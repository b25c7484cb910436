"""What the port's own builder makes of Mistral-Nemo-Base-2407
(hf:mistralai/Mistral-Nemo-Base-2407) at its published numbers, all 40
layers. ``test_configuration_is_the_ports`` holds the harness's mapping
of ``configs/mistral-nemo-12b.json`` (its family's ``port.arch_config``)
to it."""


def arch_config():
    from repro_torch.configs.base import uniform_dense
    return uniform_dense(
        "mistral-nemo-12b", "dense", n_layers=40, d_model=5120, n_heads=32,
        n_kv_heads=8, d_ff=14_336, vocab=131_072, head_dim=128,
        qkv_bias=False, rope_theta=1e6, act="swiglu", norm="rmsnorm",
        norm_eps=1e-5, tie_embeddings=False, max_seq=16_384)

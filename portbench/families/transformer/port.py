"""A transformer configuration file as the port's ``ArchConfig``: the
system under test takes its configuration in its own types."""
from __future__ import annotations

from portbench.families.transformer.layout import norm_eps, stages

# what the port implements; a configuration asking for more is refused
_PORT_FIXED = {"hidden_act": "silu", "partial_rotary_factor": 1.0,
               "qk_layernorm": False, "use_parallel_residual": False,
               "sliding_window": None, "scoring_func": "softmax",
               "norm_topk_prob": True}


def arch_config(cfg: dict):
    from repro_torch.configs.base import (ArchConfig, AttnSpec, LayerSpec,
                                          MLPSpec, MoESpec, Stage)
    for key, want in _PORT_FIXED.items():
        if key in cfg and cfg[key] != want:
            raise ValueError(f"{cfg['name']}: {key}={cfg[key]!r}; the port "
                             f"runs {key}={want!r} only")
    attn = AttnSpec(n_heads=cfg["num_attention_heads"],
                    n_kv_heads=cfg["num_key_value_heads"],
                    head_dim=cfg["head_dim"],
                    qkv_bias=bool(cfg.get("use_qkv_bias")), rope=True,
                    rope_theta=float(cfg["rope_theta"]))
    blocks = {
        "dense": LayerSpec(kind="attn", attn=attn, mlp=MLPSpec(
            kind="dense", d_ff=cfg["intermediate_size"], act="swiglu"))}
    if cfg.get("n_routed_experts"):
        blocks["moe"] = LayerSpec(kind="attn", attn=attn, mlp=MLPSpec(
            kind="moe", act="swiglu", moe=MoESpec(
                n_experts=cfg["n_routed_experts"],
                top_k=cfg["num_experts_per_tok"],
                d_expert=cfg["moe_intermediate_size"],
                n_shared=cfg.get("n_shared_experts", 0))))
    return ArchConfig(
        name=cfg["name"],
        family="moe" if cfg.get("n_routed_experts") else "dense",
        d_model=cfg["hidden_size"], vocab_size=cfg["vocab_size"],
        stages=tuple(Stage(block=(blocks[kind],), repeat=r)
                     for kind, r in stages(cfg)),
        norm=cfg["norm"], norm_eps=norm_eps(cfg),
        tie_embeddings=cfg["tie_word_embeddings"], max_seq=16_384)


def check_run_config(cfg: dict, rc) -> None:
    """Raise where the port's run configuration departs from what the
    configuration file states (the reference follows the file)."""
    want = cfg.get("capacity_factor")
    if want is not None and rc.capacity_factor != want:
        raise ValueError(f"{cfg['name']}: the port runs capacity_factor "
                         f"{rc.capacity_factor}, the configuration states "
                         f"{want}")

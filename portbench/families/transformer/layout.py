"""The parameter tree of a transformer configuration, in the port's names
and shapes (``repro_torch.models.transformer.init_params``), as a list of
leaves that ``portbench.weights`` fills from the seed.

Layers ``0 .. first_k_dense_replace - 1`` have dense MLPs and the rest
routed experts; each run of equal layers is one stage, and a stage of R > 1
layers stacks every leaf along a leading dim of R.
"""
from __future__ import annotations

VOCAB_PAD = 256  # the port pads the vocabulary to a multiple of this


def padded_vocab(cfg: dict) -> int:
    v = cfg["vocab_size"]
    return (v + VOCAB_PAD - 1) // VOCAB_PAD * VOCAB_PAD


def norm_eps(cfg: dict) -> float:
    return cfg["layer_norm_eps"] if cfg["norm"] == "layernorm" \
        else cfg["rms_norm_eps"]


def stages(cfg: dict) -> list:
    """[(kind, repeat)], kind "dense" or "moe", in layer order."""
    n = cfg["num_hidden_layers"]
    dense = min(cfg.get("first_k_dense_replace", n), n) \
        if cfg.get("n_routed_experts") else n
    out = [("dense", dense)] if dense else []
    if n > dense:
        out.append(("moe", n - dense))
    return out


def _norm(prefix, lead, d, kind):
    leaves = [(prefix + ("scale",), (*lead, d), "scale")]
    if kind == "layernorm":
        leaves.append((prefix + ("bias",), (*lead, d), "normal"))
    return leaves


def _mlp(prefix, lead, d, f):
    return [(prefix + ("w_gate",), (*lead, d, f), "normal"),
            (prefix + ("w_up",), (*lead, d, f), "normal"),
            (prefix + ("w_down",), (*lead, f, d), "normal")]


def leaves(cfg: dict) -> list:
    """[(path, shape, init)]: ``path`` a tuple of dict keys and list
    indices, ``init`` "normal" (std 0.02) or "scale" (1 + normal)."""
    d, h, hk, hd = (cfg["hidden_size"], cfg["num_attention_heads"],
                    cfg["num_key_value_heads"], cfg["head_dim"])
    vp = padded_vocab(cfg)
    out = [(("embed",), (vp, d), "normal")]
    out += _norm(("final_norm",), (), d, cfg["norm"])
    if not cfg["tie_word_embeddings"]:
        out.append((("lm_head",), (d, vp), "normal"))
    for i, (kind, repeat) in enumerate(stages(cfg)):
        lead = () if repeat == 1 else (repeat,)
        blk = ("stages", i, "L0")
        out += _norm(blk + ("ln1",), lead, d, cfg["norm"])
        out += _norm(blk + ("ln2",), lead, d, cfg["norm"])
        mix = blk + ("mixer",)
        out += [(mix + ("wq",), (*lead, d, h * hd), "normal"),
                (mix + ("wk",), (*lead, d, hk * hd), "normal"),
                (mix + ("wv",), (*lead, d, hk * hd), "normal"),
                (mix + ("wo",), (*lead, h * hd, d), "normal")]
        if cfg.get("use_qkv_bias"):
            out += [(mix + ("bq",), (*lead, h * hd), "normal"),
                    (mix + ("bk",), (*lead, hk * hd), "normal"),
                    (mix + ("bv",), (*lead, hk * hd), "normal")]
        mlp = blk + ("mlp",)
        if kind == "dense":
            out += _mlp(mlp, lead, d, cfg["intermediate_size"])
            continue
        e, f = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
        out += [(mlp + ("router",), (*lead, d, e), "normal"),
                (mlp + ("w_gate",), (*lead, e, d, f), "normal"),
                (mlp + ("w_up",), (*lead, e, d, f), "normal"),
                (mlp + ("w_down",), (*lead, e, f, d), "normal")]
        if cfg.get("n_shared_experts"):
            out += _mlp(mlp + ("shared",), lead, d,
                        cfg["n_shared_experts"] * f)
    return out

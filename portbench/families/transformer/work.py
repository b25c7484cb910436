"""The benchmark's own counts of a transformer's work, from the
configuration file alone: model FLOPs (two a multiply-add) and the least
bytes a kernel must move. They count what the model's equations need,
not what the program happens to launch, so a later change to the program
leaves them as they are.
"""
from __future__ import annotations

from portbench.families.transformer.layout import stages


def attn_dims(cfg):
    return (cfg["num_attention_heads"], cfg["num_key_value_heads"],
            cfg["head_dim"], cfg["head_dim"])


def active_params(cfg) -> int:
    """Weights of the layers' products one token runs through: attention
    projections, the dense MLP or the router, the k routed experts and
    the shared experts (no embedding, no head)."""
    d = cfg["hidden_size"]
    h, hk, hd, hv = attn_dims(cfg)
    attn = d * h * hd + 2 * d * hk * hd + h * hv * d
    total = 0
    for kind, repeat in stages(cfg):
        if kind == "dense":
            mlp = 3 * d * cfg["intermediate_size"]
        else:
            f = cfg["moe_intermediate_size"]
            mlp = d * cfg["n_routed_experts"] \
                + 3 * d * f * (cfg["num_experts_per_tok"]
                               + cfg.get("n_shared_experts", 0))
        total += repeat * (attn + mlp)
    return total


def head_params(cfg) -> int:
    return cfg["hidden_size"] * cfg["vocab_size"]


def attn_layers(cfg) -> int:
    return cfg["num_hidden_layers"]


def causal_pairs(s: int) -> int:
    """(query, key) pairs of causal attention over s positions."""
    return s * (s + 1) // 2


def flash_fwd(cfg, batch: int, seq: int, elem: int):
    """(FLOPs, bytes) of one causal attention forward over a layer's
    heads: Q K^T and P V over the causal pairs; q, k, v read and the
    output written once."""
    h, hk, hd, hv = attn_dims(cfg)
    flops = 2 * batch * h * causal_pairs(seq) * (hd + hv)
    nbytes = elem * batch * seq * (h * hd + hk * hd + hk * hv + h * hv)
    return flops, nbytes


def flash_bwd(cfg, batch: int, seq: int, elem: int):
    """(FLOPs, bytes) of its backward: dV = P^T dO, dP = dO V^T,
    dQ = dS K, dK = dS^T Q over the causal pairs (recomputing Q K^T is
    the kernel's choice and not counted); q, k, v, o, dO and the f32
    log-sum-exp read once, dq, dk, dv written once."""
    h, hk, hd, hv = attn_dims(cfg)
    flops = 2 * batch * h * causal_pairs(seq) * (2 * hd + 2 * hv)
    reads = batch * seq * (h * hd + hk * hd + hk * hv + 2 * h * hv) * elem \
        + batch * h * seq * 4
    writes = batch * seq * (h * hd + hk * hd + hk * hv) * elem
    return flops, reads + writes


def prefill_flops(cfg, sessions: int, prompt: int) -> int:
    """Model FLOPs of a prefill: every row through the layers, the head
    for each session's last row, causal attention."""
    return (2 * active_params(cfg) * sessions * prompt
            + 2 * head_params(cfg) * sessions
            + attn_layers(cfg) * flash_fwd(cfg, sessions, prompt, 2)[0])


def decode_flops(cfg, sessions: int, pos: int) -> int:
    """Model FLOPs of a decode step whose new token sits at ``pos``: the
    layers and the head for one row a session, attention over the pos + 1
    positions written so far."""
    h, _, hd, hv = attn_dims(cfg)
    return sessions * (2 * active_params(cfg) + 2 * head_params(cfg)
                       + attn_layers(cfg) * 2 * h * (pos + 1) * (hd + hv))


def train_flops(cfg, batch: int, seq: int) -> int:
    """Model FLOPs of a train step: forward and backward (3x the forward)
    of the layers and the head on every row, and of causal attention;
    recompute not counted."""
    fwd = (2 * (active_params(cfg) + head_params(cfg)) * batch * seq
           + attn_layers(cfg) * flash_fwd(cfg, batch, seq, 4)[0])
    return 3 * fwd

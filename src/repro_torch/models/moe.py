"""Mixture-of-Experts with scatter/gather capacity dispatch.

Port of ``repro/models/moe.py``. Tokens are routed within independent
groups (one sequence per group for prefill; ~16-token groups for decode),
each expert takes at most ``capacity`` tokens of a group, and a token's
assignment past its expert's capacity is dropped: its combine weight reads
the zero sentinel row E*C. Which assignments drop is decided by an
exclusive count over the group's token-major (token, k) assignments, as in
the JAX package, so the port drops the same ones.

The kept slots of a group are unique, so dispatch writes each one with a
plain indexed copy, not an atomic add: reruns are bit-identical, and the
host never waits for the device to count the kept ones. The expert
products are plain batched matmuls (``torch.einsum``), as the JAX package
leaves them to XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoESpec
from repro_torch.models.layers import _gelu, apply_mlp, init_mlp, normal_init


def init_moe(gen: torch.Generator, d_model: int, spec: MoESpec, act: str,
             dtype, device, lead=()) -> dict:
    e, f = spec.n_experts, spec.d_expert
    p = {
        "router": normal_init(gen, (*lead, d_model, e), dtype, device),
        "w_gate": normal_init(gen, (*lead, e, d_model, f), dtype, device),
        "w_up": normal_init(gen, (*lead, e, d_model, f), dtype, device),
        "w_down": normal_init(gen, (*lead, e, f, d_model), dtype, device),
    }
    if spec.n_shared:
        p["shared"] = init_mlp(gen, d_model, spec.n_shared * f, act, dtype,
                               device, lead)
    return p


def _capacity(group_size: int, spec: MoESpec, factor: float) -> int:
    c = int(group_size * spec.top_k * factor / spec.n_experts) + 1
    return max(1, min(c, group_size * spec.top_k))


def _route(logits: torch.Tensor, spec: MoESpec, capacity: int):
    """Route every group. logits: (G, Sg, E).

    Returns (slot (G, Sg*k) with E*C for a dropped assignment,
    gates (G, Sg*k) f32, aux (G,))."""
    g, sg, e = logits.shape
    k = spec.top_k
    probs = torch.softmax(logits.float(), dim=-1)
    # lax.top_k: the larger first, the lower index first among equals
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[..., :k], top_i[..., :k]
    gates = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

    flat_e = top_i.reshape(g, sg * k)  # token-major (token, k) order
    onehot = F.one_hot(flat_e, e)  # (G, Sg*k, E)
    pos = onehot.cumsum(dim=1) - onehot  # exclusive count per expert
    mypos = pos.gather(2, flat_e[..., None])[..., 0]
    slot = torch.where(mypos < capacity, flat_e * capacity + mypos,
                       e * capacity)

    # load-balance aux loss (Switch-style): E * sum_e f_e * P_e
    frac = onehot.sum(dim=1).float() / (sg * k)
    aux = e * (frac * probs.mean(dim=1)).sum(-1)
    return slot, gates.reshape(g, sg * k), aux


def apply_moe(params: dict, x: torch.Tensor, spec: MoESpec, act: str, *,
              n_groups: int, capacity_factor: float = 1.25):
    """x: (B, S, d) -> (out, aux_loss). Groups = reshaped (B*S)/n_groups."""
    b, s, d = x.shape
    tokens = b * s
    if tokens % n_groups:
        raise ValueError(f"apply_moe: {tokens} tokens do not split into "
                         f"{n_groups} groups")
    sg = tokens // n_groups
    e, k = spec.n_experts, spec.top_k
    cap = _capacity(sg, spec, capacity_factor)
    xg = x.reshape(n_groups, sg, d)
    logits = xg @ params["router"].to(xg.dtype)
    slot, gates, aux = _route(logits, spec, cap)

    # dispatch: the kept slots are unique, so a plain indexed copy writes
    # each one once; dropped assignments all land on the sentinel row E*C,
    # whose contents are discarded
    rows = e * cap + 1
    idx = slot + rows * torch.arange(n_groups, device=x.device)[:, None]
    x_rep = xg.repeat_interleave(k, dim=1)  # (G, Sg*k, d)
    buf = x.new_zeros((n_groups * rows, d)).index_copy_(
        0, idx.reshape(-1), x_rep.reshape(-1, d))
    expert_in = buf.reshape(n_groups, rows, d)[:, :-1].reshape(
        n_groups, e, cap, d)

    gate_w = params["w_gate"].to(x.dtype)
    up_w = params["w_up"].to(x.dtype)
    down_w = params["w_down"].to(x.dtype)
    hg = torch.einsum("gecd,edf->gecf", expert_in, gate_w)
    hu = torch.einsum("gecd,edf->gecf", expert_in, up_w)
    inner = {"swiglu": F.silu, "geglu": _gelu}[act]
    h = inner(hg.float()).to(x.dtype) * hu
    out_buf = torch.einsum("gecf,efd->gecd", h, down_w)

    # combine: a dropped assignment reads the zero sentinel row E*C
    out_flat = torch.cat([out_buf.reshape(n_groups, e * cap, d),
                          x.new_zeros((n_groups, 1, d))], dim=1)
    gathered = out_flat.gather(1, slot[..., None].expand(-1, -1, d))
    y = (gathered * gates[..., None].to(x.dtype)).reshape(
        n_groups, sg, k, d).sum(dim=2)
    y = y.reshape(b, s, d)

    if spec.n_shared:
        y = y + apply_mlp(params["shared"], x, act)
    return y, aux.mean()


def default_groups(batch: int, seq: int, mode: str) -> int:
    """Dispatch-group policy: per-sequence groups for prefill; ~16-token
    groups for decode (keeps capacity-padding waste bounded)."""
    if mode == "decode" or seq == 1:
        return max(1, batch // 16)
    return batch

"""AdamW on trees of tensors (f32 moments).

Port of ``repro/optim/adamw.py``. Parameters, gradients and moments are
nested dicts and lists of tensors with the parameters' structure; the step
is a 0-d int32 tensor, as in the JAX package. Every cast happens where the
reference casts: the moments and the update are computed in f32 and the
new parameter is cast back to its own dtype. ``adamw_update`` writes the
new parameters and moments into the given ones, leaf by leaf, as the JAX
train step donates its parameter and optimizer buffers to XLA: a step
then holds the train state once, not twice (musicgen-large's whole
38.8 GB state would not fit twice on an 80 GB card).

On DTensors (a step laid out over a mesh by ``launch/sharding.py``) the
moments keep ``opt_shardings``' layout: each gradient is first laid out
as its moments (under ZeRO-1, a reduce-scatter of the gradient onto the
TP-sharded moments), the update is computed there, and the new parameter
is laid out as the parameter before the in-place write (under ZeRO-1 the
all-gather of the update); an in-place op cannot change a DTensor's
placements. Without a mesh nothing is redistributed.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.distributed.tensor import DTensor

from repro_torch.weights import tree_leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def adamw_init(params) -> dict:
    def zeros(p):
        return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                              device=x.device), p)
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return {"m": zeros(params), "v": zeros(params), "step": step}


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def _clip_scale(grads, max_norm: float):
    """Returns (the factor that scales ``grads`` to a global norm of at most
    ``max_norm``, the global norm)."""
    leaves = tree_leaves(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0), gn


def clip_by_global_norm(grads, max_norm: float):
    """Returns (grads scaled to a global norm of at most ``max_norm``,
    the global norm before scaling)."""
    scale, gn = _clip_scale(grads, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def _as_moment(t, m):
    """``t`` laid out as its moment ``m`` (a DTensor), else unchanged."""
    if isinstance(t, DTensor) and isinstance(m, DTensor):
        return t.redistribute(m.device_mesh, m.placements)
    return t


def adamw_update(cfg: AdamWConfig, grads, opt_state, params):
    """Returns (new_params, new_opt_state, grad_norm). The new parameters
    and moments are written into ``params`` and ``opt_state``'s, which are
    returned (the step is a new tensor); each leaf is clipped, moved and
    updated in turn, with the reference's arithmetic."""
    grads = tree_map(_as_moment, grads, opt_state["m"])
    scale, gnorm = _clip_scale(grads, cfg.grad_clip)
    step = opt_state["step"] + 1
    lr = _schedule(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()

    def upd(p, g, m, v):
        gf = (g.float() * scale).to(g.dtype).float()
        pf = _as_moment(p.float(), m)
        m.mul_(cfg.b1).add_((1 - cfg.b1) * gf)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(gf))
        mhat = m / b1c
        vhat = v / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * pf
        new = (pf - lr * delta).to(p.dtype)
        if isinstance(p, DTensor):  # ZeRO-1: the all-gather of the update
            new = new.redistribute(p.device_mesh, p.placements)
        p.copy_(new)

    tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
    return params, {"m": opt_state["m"], "v": opt_state["v"],
                    "step": step}, gnorm

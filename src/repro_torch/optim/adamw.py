"""AdamW on trees of tensors (f32 moments).

Port of ``repro/optim/adamw.py``. Parameters, gradients and moments are
nested dicts and lists of tensors with the parameters' structure; the step
is a 0-d int32 tensor, as in the JAX package. Every cast happens where the
reference casts: the moments and the update are computed in f32 and the
new parameter is cast back to its own dtype.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

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


def clip_by_global_norm(grads, max_norm: float):
    """Returns (grads scaled to a global norm of at most ``max_norm``,
    the global norm before scaling)."""
    leaves = tree_leaves(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def adamw_update(cfg: AdamWConfig, grads, opt_state, params):
    """Returns (new_params, new_opt_state, grad_norm)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = opt_state["step"] + 1
    lr = _schedule(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()

    m_new = tree_map(lambda g, m: cfg.b1 * m + (1 - cfg.b1) * g.float(),
                     grads, opt_state["m"])
    v_new = tree_map(lambda g, v: cfg.b2 * v + (1 - cfg.b2) * torch.square(
        g.float()), grads, opt_state["v"])

    def upd(p, m, v):
        mhat = m / b1c
        vhat = v / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + \
            cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype)

    return tree_map(upd, params, m_new, v_new), {
        "m": m_new, "v": v_new, "step": step}, gnorm

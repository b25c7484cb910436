"""Carry the JAX package's parameters and caches into the port.

The caller hands in the JAX pytree as numpy arrays (for example
``jax.tree.map(np.asarray, init_params(...))``); this module never imports
JAX. The nested dict/list structure is kept as it is, so every leaf keeps
its ``repro.ckpt.checkpoint._flatten`` name (``/stages/0/L0/mixer/wq``).
A train state (``{"params", "opt": {"m", "v", "step"}}``) crosses the same
way; its 0-d int32 ``step`` stays a 0-d int32 tensor.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import device as device_mod


def leaf_to_tensor(a, device: torch.device) -> torch.Tensor:
    """One numpy leaf (or a tensor) as a tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.asarray(a)
    # ml_dtypes.bfloat16 (JAX's leaves), or the raw V2 words of a bf16
    # checkpoint leaf: the same bits
    if a.dtype.name == "bfloat16" or a.dtype == np.dtype("V2"):
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def tree_map(fn, *trees) -> Any:
    """``fn`` over the leaves of trees that share the first one's nested
    dict/list structure (a tuple is walked as a list)."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return [tree_map(fn, *(t[i] for t in trees)) for i in range(len(t0))]
    return fn(*trees)


def tree_leaves(tree: Any) -> list:
    """The leaves in ``tree_map``'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(template: Any, leaves) -> Any:
    """A tree shaped like ``template`` whose leaves are ``leaves``, in
    ``tree_leaves`` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


def tree_to_torch(tree: Any, device) -> Any:
    device = device_mod.resolve(device)
    return tree_map(lambda a: leaf_to_tensor(a, device), tree)


def params_from_jax(tree_of_numpy: Any, device="cuda") -> Any:
    """The JAX package's parameters (numpy leaves) as the port's tensors."""
    return tree_to_torch(tree_of_numpy, device)


def caches_from_jax(tree_of_numpy: Any, device="cuda") -> Any:
    """The JAX package's KV caches (numpy leaves) as the port's tensors."""
    return tree_to_torch(tree_of_numpy, device)

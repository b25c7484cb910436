"""Carry the JAX package's parameters and caches into the port.

The caller hands in the JAX pytree as numpy arrays (for example
``jax.tree.map(np.asarray, init_params(...))``); this module never imports
JAX. The nested dict/list structure is kept as it is, so every leaf keeps
its ``repro.ckpt.checkpoint._flatten`` name (``/stages/0/L0/mixer/wq``).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import device as device_mod


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    # ml_dtypes.bfloat16 (JAX's leaves), or the raw V2 words of a bf16
    # checkpoint leaf: the same bits
    if a.dtype.name == "bfloat16" or a.dtype == np.dtype("V2"):
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def tree_to_torch(tree: Any, device) -> Any:
    device = device_mod.resolve(device)
    if isinstance(tree, dict):
        return {k: tree_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to_torch(v, device) for v in tree]
    return _tensor(tree, device)


def params_from_jax(tree_of_numpy: Any, device="cuda") -> Any:
    """The JAX package's parameters (numpy leaves) as the port's tensors."""
    return tree_to_torch(tree_of_numpy, device)


def caches_from_jax(tree_of_numpy: Any, device="cuda") -> Any:
    """The JAX package's KV caches (numpy leaves) as the port's tensors."""
    return tree_to_torch(tree_of_numpy, device)

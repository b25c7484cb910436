"""Gradient compression for the data-parallel all-reduce.

Port of ``repro/optim/compress.py``: int8 block quantization with error
feedback. Each gradient leaf, plus the residual carried from the previous
step, is cut into blocks of ``block`` elements (the last one zero-padded);
each block is scaled by its largest magnitude over 127 and rounded half
to even to int8. What the rounding lost is the next step's residual, so
the prefix of applied updates stays unbiased. The trees are the port's
nested dicts and lists of tensors (``repro_torch.weights``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.weights import tree_map


@dataclass(frozen=True)
class CompressionConfig:
    enabled: bool = False
    block: int = 256  # quantization block size
    dtype: str = "int8"


def init_error_state(params):
    """A zero f32 residual shaped like each leaf, whatever its dtype."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _quant_leaf(g, err, block):
    """Returns (q (n_blocks, block) int8, scale (n_blocks, 1) f32, the new
    f32 residual shaped like ``g``, ``g``'s shape)."""
    gf = g.float() + err
    flat = gf.reshape(-1)
    n = flat.shape[0]
    fp = F.pad(flat, (0, (-n) % block)).reshape(-1, block)
    scale = fp.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(fp / scale), -127, 127).to(torch.int8)
    deq = (q.float() * scale).reshape(-1)[:n].reshape(g.shape)
    return q, scale, gf - deq, g.shape


def compress_grads(grads, err_state, cfg: CompressionConfig):
    """Returns (wire tree {"q", "scale"}, the new error state)."""
    # walked along ``grads``, so _quant_leaf's tuples are leaves of ``out``
    out = tree_map(lambda g, e: _quant_leaf(g, e, cfg.block), grads,
                   err_state)
    wire = {"q": tree_map(lambda _, o: o[0], grads, out),
            "scale": tree_map(lambda _, o: o[1], grads, out)}
    return wire, tree_map(lambda _, o: o[2], grads, out)


def decompress_grads(wire, shapes_like):
    """The f32 gradients, shaped like the leaves of ``shapes_like``."""
    def deq(q, s, ref):
        return (q.float() * s).reshape(-1)[:ref.numel()].reshape(ref.shape)
    return tree_map(deq, wire["q"], wire["scale"], shapes_like)

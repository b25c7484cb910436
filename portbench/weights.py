"""Weights made on the device from the seed, in the type they are served
or trained in: every leaf is a view of one flat buffer that a device
generator fills in a few large calls, normal with std 0.02 ("normal":
products, embeddings, biases) or 1 plus that ("scale": norm scales), so
that every norm's affine part is exercised. The same seed and layout give
the same bits."""
from __future__ import annotations

import math

import torch

from portbench import seeds

STD = 0.02
CHUNK = 1 << 30  # elements a call of the generator fills


def _set(tree, path, value):
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(key, int):
            while len(node) <= key:
                node.append({})
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    node[path[-1]] = value


def make(leaves, dtype, seed: int, device) -> dict:
    """The parameter tree of ``leaves`` ([(path, shape, init)]) on
    ``device`` in ``dtype``."""
    total = sum(math.prod(s) for _, s, _ in leaves)
    flat = torch.empty(total, dtype=dtype, device=device)
    gen = seeds.generator(seed, device, "weights")
    for start in range(0, total, CHUNK):
        flat[start:start + CHUNK].normal_(0.0, STD, generator=gen)
    tree: dict = {}
    offset = 0
    for path, shape, init in leaves:
        n = math.prod(shape)
        leaf = flat[offset:offset + n].view(shape)
        offset += n
        if init == "scale":
            leaf.add_(1.0)
        _set(tree, path, leaf)
    return tree


def named(tree, prefix="") -> dict:
    """{"/a/0/b": leaf} of a nested dict and list tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for key, sub in items:
        out.update(named(sub, f"{prefix}/{key}"))
    return out

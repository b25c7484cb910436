"""Tiny versions of the benchmark's cells for the CPU tests: the cell's
configuration and traffic with every size cut, its check and its
limits as they stand. Nothing of a real run uses them."""
from __future__ import annotations

import dataclasses

from portbench import manifest

TINY_WIDTHS = {"hidden_size": 64, "num_hidden_layers": 3,
               "num_attention_heads": 4, "head_dim": 16,
               "intermediate_size": 96, "vocab_size": 512,
               "moe_intermediate_size": 32, "n_routed_experts": 8,
               "num_experts_per_tok": 2, "n_shared_experts": 1}
TINY_TRAFFIC = {"sessions": 4, "prompt_len": 16, "gen": 8, "batch": 2,
                "seq_len": 32}


def config(cfg: dict, dtype=None) -> dict:
    out = dict(cfg)
    for key, value in TINY_WIDTHS.items():
        if key in cfg:
            out[key] = value
    # the model's width over its query heads' as published (5/4 at nemo)
    out["hidden_size"] = 64 * cfg["hidden_size"] // (
        cfg["num_attention_heads"] * cfg["head_dim"])
    kv = cfg["num_key_value_heads"]
    out["num_key_value_heads"] = 4 if kv == cfg["num_attention_heads"] else 2
    if dtype:
        out["dtype"] = dtype
    return out


def cell(name: str, dtype=None, limits=None) -> manifest.Cell:
    """The cell ``name`` of BENCHMARK.json at the tiny sizes; ``dtype``
    and ``limits`` replace the configuration's and the check's."""
    c = manifest.cell(manifest.benchmark(), name)
    spec = dict(c.spec, check=dict(c.spec["check"]))
    if limits:
        spec["check"]["limits"] = limits
    return dataclasses.replace(
        c, config=config(c.config, dtype), spec=spec,
        traffic={k: TINY_TRAFFIC.get(k, v) for k, v in c.traffic.items()})

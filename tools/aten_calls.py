#!/usr/bin/env python3
"""Count the aten calls of one serve or train step of the port, on the
meta device (no card, nothing allocated).

A step whose device work is small against the host's cost per call is
host-bound; this count says how many calls the host dispatches a step.

    PYTHONPATH=src python tools/aten_calls.py --arch deepseek-moe-16b \\
        --kind decode --dtype bfloat16

Prints one JSON line: the arch, the step, the total and the most frequent
ops with their counts. Views (``view``, ``select``, ``permute``, ...)
are counted too: each is a dispatch, though none launches a kernel.
"""
from __future__ import annotations

import argparse
import collections
import json

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_config
from repro_torch.launch import serve, train
from repro_torch.models import transformer as tf
from repro_torch.weights import tree_leaves


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.calls = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def count(cfg, rc, kind: str, batch: int, seq: int) -> collections.Counter:
    """The aten calls of one ``kind`` step ("prefill", "decode" at position
    ``seq`` against a cache of ``seq`` + 1, or "train", forward and
    backward) of ``cfg`` at ``batch`` x ``seq``."""
    meta = torch.device("meta")
    params = tf.init_params(cfg, torch.Generator(), rc, device=meta)
    mode = _Count()
    if kind == "train":
        toks = torch.zeros((batch, seq), dtype=torch.int64, device=meta)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        with mode:
            loss, _ = tf.loss_fn(cfg, rc, params, {"tokens": toks,
                                                   "labels": toks})
            torch.autograd.grad(loss, leaves)
        return mode.calls
    caches = tf.init_cache(cfg, batch, seq + 1, rc, device=meta)
    with mode:
        if kind == "prefill":
            toks = torch.zeros((batch, seq), dtype=torch.int64, device=meta)
            tf.prefill(cfg, params, toks, caches, rc)
        else:
            toks = torch.zeros((batch, 1), dtype=torch.int64, device=meta)
            tf.decode_step(cfg, params, toks, seq, caches, rc)
    return mode.calls


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-moe-16b")
    ap.add_argument("--kind", default="decode",
                    choices=["prefill", "decode", "train"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=sorted(serve.DTYPES))
    args = ap.parse_args(argv)
    rc = train.RUN_CONFIG if args.kind == "train" else serve.run_config(
        serve.DTYPES[args.dtype])
    calls = count(get_config(args.arch), rc, args.kind, args.batch,
                  args.seq)
    print(json.dumps({"arch": args.arch, "kind": args.kind,
                      "batch": args.batch, "seq": args.seq,
                      "dtype": str(rc.param_dtype).split(".")[-1],
                      "aten_calls": sum(calls.values()),
                      "top": calls.most_common(12)}))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Serving times of checkouts of the PyTorch port, alternated on one GPU.

    python3 tools/serve_ab.py --rounds 3 OLD_CHECKOUT NEW_CHECKOUT
    python3 tools/serve_ab.py OLD NEW OLD+cublas NEW+cublas

Each round runs every checkout once, in an order rotated by one each round,
each run in a process of its own. A run serves ``chip_smoke.py``'s two
configurations the way its serve phase does (gemma3-1b at full width in
f32, and the first 4 layers of Jamba-1.5-Large's superblock in bf16: batch
4, prompt 1024, 32 tokens, a delta snapshot every 8 tokens and a node kill
at 20; then uninterrupted; then without snapshots) through that
checkout's own ``repro_torch.launch.serve``, after building its kernels.
A checkout named with ``+cublas`` runs with
``CUBLAS_WORKSPACE_CONFIG=:4096:8``, the setting ``chip_smoke.py`` makes
for its train phase. Prints one JSON line a run: the kill run's prefill s
(the process's first, so cold), loop s, snapshot s and decode ms a step,
the uninterrupted run's prefill s (warm), and decode ms a step without
snapshots, per configuration.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

ARGS = ["--batch", "4", "--prompt-len", "1024", "--gen", "32",
        "--snapshot-every", "8", "--seed", "0"]
CUBLAS = ":4096:8"


def run_one(checkout: Path) -> dict:
    sys.path.insert(0, str(checkout / "src"))
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import Stage
    from repro_torch.kernels import _build
    from repro_torch.launch import serve

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    jamba = get_config("jamba-1.5-large-398b")
    cut = dataclasses.replace(jamba, stages=(
        Stage(block=jamba.stages[0].block[:4], repeat=1),))
    out = {}
    for label, cfg, extra in (
            ("gemma3-1b", get_config("gemma3-1b"), []),
            ("jamba-4", cut, ["--dtype", "bfloat16"])):
        runs = []
        for more in (["--inject-failure", "20"], [],
                     ["--snapshot-every", "0"]):
            runs.append(serve.main(ARGS + extra + more, cfg=cfg)[1])
            torch.cuda.empty_cache()
        kill, ref, bare = runs
        # the kill run's prefill is the process's first (cold)
        out[label] = {"prefill_s": kill["prefill_s"],
                      "warm_prefill_s": ref["prefill_s"],
                      "loop_s": kill["decode_s"],
                      "snapshot_s": kill["snapshot_s"],
                      "decode_step_ms": kill["decode_step_ms"],
                      "bare_decode_step_ms": bare["decode_step_ms"]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--run", help=argparse.SUPPRESS)
    ap.add_argument("checkouts", nargs="*")
    args = ap.parse_args()
    if args.run:
        print(json.dumps(run_one(Path(args.run).resolve())), flush=True)
        return 0
    order = list(args.checkouts)
    for r in range(args.rounds):
        for name in order[r % len(order):] + order[:r % len(order)]:
            path, _, flag = name.partition("+")
            env = {k: v for k, v in os.environ.items()
                   if k != "CUBLAS_WORKSPACE_CONFIG"}
            if flag == "cublas":
                env["CUBLAS_WORKSPACE_CONFIG"] = CUBLAS
            proc = subprocess.run(
                [sys.executable, __file__, "--run", path], env=env,
                capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
                return proc.returncode
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            print(json.dumps({"round": r, "checkout": name, **res}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

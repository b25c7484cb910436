#!/usr/bin/env python3
"""gemma3-1b's whole-model train step in checkouts of the PyTorch port,
alternated on one GPU.

    python3 tools/train_ab.py OLD_CHECKOUT NEW NEW OLD

Runs each named checkout (a directory with ``src/repro_torch``) once, in
the order given, each in a process of its own with
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (the train step's deterministic
cuBLAS). A run builds that checkout's flash kernels and trains all 26
layers of gemma3-1b at f32, batch 4, sequence 1024, without checkpoints,
through ``repro_torch.launch.train.main``: once for 1 step and once for 6.
Prints one JSON line a run: the mean step ms of each (``step_ms`` counts
every step, the first with its warm-up), the steady step ms that the two
imply, (6 x the 6-step mean - the 1-step mean) / 5, and the peak GB.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path


def run_one(checkout: Path) -> dict:
    sys.path.insert(0, str(checkout / "src"))
    import torch

    from repro_torch.kernels import _build
    from repro_torch.launch import train
    _build.build(["flash_attention", "flash_attention_bwd"])
    out = {}
    for steps in (1, 6):
        _, stats = train.main(["--arch", "gemma3-1b", "--batch", "4",
                               "--seq", "1024", "--lr", "1e-3", "--steps",
                               str(steps), "--ckpt-every", "0"])
        out[f"step_ms_{steps}"] = stats["step_ms"]
        torch.cuda.empty_cache()
    out["steady_ms"] = (6 * out["step_ms_6"] - out["step_ms_1"]) / 5
    out["peak_gb"] = stats["peak_bytes"] / 1e9
    return out


def main(argv) -> int:
    if argv[:1] == ["--run"]:
        print(json.dumps(run_one(Path(argv[1]).resolve())), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    for i, name in enumerate(argv):
        proc = subprocess.run([sys.executable, __file__, "--run", name],
                              capture_output=True, text=True, env=env,
                              timeout=900)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            return proc.returncode
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"run": i, "checkout": name, **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

#!/usr/bin/env python3
"""Where rwkv6-1.6b's time goes on one GPU: a prefill and a train step,
traced with ``torch.profiler``.

    python3 tools/rwkv_trace.py

Full width and depth (24 layers, d_model 2048, 32 wkv heads of 64), f32,
random weights from seed 0, batch 4 x 1024 tokens, wkv chunks of 16 as the
serve and train entry points use. Each part runs once to warm up, then
once timed on the host clock and once under the profiler, with every call of
``models.ssm._rwkv_chunk`` (the plain wkv chunk) wrapped in a
``record_function("wkv_chunk")``. Prints the card's name and power limit,
then one JSON line a part: its wall ms unprofiled and profiled, the
device's busy ms (the sum of every kernel's device time; the annotation's
own device range is not a kernel) and idle share of the profiled wall,
the chunk's calls, its host ms and their share of the profiled wall, the
device ms of the kernels it launched (the forward's; in the train step
the recompute's too, but not the backward's, which autograd runs outside
the annotation), and the five kernels with the most device time.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the deterministic train step's cuBLAS setting, before the first product
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


def trace(torch, call) -> dict:
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        traced = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type.name == "CUDA"
               and e.key != "wkv_chunk"]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    chunk = next(e for e in events if e.key == "wkv_chunk"
                 and e.device_type.name == "CPU")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return {"wall_ms": wall, "profiled_wall_ms": traced,
            "device_busy_ms": busy, "idle_share": 1 - busy / traced,
            "wkv_chunk_calls": chunk.count,
            "wkv_chunk_host_ms": chunk.cpu_time_total / 1e3,
            "wkv_chunk_host_share": chunk.cpu_time_total / 1e3 / traced,
            "wkv_chunk_device_ms": chunk.device_time_total / 1e3,
            "top_kernels": [[e.key[:80], e.self_device_time_total / 1e3]
                            for e in top]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("rwkv_trace: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.launch.train import deterministic, make_train_step
    from repro_torch.models import ssm
    from repro_torch.models.transformer import Model, RunConfig
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    real = ssm._rwkv_chunk

    def annotated(*args):
        with torch.profiler.record_function("wkv_chunk"):
            return real(*args)
    ssm._rwkv_chunk = annotated

    cfg = get_config("rwkv6-1.6b")
    rc = RunConfig(param_dtype=torch.float32, cache_dtype=torch.float32,
                   loss_chunk=64, rwkv_chunk=16)
    model = Model(cfg, rc, "cuda")
    params = model.init(0)
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (4, 1025), generator=gen).cuda()

    def prefill():
        model.prefill(params, toks[:, :1024], model.init_cache(4, 1024))
    print(json.dumps({"part": "prefill 4x1024", **trace(torch, prefill)}),
          flush=True)

    step_fn = make_train_step(cfg, rc, AdamWConfig(lr=1e-3, warmup_steps=5))
    state = {"params": params, "opt": adamw_init(params)}
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def step():
        state["params"], state["opt"], _ = step_fn(state["params"],
                                                   state["opt"], batch)
    with deterministic():
        line = trace(torch, step)
    print(json.dumps({"part": "train step 4x1024", **line,
                      "peak_bytes": torch.cuda.max_memory_allocated()}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

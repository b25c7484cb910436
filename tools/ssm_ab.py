#!/usr/bin/env python3
"""The selective-scan kernels of checkouts of the PyTorch port, alternated
on one GPU.

    python3 tools/ssm_ab.py OLD_CHECKOUT NEW NEW OLD

Runs each named checkout once, in the order given, each in a process of
its own (a checkout is a directory with ``src/repro_torch``). A run builds
that checkout's ``ssm_scan`` kernel, and ``ssm_scan_bwd`` where it has
one, and times them at Jamba's train and prefill shape (f32, B=4, S=1024,
D=16384, N=16; decays exp(-uniform(0, 0.5))): the forward as serving calls
it (``ops.ssm_scan`` without a gradient) and, where the checkout has the
backward, the forward keeping its boundary states, the backward, and each
of the backward's two kernels by name with ``torch.profiler`` (device time
summed over 10 calls, divided by 10). Times are CUDA-event medians of 20
runs after a warm-up. Prints one JSON line a run, with the ``ptxas``
registers and spills of the checkout's scan kernels.
"""
from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REPS = 20


def time_ms(torch, fn) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_ms(torch, call, calls=10) -> dict:
    """Device ms of each kernel of one ``call()``."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    times = {}
    for ev in prof.key_averages():
        m = re.search(r"ssm_scan_bwd_\w+", ev.key)
        if m:
            times[m.group()] = ev.self_device_time_total / 1e3 / calls
    return times


def run_one(checkout: Path) -> dict:
    sys.path.insert(0, str(checkout / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import ssm_scan as ssm

    has_bwd = hasattr(ssm, "ssm_scan_bwd_cuda")
    names = ["ssm_scan"] + (["ssm_scan_bwd"] if has_bwd else [])
    _build.build(names)
    dev = torch.device("cuda")
    b, s, d, n = 4, 1024, 16384, 16
    gen = torch.Generator(device=dev).manual_seed(s)
    decay = torch.rand((b, s, d, n), generator=gen, device=dev)
    decay = decay.mul_(-0.5).exp_()
    u = torch.randn((b, s, d, n), generator=gen, device=dev)
    c = torch.randn((b, s, n), generator=gen, device=dev)
    s0 = torch.randn((b, d, n), generator=gen, device=dev)
    out = {"forward_ms": time_ms(torch, lambda: ops.ssm_scan(decay, u, c,
                                                             s0))}
    if has_bwd:
        dy = torch.randn((b, s, d), generator=gen, device=dev)
        out["forward_kept_ms"] = time_ms(torch, lambda: ssm.ssm_scan_cuda(
            decay, u, c, s0, with_bounds=True))
        _, _, bounds = ssm.ssm_scan_cuda(decay, u, c, s0, with_bounds=True)

        def bwd():
            return ssm.ssm_scan_bwd_cuda(decay, u, c, bounds, dy)
        out["backward_ms"] = time_ms(torch, bwd)
        out["kernel_ms"] = kernel_ms(torch, bwd)
    out["ptxas"] = []
    for name in names:
        log = _build.library_path(name).with_suffix(".log")
        out["ptxas"] += chip_smoke.ptxas_usage(log.read_text())
    return out


def main(argv) -> int:
    if argv[:1] == ["--run"]:
        print(json.dumps(run_one(Path(argv[1]).resolve())), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    for i, name in enumerate(argv):
        proc = subprocess.run([sys.executable, __file__, "--run", name],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            return proc.returncode
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"run": i, "checkout": name, **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

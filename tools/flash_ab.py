#!/usr/bin/env python3
"""The flash-attention kernels of checkouts of the PyTorch port,
alternated on one GPU.

    python3 tools/flash_ab.py OLD_CHECKOUT NEW NEW OLD

Runs each named checkout once, in the order given, each in a process of
its own (a checkout is a directory with ``src/repro_torch``). A run builds
that checkout's ``flash_attention`` and ``flash_attention_bwd`` kernels
and runs this repository's ``chip_smoke.py`` ``flash`` phase on them (the
forward at gemma3-1b's and Jamba's prefill shapes, f32 and bf16). Where
the checkout's backward takes the forward's lse, as this one's does, it
also runs the ``flash_bwd`` phase (gemma3-1b's train shapes: f32, B=4,
H=4, Hk=1, S=1024, D=256, window 512 and none, and S=1000 with window
512) and times each kernel of one backward call by name with
``torch.profiler`` (device time summed over 10 calls, divided by 10).
Kernel, plain and SDPA ms are CUDA-event medians; each forward case also
carries its kernels' device ms (``torch.profiler``). Prints one JSON line a
run: the cases, the backward's per-kernel ms at S=1024 for each window,
the host microseconds a forward call takes to return at gemma3-1b's
window-512 shape in f32 and bf16, and the ``ptxas`` registers and spills
of the backward's kernels. The
phases take their bounds from the checkout's ``repro_torch.roofline`` rates
and its kernel module's ``work`` functions, so a checkout must have both.
"""
from __future__ import annotations

import inspect
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def kernel_ms(torch, flash, window, calls=10) -> dict:
    """Device ms of each kernel in one backward call at S=1024."""
    from torch.profiler import ProfilerActivity, profile
    dev = torch.device("cuda")
    b, h, hk, s, d = 4, 4, 1, 1024, 256
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device=dev)
               for shape in ((b, h, s, d), (b, hk, s, d), (b, hk, s, d)))
    dout = torch.randn((b, h, s, d), generator=gen, device=dev)
    out, lse = flash.flash_attention_cuda(q, k, v, causal=True,
                                          window=window, scale=None,
                                          with_lse=True)

    def call():
        return flash.flash_attention_bwd_cuda(q, k, v, out, dout, lse,
                                              causal=True, window=window,
                                              scale=None)
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    times = {}
    for ev in prof.key_averages():
        m = re.search(r"flash_bwd_\w+", ev.key)
        if m:
            times[m.group()] = ev.self_device_time_total / 1e3 / calls
    return times


def forward_host_us(torch, ops, calls=50) -> dict:
    """Host microseconds a call of ops.flash_attention takes to return at
    gemma3-1b's prefill shape, window 512 (the card runs behind it)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for shape in ((4, 4, 1024, 256), (4, 1, 1024, 256),
                                 (4, 1, 1024, 256)))
        ops.flash_attention(q, k, v, window=512)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            ops.flash_attention(q, k, v, window=512)
        out[str(dtype).split(".")[-1]] = round(
            (time.perf_counter() - t0) / calls * 1e6, 1)
        torch.cuda.synchronize()
    return out


def run_one(checkout: Path) -> dict:
    sys.path.insert(0, str(checkout / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    from repro_torch import roofline as rl
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import flash_attention as flash

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build(["flash_attention", "flash_attention_bwd"])
    out = {"forward": chip_smoke.phase_flash(torch, ops, ref, rl,
                                             flash)["cases"],
           "forward_host_us": forward_host_us(torch, ops)}
    if "lse" not in inspect.signature(
            flash.flash_attention_bwd_cuda).parameters:
        return out
    log = _build.library_path("flash_attention_bwd").with_suffix(".log")
    out["backward"] = chip_smoke.phase_flash_bwd(torch, ref, rl,
                                                 flash)["cases"]
    out["kernel_ms"] = {str(w): kernel_ms(torch, flash, w)
                        for w in (512, None)}
    out["ptxas"] = chip_smoke.ptxas_usage(log.read_text())
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
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            return proc.returncode
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"run": i, "checkout": name, **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

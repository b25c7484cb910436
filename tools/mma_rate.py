#!/usr/bin/env python3
"""The card's rate for the warp-level tensor-core instructions that the
port's kernels run (``mma.sync``), against the data sheet's peaks.

    python3 tools/mma_rate.py

Builds ``tools/mma_rate.cu`` with ``nvcc`` (sm_90a) into ``build/tools/``,
runs it on a full grid (8 warps a block, 8 blocks an SM) with each warp
running independent ``mma.sync`` instructions, and prints one JSON line a
kind: TFLOP/s from CUDA-event medians of 5 runs, and the cycles a
scheduler's tensor pipe spends on one instruction at the SM clock that
``nvidia-smi`` reads during the runs. The f32 flash kernels run three
m16n8k8 tf32 instructions for each f32 product (3xTF32).
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KINDS = {0: ("mma.sync.m16n8k8.tf32", 2048, 494.7e12),
         1: ("mma.sync.m16n8k16.bf16", 4096, 989e12)}
ITERS = 4096


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("mma_rate: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    out_dir = ROOT / "build" / "tools"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "libmma_rate.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                    str(ROOT / "tools" / "mma_rate.cu")], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.mma_rate.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, threads = 8 * sms, 256
    buf = torch.zeros(threads, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for kind, (name, flops, peak) in KINDS.items():
        def run():
            err = lib.mma_rate(kind, blocks, threads, ITERS, buf.data_ptr(),
                               stream)
            if err:
                raise RuntimeError(f"mma_rate launch: CUDA error {err}")
        run()
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        clock = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
             "nounits"], capture_output=True, text=True, timeout=60)
        mhz = float(clock.stdout.strip().splitlines()[0])
        ms = statistics.median(times)
        count = blocks * threads // 32 * ITERS * 8
        rate = count * flops / (ms * 1e-3)
        cycles = ms * 1e-3 * mhz * 1e6 * sms * 4 / count
        print(json.dumps({"kind": name, "ms": ms, "tflops": rate / 1e12,
                          "data_sheet_dense_tflops": peak / 1e12,
                          "share_of_data_sheet": rate / peak,
                          "sm_clock_mhz": mhz,
                          "cycles_per_instruction_per_scheduler": cycles}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

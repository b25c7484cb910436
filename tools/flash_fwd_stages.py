#!/usr/bin/env python3
"""Where the f32 flash-attention forward (``flash_fwd_tf32``) spends its
time, on one GPU.

    python3 tools/flash_fwd_stages.py [VARIANT ...]

Builds variants of ``src/repro_torch/kernels/csrc/flash_attention.cu`` by
text substitution into ``build/flash_fwd_stages/`` (one ``nvcc`` each, all
at once) and times each at the f32 cases of ``chip_smoke.py``'s flash
phase (gemma3-1b's prefill, B=4, H=4, Hk=1, S=1024, D=256, window 512 and
none; minicpm3-4b's MLA heads, D=96, Dv=64, H=Hk=40; musicgen-large's, D=64,
H=Hk=32, S=1088; qwen2-vl-2b's, D=128, H=12, Hk=2, S=1280; stablelm-12b's,
D=160, H=32, Hk=8), in two rounds. Variants, default all:

  base         the source as it is
  pv_wait      each tile's P V waited for as soon as it is issued (no
               overlap of a warpgroup's softmax with its own last P V)
  one_tf32     each product one TF32 product (big * big) instead of three;
               results are off by ~1e-3
  no_products  every product taken out (the A fragments feeding them stay);
               results are garbage
  v_late       each tile's V^T waited for after its Q K^T is issued, not
               before (wgmma_fence again after the wait)
  d160_halves  D = Dv = 160 as 64-row items whose consumers take 80 head
               dims each and add their partial scores through shared
               memory (as at D = 256), one stage, 153 KiB

For each variant and case it prints the device ms of the main kernel and
of the pre-pass (``torch.profiler``, 10 calls), and for ``base`` also the
single-call CUDA-event median (as ``chip_smoke.py`` takes it), the mean of
50 calls queued back to back between two events, and SDPA's single-call
median. Then the host microseconds a call of ``ops.flash_attention`` takes
to return at gemma3-1b's shape (window 512), f32 and bf16 (its checks,
allocations, tensor maps and launches; the card runs behind it), the
ptxas lines that say a variant's products are serialized, and each
variant's registers and spills. One JSON line a
measurement. A substitution names an exact source line, so an edit of the
kernel may need them updated: the script stops naming the line it no
longer finds.
"""
from __future__ import annotations

import ctypes
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

NS = "namespace tf {\n\nusing namespace hopper;\n"
SKIP = """
template <int N>
__device__ __forceinline__ void skip_3xtf32(float (&)[N],
                                            const uint32_t (&)[4],
                                            const uint32_t (&)[4], uint64_t,
                                            uint64_t, int) {}
template <int N>
__device__ __forceinline__ void one_3xtf32(float (&d)[N],
                                           const uint32_t (&a)[4],
                                           const uint32_t (&)[4], uint64_t b,
                                           uint64_t, int scale_d) {
  wgmma_tf32(d, a, b, scale_d);
}
"""
PV_COMMIT = " " * 33 + "v0, nv, lw);\n        wgmma_commit();\n"
# (B, H, Hk, S, D, Dv, window) of chip_smoke.py's f32 flash cases
CASES = {"gemma_w512": (4, 4, 1, 1024, 256, 256, 512),
         "gemma_global": (4, 4, 1, 1024, 256, 256, None),
         "mla": (4, 40, 40, 1024, 96, 64, None),
         "musicgen": (4, 32, 32, 1088, 64, 64, None),
         "qwen2-vl": (4, 12, 2, 1280, 128, 128, None),
         "stablelm": (4, 32, 8, 1024, 160, 160, None)}
# stablelm-12b's D = Dv = 160: 128-row items, each consumer all 160 head
# dims of its 64 rows, one stage
D160 = "tf::launch<128, 160, 160, 32, 1, 20, 160>"
# a tile's V^T waited for after its Q K^T is issued (a fence after the wait)
V_WAIT = ("        mbar_wait(v_full(stage(i - 1)), phase(i - 1));\n"
          "        qk(i);\n")
V_LATE = ("        qk(i);\n"
          "        mbar_wait(v_full(stage(i - 1)), phase(i - 1));\n"
          "        wgmma_fence();\n")
ROUNDS = 2


def substitute(src: str, old: str, new: str) -> str:
    if old not in src:
        raise SystemExit(f"flash_fwd_stages: the source no longer has:\n"
                         f"{old}")
    return src.replace(old, new)


def variants(src: str) -> dict:
    with_skip = substitute(src, NS, NS + SKIP)
    return {
        "base": src,
        "pv_wait": substitute(src, PV_COMMIT,
                              PV_COMMIT + "        wgmma_wait<0>();\n"),
        "one_tf32": with_skip.replace("wgmma_3xtf32(", "one_3xtf32("),
        "no_products": with_skip.replace("wgmma_3xtf32(", "skip_3xtf32("),
        "v_late": substitute(src, V_WAIT, V_LATE),
        "d160_halves": substitute(
            src, D160, "tf::launch<64, 160, 160, 32, 1, 20, 160>"),
    }


def build(_build, texts: dict) -> tuple:
    out = ROOT / "build" / "flash_fwd_stages"
    out.mkdir(parents=True, exist_ok=True)
    for header in _build.CSRC.glob("*.cuh"):
        (out / header.name).write_bytes(header.read_bytes())
    procs = {}
    for name, text in texts.items():
        (out / f"{name}.cu").write_text(text)
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o",
               str(out / f"lib{name}.so"), str(out / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    import chip_smoke
    libs, serialized, usage = {}, {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"flash_fwd_stages: nvcc {name}:\n{log}")
        usage[name] = [u for u in chip_smoke.ptxas_usage(log)
                       if u.startswith("flash_fwd_tf32")]
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
        serialized[name] = sorted({
            f"{m.group(1)} flash_fwd_tf32<"
            f"{','.join(re.findall(r'-?[0-9]+', m.group(2)))}>"
            for m in re.finditer(r"\((C75(?:1[0-8]|2[0-9]))\)[^']*'[^']*"
                                 r"flash_fwd_tf32I((?:Li-?[0-9]+E)+)E", log)})
    return libs, serialized, usage


def inputs(torch, case):
    b, h, hk, s, d, dv, window = case
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(s + h)
    q, k, v = (torch.randn(t, generator=gen, device=dev)
               for t in ((b, h, s, d), (b, hk, s, d), (b, hk, s, dv)))
    return q, k, v, window


def kernel_ms(torch, call, calls=10) -> dict:
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    times = {}
    for ev in prof.key_averages():
        m = re.search(r"flash_fwd_\w+", ev.key)
        if m:
            times[m.group()] = round(
                times.get(m.group(), 0.0)
                + ev.self_device_time_total / 1e3 / calls, 4)
    return times


def single_ms(torch, fn, reps=20) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return round(statistics.median(times), 4)


def queued_ms(torch, fn, calls=50) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return round(start.elapsed_time(end) / calls, 4)


def host_us(torch, fn, calls=50) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return round(us, 1)


def main(argv) -> int:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build, ops
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    texts = variants((_build.CSRC / "flash_attention.cu").read_text())
    if argv:
        texts = {name: texts[name] for name in argv}
    libs, serialized, usage = build(_build, texts)
    print(json.dumps({"serialized": serialized}), flush=True)
    print(json.dumps({"ptxas": usage}), flush=True)
    for rnd in range(ROUNDS):
        for label, case in CASES.items():
            q, k, v, window = inputs(torch, case)

            def call():
                return ops.flash_attention(q, k, v, window=window)
            for name, lib in libs.items():
                _build._LIBS["flash_attention"] = lib
                line = {"round": rnd, "variant": name, "case": label,
                        "kernel_ms": kernel_ms(torch, call)}
                if name == "base":
                    line["single_ms"] = single_ms(torch, call)
                    line["queued_ms"] = queued_ms(torch, call)
                    rep = case[1] // case[2]
                    ke, ve = (t.repeat_interleave(rep, dim=1) for t in (k, v))
                    if window is None:
                        def lib_call():
                            return F.scaled_dot_product_attention(
                                q, ke, ve, is_causal=True)
                    else:
                        i = torch.arange(case[3], device=q.device)
                        mask = (i[None, :] <= i[:, None]) & (
                            i[:, None] - i[None, :] < window)

                        def lib_call():
                            return F.scaled_dot_product_attention(
                                q, ke, ve, attn_mask=mask)
                    line["sdpa_single_ms"] = single_ms(torch, lib_call)
                print(json.dumps(line), flush=True)
            del q, k, v
            torch.cuda.empty_cache()
    if "base" in libs:
        _build._LIBS["flash_attention"] = libs["base"]
        host = {}
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, window = inputs(torch, CASES["gemma_w512"])
            q, k, v = (t.to(dtype) for t in (q, k, v))
            host[str(dtype).split(".")[-1]] = host_us(
                torch, lambda: ops.flash_attention(q, k, v, window=window))
        print(json.dumps({"case": "gemma_w512", "host_us_a_call": host}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

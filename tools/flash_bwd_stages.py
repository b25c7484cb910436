#!/usr/bin/env python3
"""Where the f32 flash-attention backward spends its time, on one GPU.

    python3 tools/flash_bwd_stages.py [VARIANT ...]

Builds variants of ``src/repro_torch/kernels/csrc/flash_attention_bwd.cu``
by text substitution into ``build/flash_bwd_stages/`` (one ``nvcc`` each,
all at once; the named ones only, where names are given) and times each
kernel of one backward call by name with ``torch.profiler`` (device time
over 10 calls, divided by 10):

  base        the source as it is
  no_products every 3xTF32 product taken out (the fragments feeding them
              go with them); results are garbage
  no_stream   the dK/dV kernel's Q and dO tiles not loaded: their barriers
              complete without bytes; results are garbage
  and the other designs of D = Dv = 160 (stablelm-12b), whose results
  are real (each line of the first round gives the largest difference of
  its gradients from those of the first such variant run, base where it
  runs):
  d160_dst3   the dQ ring of 3 stages of 56 KiB instead of 4
  d160_persistent  the dK/dV kernel persistent (a block an SM taking items
              in turn) instead of a block an item
  d160_tile192  192-wide tiles of 6 atoms (dK/dV 224 KiB, dQ 3 stages)
  d160_bk16   16-key tiles with two Q/dO stages (216 KiB)
  d160_bk16_persistent  the same, persistent
  unpinned    the A fragments' splits not pinned where they are made
              (no pin), so that the compiler may sink them under the
              wgmma_fence and ptxas inject a warpgroup.arrive (C7519)

at gemma3-1b's train shapes (f32, B=4, H=4, Hk=1, S=1024, D=256, window
512 and none) and stablelm-12b's (B=4, H=32, Hk=8, S=1024, D=160), in two
rounds. Then, for the source as it is, each kernel's ms at the other main
shapes of ``chip_smoke.py``'s flash_bwd phase (minicpm3-4b's MLA heads,
musicgen-large, qwen2-vl-2b, deepseek-moe-16b), and the host microseconds
a call of ``flash_attention_bwd_cuda`` takes to return (its checks,
allocations and launches; the card runs behind it). Also prints each
variant's ptxas registers and spills of the dK/dV and dQ kernels and any
note that ptxas serialized their products (C75xx). Prints one JSON line a
measurement. A substitution names an exact source line, so an edit of the
kernel may need them updated: the script stops naming the line it no
longer finds.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SKIP = """
template <int N>
__device__ __forceinline__ void skip_3xtf32(float (&)[N],
                                            const uint32_t (&)[4],
                                            const uint32_t (&)[4], uint64_t,
                                            uint64_t, int) {}
"""
Q_LOAD = """              mbar_expect_tx(bar(0, s, a), kBQ * 128);
              tma_load(base + L::kQ + s * L::kXTile + a * kBQ * 128, &tq,
                       bar(0, s, a), 32 * a, q0, x.h, x.b);"""
DO_LOAD = """              mbar_expect_tx(bar(2, s, a), kBQ * 128);
              tma_load(base + L::kDO + s * L::kXTile + a * kBQ * 128, &tdo,
                       bar(2, s, a), 32 * a, q0, x.h, x.b);"""
D160 = "launch<160, 32, 1, 4, 20, 20, 160>(p, stream)"
PERSISTENT = "constexpr bool persistent(int hd) { return hd <= 128; }"
# (B, H, Hk, S, D, Dv, window) of chip_smoke.py's flash_bwd cases
SHAPES = {"gemma3-1b w512": (4, 4, 1, 1024, 256, 256, 512),
          "gemma3-1b": (4, 4, 1, 1024, 256, 256, None),
          "stablelm-12b": (4, 32, 8, 1024, 160, 160, None)}
OTHERS = {"mla": (4, 40, 40, 1024, 96, 64, None),
          "musicgen": (4, 32, 32, 1088, 64, 64, None),
          "qwen2-vl": (4, 12, 2, 1280, 128, 128, None),
          "deepseek": (4, 16, 16, 1024, 128, 128, None)}
REAL = ("base", "d160_dst3", "d160_persistent", "d160_tile192", "d160_bk16",
        "d160_bk16_persistent", "unpinned")  # results not garbage


def substitute(src: str, old: str, new: str) -> str:
    if old not in src:
        raise SystemExit(f"flash_bwd_stages: the source no longer has:\n"
                         f"{old}")
    return src.replace(old, new)


def variants(src: str) -> dict:
    no_products = substitute(src, "using namespace hopper;\n",
                             "using namespace hopper;\n" + SKIP)
    no_products = no_products.replace("wgmma_3xtf32(", "skip_3xtf32(")
    arrive = "              mbar_arrive(bar({}, s, a));"
    no_stream = substitute(src, Q_LOAD, arrive.format(0))
    no_stream = substitute(no_stream, DO_LOAD, arrive.format(2))
    persistent = substitute(src, PERSISTENT,
                            PERSISTENT.replace("hd <= 128", "hd <= 192"))
    bk16 = D160.replace("160, 32, 1, 4", "160, 16, 2, 4")
    return {"base": src, "no_products": no_products, "no_stream": no_stream,
            "d160_dst3": substitute(src, D160, D160.replace(
                "160, 32, 1, 4", "160, 32, 1, 3")),
            "d160_persistent": persistent,
            "d160_tile192": substitute(src, D160, D160.replace(
                "<160, 32, 1, 4", "<192, 32, 1, 3")),
            "d160_bk16": substitute(src, D160, bk16),
            "d160_bk16_persistent": substitute(persistent, D160, bk16),
            "unpinned": src.replace("pin(ab[j], as[j]);", "")}


def build(_build, texts: dict) -> tuple:
    out = ROOT / "build" / "flash_bwd_stages"
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
    libs, notes = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"flash_bwd_stages: nvcc {name}:\n{log}")
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
        notes[name] = {
            "ptxas": [u for u in chip_smoke.ptxas_usage(log)
                      if re.match(r"flash_bwd_(dkdv|dq)<", u)],
            "serialized": sorted({
                f"{c} {chip_smoke._kernel_name(n)}"
                for ln in log.splitlines()
                for c in re.findall(r"\((C75\d\d)\)", ln)
                for n in re.findall(r"(_Z\w+)", ln)})}
    return libs, notes


def inputs(torch, flash, shape):
    b, h, hk, s, d, dv, window = shape
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(t, generator=gen, device=dev)
               for t in ((b, h, s, d), (b, hk, s, d), (b, hk, s, dv)))
    dout = torch.randn((b, h, s, dv), generator=gen, device=dev)
    out, lse = flash.flash_attention_cuda(q, k, v, causal=True, window=window,
                                          scale=None, with_lse=True)
    return lambda: flash.flash_attention_bwd_cuda(
        q, k, v, out, dout, lse, causal=True, window=window, scale=None)


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
        m = re.search(r"flash_bwd_\w+", ev.key)
        if m:
            times[m.group()] = round(ev.self_device_time_total / 1e3 / calls,
                                     4)
    return times


def main(argv) -> int:
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as flash
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    _build.build(["flash_attention", "flash_attention_bwd"])
    texts = variants((_build.CSRC / "flash_attention_bwd.cu").read_text())
    if argv:
        texts = {name: texts[name] for name in argv}
    libs, notes = build(_build, texts)
    for name, note in notes.items():
        print(json.dumps({"variant": name, **note}), flush=True)
    for rnd in range(2):
        for label, shape in SHAPES.items():
            call = inputs(torch, flash, shape)
            first = None
            for name, lib in libs.items():
                _build._LIBS["flash_attention_bwd"] = lib
                line = {"round": rnd, "variant": name, "shape": label,
                        "kernel_ms": kernel_ms(torch, call)}
                line["device_ms"] = round(sum(line["kernel_ms"].values()), 4)
                if rnd == 0 and name in REAL:
                    got = call()
                    first = first or got
                    line["max_diff_from_first"] = max(
                        (g - f).abs().max().item()
                        for g, f in zip(got, first))
                print(json.dumps(line), flush=True)
            del call, first
            torch.cuda.empty_cache()
    if "base" not in libs:
        return 0
    _build._LIBS["flash_attention_bwd"] = libs["base"]
    for label, shape in OTHERS.items():
        ms = kernel_ms(torch, inputs(torch, flash, shape))
        print(json.dumps({"variant": "base", "shape": label,
                          "kernel_ms": ms}), flush=True)
    for label in ("gemma3-1b w512", "stablelm-12b"):
        call = inputs(torch, flash, SHAPES[label])
        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            call()
        host_us = (time.perf_counter() - t0) / 20 * 1e6
        torch.cuda.synchronize()
        print(json.dumps({"shape": label,
                          "host_us_a_call": round(host_us, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

#!/usr/bin/env python3
"""Where the bf16 flash forward (``flash_fwd_wgmma``) spends its time, on
one GPU.

    python3 tools/flash_stages.py [VARIANT ...]

Builds variants of ``src/repro_torch/kernels/csrc/flash_attention.cu``,
each the kernel with one part taken out or changed by a text substitution
(into ``build/flash_stages/``, one ``nvcc`` each, all at once), and times
each at Jamba's prefill shape (B=4, H=64, Hk=8, S=1024, D=128, causal), a
non-causal one of 1024 and of 4096 keys, minicpm3-4b's MLA heads (D=96,
Dv=64, B=4 and B=1), gemma3-1b's (D=256) and stablelm-12b's (H=32,
Hk=8, D=160), beside one
``scaled_dot_product_attention`` call, in rounds (every variant once,
then again). Variants, default all:

  base       the kernel as it is
  skeleton   no products and no softmax: the TMA ring, the barriers and
             the epilogue alone
  no_exp     exponentials left out of the softmax (wrong output)
  no_turns   the two consumer warpgroups do not take turns
  narrow_pv  P V as one product per 64-column atom at Dv = 128 and 160
  poly_exp   half the exponentials of the tiles off the band's edges as a
             degree-3 polynomial on the FMA units instead of ex2
  profile    the kernel with clock64() around each stage of a consumer
             warpgroup's step, summed over consumer 0's first thread of
             every block: the share of its time in each stage

Prints the card's name and power limit, then one JSON line per shape: the
ms of each variant in each round, SDPA's ms, and the profile's shares and
cycles per step. Those times are CUDA-event medians of single calls, as
``chip_smoke.py`` takes them, so they include the host's work before each
launch (the wrapper, the tensor maps) wherever the card waits for it; the
line also gives ``base`` and SDPA as the mean of 50 calls queued back to
back between two events (``*_queued_ms``), which the host keeps ahead of;
a last line gives the host's microseconds a call of ``ops.flash_attention``
and of SDPA at a tiny shape, where the card waits for neither.
Outputs are not checked (some variants compute wrong ones on purpose);
``chip_smoke.py`` and the card tests check the kernel.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

ROUNDS = 2
SHAPES = [("jamba", (4, 64, 8, 1024, 128, 128), True),
          ("noncausal_4096", (1, 64, 8, 4096, 128, 128), False),
          ("noncausal_1024", (4, 64, 8, 1024, 128, 128), False),
          ("mla", (4, 40, 40, 1024, 96, 64), True),
          ("mla_b1", (1, 40, 40, 1024, 96, 64), True),
          ("gemma3_bf16", (4, 4, 1, 1024, 256, 256), True),
          ("stablelm", (4, 32, 8, 1024, 160, 160), True)]

POLY = r"""__device__ __forceinline__ float ex2_poly(float x) {
  x = fmaxf(x, -126.f);
  const float r = x + 12582912.f;
  const float f = x - (r - 12582912.f);
  float q = 0.05517160892486572f;
  q = q * f + 0.2426111102104187f;
  q = q * f + 0.6932609677314758f;
  q = q * f + 0.9999280571937561f;
  return __int_as_float(__float_as_int(q) + (__float_as_int(r) << 23));
}
__device__ __forceinline__ float ex2(float x) {"""

EXP = "sc[4 * j + e] = ex2(kEdge ? x - mx : x * p.scale - mx);"
SOFTMAX = ("        if (edge(t))\n"
           "          softmax_tile<BK, true>(sc, m, l, corr, pa, p, r0,"
           " t * BK, lane);\n        else\n"
           "          softmax_tile<BK, false>(sc, m, l, corr, pa, p, r0,"
           " t * BK, lane);")
PROFILE = [
    ("namespace wg {\n\nusing namespace hopper;\n",
     "namespace wg {\n\nusing namespace hopper;\n"
     "__device__ unsigned long long g_prof[8];\n"),
    ("    setmaxnreg_inc<kConsumerRegs>();\n",
     "    setmaxnreg_inc<kConsumerRegs>();\n"
     "    long long acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
     "    const long long t_start = clock64();\n"),
    ("        const int s = stage(i), sp = stage(i - 1);\n"
     "        mbar_wait(k_full(s), phase(i));\n"
     "        mbar_wait(v_full(sp), phase(i - 1));\n",
     "        const int s = stage(i), sp = stage(i - 1);\n"
     "        long long t0 = clock64();\n"
     "        mbar_wait(k_full(s), phase(i));\n"
     "        mbar_wait(v_full(sp), phase(i - 1));\n"
     "        long long t1 = clock64(); acc[0] += t1 - t0; acc[7] += 1;\n"),
    ("        turn_begin();\n        wgmma_fence();\n"
     "        issue_qk<HD, BK>(sc, q_rows, k_stage(s), ksteps);",
     "        turn_begin();\n"
     "        long long t2 = clock64(); acc[1] += t2 - t1;\n"
     "        wgmma_fence();\n"
     "        issue_qk<HD, BK>(sc, q_rows, k_stage(s), ksteps);"),
    ("        wgmma_wait<1>();\n        fence_regs(sc);\n",
     "        wgmma_wait<1>();\n        fence_regs(sc);\n"
     "        long long t3 = clock64(); acc[2] += t3 - t2;\n"),
    ("        softmax(sc, m, l, corr, p_next, x.t_lo + i);\n"
     "        wgmma_wait<0>();\n",
     "        softmax(sc, m, l, corr, p_next, x.t_lo + i);\n"
     "        long long t4 = clock64(); acc[3] += t4 - t3;\n"
     "        wgmma_wait<0>();\n"
     "        long long t5 = clock64(); acc[4] += t5 - t4;\n"),
    ("            o[a][4 * j + 3] *= corr[1];\n          }\n      };",
     "            o[a][4 * j + 3] *= corr[1];\n          }\n"
     "        acc[5] += clock64() - t5;\n      };"),
    ("    if (tid == 0) tma_store_wait_read();\n  }\n}\n",
     "    if (tid == 0) tma_store_wait_read();\n"
     "    if (tid == 0 && c == 0) {\n"
     "      acc[6] = clock64() - t_start;\n"
     "      for (int k = 0; k < 8; ++k)\n"
     "        atomicAdd(&g_prof[k], (unsigned long long)acc[k]);\n"
     "    }\n  }\n}\n"),
    ('extern "C" {\n',
     'extern "C" {\n'
     "int read_prof(unsigned long long* out) {\n"
     "  return (int)cudaMemcpyFromSymbol(out, wg::g_prof, 64);\n}\n"
     "int zero_prof() {\n"
     "  unsigned long long z[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
     "  return (int)cudaMemcpyToSymbol(wg::g_prof, z, 64);\n}\n"),
]
STAGES = ["wait_kv", "wait_turn", "issue_and_qk", "softmax", "wait_pv",
          "rescale"]

VARIANTS = {
    "base": [],
    "skeleton": [
        ("    if (kk < ksteps) {", "    if (kk < ksteps && ksteps < 0) {"),
        ("  for (int kc = 0; kc < BK / 16; ++kc) {\n    if constexpr (kWide)",
         "  for (int kc = 0; kc < BK / 16 && pv_atoms < 0; ++kc) {\n"
         "    if constexpr (kWide)"),
        (SOFTMAX,
         "        for (int kc = 0; kc < BK / 16; ++kc)\n"
         "          for (int e = 0; e < 4; ++e)\n"
         "            pa[kc][e] = __float_as_uint(sc[8 * kc + 2 * e]);\n"
         "        corr[0] = corr[1] = 1.f;")],
    "no_exp": [(EXP, "sc[4 * j + e] = kEdge ? x - mx : x * p.scale - mx;")],
    "no_turns": [
        ("auto turn_begin = [&] { named_sync(3 + c, 256); };",
         "auto turn_begin = [&] {};"),
        ("auto turn_end = [&] { named_arrive(3 + (c ^ 1), 256); };",
         "auto turn_end = [&] {};")],
    "narrow_pv": [("constexpr bool kWide = VN == 128 || VN == 160;",
                   "constexpr bool kWide = false;")],
    "poly_exp": [("__device__ __forceinline__ float ex2(float x) {", POLY),
                 (EXP, "sc[4 * j + e] = (!kEdge && (j & 1))"
                       " ? ex2_poly(x * p.scale - mx)"
                       " : ex2(kEdge ? x - mx : x * p.scale - mx);")],
    "profile": PROFILE,
}


def variant_source(src: str, name: str) -> str:
    for old, new in VARIANTS[name]:
        if old not in src:
            raise SystemExit(f"variant {name}: the source has no {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build(names, _build) -> dict:
    """One nvcc per variant, all at once; returns the loaded libraries."""
    out = ROOT / "build" / "flash_stages"
    src = (_build.CSRC / "flash_attention.cu").read_text()
    procs = {}
    for name in names:
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        for header in _build.CSRC.glob("*.cuh"):
            (d / header.name).write_text(header.read_text())
        (d / "flash_attention.cu").write_text(variant_source(src, name))
        so = d / "libflash_attention.so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
               str(d / "flash_attention.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc {name} failed:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(so))
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def queued_ms(torch, fn, calls=50) -> float:
    """Mean ms of ``calls`` calls queued back to back between two events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def host_us(torch, fn, calls=2000) -> float:
    """Host microseconds a call of ``fn``, averaged over ``calls``."""
    import time
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def main(argv) -> int:
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as flash

    if not torch.cuda.is_available():
        raise SystemExit("flash_stages needs a CUDA device")
    names = argv or list(VARIANTS)
    print(chip_smoke.card(), flush=True)
    libs = build(names, _build)
    dev = torch.device("cuda")
    for shape, (b, h, hk, s, d, dv), causal in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(0)
        q, k, v = (torch.randn(sh, generator=gen, device=dev).to(
            torch.bfloat16) for sh in ((b, h, s, d), (b, hk, s, d),
                                       (b, hk, s, dv)))
        ke, ve = (t.repeat_interleave(h // hk, dim=1) for t in (k, v))
        row = {"shape": shape, "sdpa_ms": chip_smoke.time_ms(
            torch, lambda: F.scaled_dot_product_attention(
                q, ke, ve, is_causal=causal))}

        def call():
            return flash.flash_attention_cuda(q, k, v, causal=causal,
                                              window=None, scale=None)
        for _ in range(ROUNDS):
            for name in names:
                _build._LIBS["flash_attention"] = libs[name]
                row.setdefault(name, []).append(chip_smoke.time_ms(torch,
                                                                   call))
        if "profile" in libs:
            lib = libs["profile"]
            _build._LIBS["flash_attention"] = lib
            lib.zero_prof()
            call()
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * 8)()
            lib.read_prof(buf)
            total, steps = buf[6] or 1, buf[7] or 1
            row["profile_share"] = {st: buf[i] / total
                                    for i, st in enumerate(STAGES)}
            row["profile_cycles_per_step"] = sum(buf[:6]) / steps
        if "base" in libs:
            _build._LIBS["flash_attention"] = libs["base"]
            row["base_queued_ms"] = queued_ms(torch, call)
            row["sdpa_queued_ms"] = queued_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    q, ke, ve, is_causal=causal))
        flops = flash.work(b, h, hk, s, d, dv, None, 2, causal)[0]
        row["tflops_base"] = [flops / ms / 1e9 for ms in row.get("base", [])]
        print(json.dumps(row), flush=True)
        del q, k, v, ke, ve
    from repro_torch.kernels import ops
    _build._LIBS["flash_attention"] = libs[names[0]]
    q, k, v = (torch.randn(1, 2, 128, 128, device=dev).to(torch.bfloat16)
               for _ in range(3))
    print(json.dumps({"host_us_a_call": {
        "ops.flash_attention": host_us(torch, lambda: ops.flash_attention(
            q, k, v)),
        "sdpa": host_us(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True))}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

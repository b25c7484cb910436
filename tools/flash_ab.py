#!/usr/bin/env python3
"""The flash-attention kernels of checkouts of the PyTorch port,
alternated on one GPU.

    python3 tools/flash_ab.py [--forward] OLD_CHECKOUT NEW NEW OLD

Runs each named checkout once, in the order given, each in a process of
its own (a checkout is a directory with ``src/repro_torch``). A run builds
that checkout's ``flash_attention`` and ``flash_attention_bwd`` kernels
and runs this repository's ``chip_smoke.py`` ``flash`` phase on them (the
forward at every shape of that phase, f32 and bf16). Where the checkout's
backward takes the forward's lse, as this one's does, it also runs the
``flash_bwd`` phase (every backward shape of chip_smoke: gemma3-1b's
train shapes, minicpm3-4b's, musicgen-large's, qwen2-vl-2b's,
deepseek-moe-16b's and stablelm-12b's), whose cases carry each kernel's
device ms by name (``torch.profiler``: device time summed over 10 calls,
divided by 10) and the host µs a call. Kernel, plain and SDPA ms are
CUDA-event medians; each forward case also carries its kernels' device ms.
Prints one JSON line a run: the cases, the host microseconds a forward
call takes to return at gemma3-1b's window-512 shape and at stablelm-12b's
(B=4, H=32, Hk=8, S=1024, D=160) in f32 and bf16, that call split into its
stages at stablelm's shape (``forward_host_split``), the C side's runtime
and driver calls timed alone (``c_side_us``), the backward's call split
likewise (``backward_host_split``), and the ``ptxas`` registers and spills
of the backward's kernels. ``--forward`` leaves the backward out. The
phases take their bounds from the checkout's ``repro_torch.roofline`` rates
and its kernel module's ``work`` functions, so a checkout must have both.
"""
from __future__ import annotations

import ctypes
import inspect
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


# (B, H, Hk, S, D, window) of the forward's host-work shapes: gemma3-1b's
# prefill of a local layer and stablelm-12b's
HOST_SHAPES = {"gemma_w512": (4, 4, 1, 1024, 256, 512),
               "stablelm": (4, 32, 8, 1024, 160, None)}


def _inputs(torch, shape, dtype):
    b, h, hk, s, d, _ = shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    return [torch.randn(t, generator=gen, device="cuda").to(dtype)
            for t in ((b, h, s, d), (b, hk, s, d), (b, hk, s, d))]


def forward_host_us(torch, ops, host_us) -> dict:
    """Host microseconds a call of ops.flash_attention takes to return at
    each of HOST_SHAPES, f32 and bf16 (the card runs behind it;
    chip_smoke's ``host_us``)."""
    out = {}
    for label, shape in HOST_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _inputs(torch, shape, dtype)
            out[f"{label} {str(dtype).split('.')[-1]}"] = round(host_us(
                torch, lambda: ops.flash_attention(q, k, v,
                                                   window=shape[-1])), 2)
    return out


PROBE = r"""
#include <chrono>
#include "hopper.cuh"

struct Args { int a[16]; };  // the size of the kernels' scalar arguments

__global__ void probe_kernel(const __grid_constant__ CUtensorMap a,
                             const __grid_constant__ CUtensorMap b,
                             const __grid_constant__ CUtensorMap c,
                             const __grid_constant__ CUtensorMap d, Args) {}

// Host microseconds of each runtime and driver call that a forward launch
// makes, or made once a call in older checkouts, each repeated `reps`
// times over the (B, S, H, D)
// bf16 tensor at ptr: us[0] one cuTensorMapEncodeTiled (make_map),
// us[1] cudaGetDevice, us[2] cudaDeviceGetAttribute (the SM count),
// us[3] cudaFuncSetAttribute (dynamic shared memory), us[4] a launch of
// 132 blocks of 384 threads with four tensor maps as arguments, and
// cudaGetLastError.
extern "C" int host_costs(const void* ptr, int B, int S, int H, int D,
                          int reps, double* us) {
  using clk = std::chrono::steady_clock;
  auto lap = [&](clk::time_point t0) {
    return std::chrono::duration<double, std::micro>(clk::now() - t0)
               .count() / reps;
  };
  CUtensorMap m;
  int dev = 0, sms = 0, err = 0;
  auto t0 = clk::now();
  for (int i = 0; i < reps; ++i)
    err |= hopper::make_map(&m, ptr, D, S, H, B, 2ll * H * D, 2ll * D,
                            2ll * S * H * D, 128);
  us[0] = lap(t0);
  t0 = clk::now();
  for (int i = 0; i < reps; ++i) err |= cudaGetDevice(&dev);
  us[1] = lap(t0);
  t0 = clk::now();
  for (int i = 0; i < reps; ++i)
    err |= cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  us[2] = lap(t0);
  t0 = clk::now();
  for (int i = 0; i < reps; ++i)
    err |= cudaFuncSetAttribute(
        probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 197712);
  us[3] = lap(t0);
  t0 = clk::now();
  for (int i = 0; i < reps; ++i) {
    probe_kernel<<<sms, 384, 197712>>>(m, m, m, m, Args{});
    err |= cudaGetLastError();
  }
  us[4] = lap(t0);
  return err | cudaDeviceSynchronize();
}
"""


def c_probe(torch, _build, checkout: Path) -> dict:
    """The C side's calls timed alone (PROBE, built against the checkout's
    hopper.cuh), at stablelm-12b's bf16 q."""
    out = ROOT / "build" / "flash_ab_probe" / checkout.name
    out.mkdir(parents=True, exist_ok=True)
    (out / "probe.cu").write_text(PROBE)
    lib = out / "libprobe.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(checkout / "src/repro_torch/kernels/csrc"), "-o",
                    str(lib), str(out / "probe.cu")], check=True,
                   capture_output=True, timeout=300)
    probe = ctypes.CDLL(str(lib))
    probe.host_costs.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_double)]
    b, h, _, s, d, _ = HOST_SHAPES["stablelm"]
    q = torch.zeros((b, s, h, d), dtype=torch.bfloat16, device="cuda")
    us = (ctypes.c_double * 5)()
    probe.host_costs(q.data_ptr(), b, s, h, d, 10, us)  # warm-up
    err = probe.host_costs(q.data_ptr(), b, s, h, d, 200, us)
    if err:
        raise RuntimeError(f"flash_ab: host probe error {err}")
    return dict(zip(("make_map", "cudaGetDevice", "cudaDeviceGetAttribute",
                     "cudaFuncSetAttribute", "launch"),
                    (round(x, 3) for x in us)))


def host_split(torch, ops, flash, _build, host_us) -> dict:
    """Host microseconds of each stage of one ops.flash_attention call at
    stablelm-12b's shape, f32 and bf16, each stage timed alone
    (chip_smoke's ``host_us``): the ops layer's placement and argument
    checks, the output's allocation (as older checkouts' wrappers make it,
    and as this one does) and the f32 scratch's, the layout
    check in Python, the stride list, the current stream (as a Stream, and
    as the raw handle), the ctypes call alone (B = 0: the C entry returns
    at once) and whole (the C side and the launch), and the whole ops
    call. A checkout names its layout check ``check_tma_layout`` (older
    ones ``check_mma_layout``) and passes the C entry one packed block
    (``_FWD_ARGS``, the packing timed with the call; older ones thirty
    arguments)."""
    layout = getattr(flash, "check_tma_layout", None) \
        or flash.check_mma_layout
    b, h, hk, s, d, window = HOST_SHAPES["stablelm"]
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _inputs(torch, HOST_SHAPES["stablelm"], dtype)
        dev = q.device
        o = torch.empty((b, s, h, d), dtype=dtype, device=dev).transpose(1, 2)
        ops.flash_attention(q, k, v)  # the library's first call
        fn = _build.load("flash_attention").flash_attention_fwd
        strides = [t.stride(i) for t in (q, k, v, o) for i in range(3)]
        code = 0 if dtype == torch.float32 else 1
        n_kv = b * hk * 2 * s * d
        scratch = torch.empty(n_kv + b * hk * 2 * d * s, device=dev)
        kv, vt = scratch.data_ptr(), scratch.data_ptr() + 4 * n_kv
        stream = torch.cuda.current_stream(dev).cuda_stream

        packed = getattr(flash, "_FWD_ARGS", None)

        def launch(batch):
            if packed is not None:  # one block of arguments
                return fn(packed.pack(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    *strides, 0, kv, vt, stream, code, batch, h, hk, s, d,
                    d, d ** -0.5, 1, 0))
            return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                      code, batch, h, hk, s, d, d, *strides, d ** -0.5, 1, 0,
                      None, kv, vt, stream)
        stages = {
            "placements": lambda: ops._placements(
                "flash_attention", (q, k, v), {0, 1}),
            "check_args": lambda: flash.check_args(q, k, v),
            "empty_out": lambda: torch.empty(
                (b, s, h, d), dtype=dtype, device=dev).transpose(1, 2),
            "new_empty_strided": lambda: q.new_empty_strided(
                (b, h, s, d), o.stride()),
            "layout": lambda: layout({"q": q, "k": k, "v": v, "out": o}),
            "strides": lambda: [t.stride(i) for t in (q, k, v, o)
                                for i in range(3)],
            "current_stream": lambda: torch.cuda.current_stream(
                dev).cuda_stream,
            "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(
                q.get_device()),
            "ctypes_only": lambda: launch(0),
            "ctypes_and_c_side": lambda: launch(b),
            "ops_call": lambda: ops.flash_attention(q, k, v),
        }
        if dtype == torch.float32:
            stages["empty_scratch"] = lambda: torch.empty(
                n_kv + b * hk * 2 * d * s, device=dev)
        out[str(dtype).split(".")[-1]] = {
            name: round(host_us(torch, fn_), 2)
            for name, fn_ in stages.items()}
    return out


def backward_host_split(torch, flash, _build, host_us) -> dict:
    """Host microseconds of each stage of one ``flash_attention_bwd_cuda``
    call at stablelm-12b's shape (f32, causal), each stage timed alone
    (chip_smoke's ``host_us``): the argument checks (``check_args``, then
    the wrapper's dtype, device, stride, shape and lse checks together), the
    three outputs' allocation (``torch.empty_strided`` as older checkouts
    make them, ``new_empty_strided`` as this one does), the scratch's, the
    layout check in Python, the stride list (and the stride array that
    older checkouts build), the current stream (as a Stream, and as the raw
    handle), the ctypes call alone (B = 0: the C entry returns at once) and
    whole (the C side and the five launches), and the whole wrapper call,
    there and at gemma3-1b's window-512 shape. A checkout passes the C
    entry one packed block (``_BWD_ARGS``, the packing timed with the call)
    or, older ones, 29 arguments and a stride array."""
    b, h, hk, s, d, _ = HOST_SHAPES["stablelm"]
    ld = -(-s // 8) * 8
    q, k, v = _inputs(torch, HOST_SHAPES["stablelm"], torch.float32)
    dout = torch.randn_like(q)
    out, lse = flash.flash_attention_cuda(q, k, v, causal=True, window=None,
                                          scale=None, with_lse=True)
    kw = dict(causal=True, window=None, scale=None)
    flash.flash_attention_bwd_cuda(q, k, v, out, dout, lse, **kw)  # load
    fn = _build.load("flash_attention_bwd").flash_attention_bwd
    dev = q.device
    views = (q, k, v, out, dout, q.clone(), k.clone(), v.clone())
    strides = [x for t in views for x in t.stride()[:3]]
    sizes = [b * h * s, b * hk * 2 * s * d, b * hk * 2 * s * d,
             b * hk * 2 * d * ld, b * h * s * ld, b * h * s * d, b * h * s * d]
    scratch = torch.empty(sum(sizes), device=dev)
    ptrs, at = [], scratch.data_ptr()
    for n in sizes:
        ptrs.append(at)
        at += 4 * n
    stream = torch.cuda.current_stream(dev).cuda_stream
    packed = getattr(flash, "_BWD_ARGS", None)
    layout = getattr(flash, "check_tma_layout", None) \
        or flash.check_mma_layout

    def launch(batch):
        if packed is not None:
            return fn(packed.pack(
                *[t.data_ptr() for t in views], *strides, lse.data_ptr(),
                *ptrs, stream, batch, h, hk, s, d, d, ld, d ** -0.5, 1, 0))
        return fn(*(t.data_ptr() for t in views), lse.data_ptr(), *ptrs,
                  batch, h, hk, s, d, d, ld,
                  (ctypes.c_longlong * 24)(*strides), d ** -0.5, 1, 0,
                  stream)

    def checks():
        for t in (q, k, v, out, dout):
            if t.dtype != torch.float32 or t.device != dev \
                    or t.stride(-1) != 1:
                raise ValueError
        if out.shape != (b, h, s, d) or dout.shape != out.shape \
                or lse.shape != (b, h, s) or not lse.is_contiguous():
            raise ValueError

    def outputs_old():
        return [torch.empty_strided(t.shape, (s * t.shape[1] * d, d,
                                              t.shape[1] * d, 1),
                                    dtype=t.dtype, device=t.device)
                for t in (q, k, v)]

    def outputs_new():
        return [t.new_empty_strided(t.shape, (s * t.shape[1] * d, d,
                                              t.shape[1] * d, 1))
                for t in (q, k, v)]
    stages = {
        "check_args": lambda: flash.check_args(q, k, v),
        "checks": checks,
        "outputs_empty_strided": outputs_old,
        "outputs_new_empty_strided": outputs_new,
        "scratch": lambda: torch.empty(sum(sizes), device=dev),
        "layout": lambda: layout({"q": q, "dout": dout}),
        "strides": lambda: [x for t in views for x in t.stride()[:3]],
        "stride_array": lambda: (ctypes.c_longlong * 24)(*strides),
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(
            q.get_device()),
        "ctypes_only": lambda: launch(0),
        "ctypes_and_c_side": lambda: launch(b),
        "call": lambda: flash.flash_attention_bwd_cuda(q, k, v, out, dout,
                                                       lse, **kw),
    }
    res = {name: round(host_us(torch, fn_), 2) for name, fn_ in stages.items()}
    b, h, hk, s, d, window = HOST_SHAPES["gemma_w512"]
    q, k, v = _inputs(torch, HOST_SHAPES["gemma_w512"], torch.float32)
    dout = torch.randn_like(q)
    out, lse = flash.flash_attention_cuda(q, k, v, causal=True,
                                          window=window, scale=None,
                                          with_lse=True)
    res["call gemma_w512"] = round(host_us(
        torch, lambda: flash.flash_attention_bwd_cuda(
            q, k, v, out, dout, lse, causal=True, window=window,
            scale=None)), 2)
    return res


def run_one(checkout: Path, forward_only: bool) -> dict:
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
           "forward_host_us": forward_host_us(torch, ops,
                                              chip_smoke.host_us),
           "forward_host_split": host_split(torch, ops, flash, _build,
                                            chip_smoke.host_us),
           "c_side_us": c_probe(torch, _build, checkout)}
    if forward_only or "lse" not in inspect.signature(
            flash.flash_attention_bwd_cuda).parameters:
        return out
    log = _build.library_path("flash_attention_bwd").with_suffix(".log")
    out["backward"] = chip_smoke.phase_flash_bwd(torch, ref, rl,
                                                 flash)["cases"]
    out["backward_host_split"] = backward_host_split(torch, flash, _build,
                                                     chip_smoke.host_us)
    out["ptxas"] = chip_smoke.ptxas_usage(log.read_text())
    return out


def main(argv) -> int:
    forward_only = "--forward" in argv
    argv = [a for a in argv if a != "--forward"]
    if argv[:1] == ["--run"]:
        print(json.dumps(run_one(Path(argv[1]).resolve(), forward_only)),
              flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    for i, name in enumerate(argv):
        proc = subprocess.run([sys.executable, __file__, "--run", name]
                              + ["--forward"] * forward_only,
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            return proc.returncode
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"run": i, "checkout": name, **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one printed line each; any failure raises and exits non-zero:
  device     the card's name and power limit (nvidia-smi)
  build      nvcc builds every CUDA kernel of src/repro_torch/kernels/csrc;
             registers and spill bytes of each kernel instantiation (ptxas)
  delta_mask the changed-block scan kernel on 256 MiB against its plain
             version and the host scan, exactly; kernel, plain and bound ms
  flash      the flash-attention kernel at the gemma3-1b prefill shapes
             (B=4, H=4, Hk=1, S=1024, D=256; window 512 and none; f32 and
             bf16; ragged S=1000) and at Jamba's (bf16, B=4, H=64, Hk=8,
             S=1024, D=128, global) against its plain version; kernel,
             plain, bound and library (scaled_dot_product_attention) ms;
             each line names the kernel's path, mma (bf16) or tf32 (f32 as
             3xTF32), both on tensor cores, and the rate its bound assumes
  ssm_scan   the selective-scan kernel at the Jamba prefill shape (f32,
             B=4, S=1024, D=16384, N=16) and a ragged one (S=1000,
             D=16376) against its plain version; kernel, plain, bound ms,
             and the kernel's ms when it also keeps its boundary states
  ssm_bwd    the selective-scan backward kernel at the same two shapes,
             with 1 % exact-zero decays, fed the forward kernel's boundary
             states (themselves held against the plain scan's states at
             those steps) against its plain version; two launches
             bit-equal; kernel, plain and bound ms (no single library call
             computes it)
  flash_bwd  the flash-attention backward kernel at gemma3-1b's train
             shapes (f32, B=4, H=4, Hk=1, S=1024, D=256; window 512 and
             none; ragged S=1000), fed the forward kernel's output and
             log-sum-exp, against its plain version; two launches
             bit-equal; kernel, plain, bound and library (the backward of
             scaled_dot_product_attention) ms; each line names the path,
             tf32 (3xTF32 mma.sync)
  reference  gemma3-1b-reduced and jamba-1.5-large-398b-reduced prefill +
             decode on the card against the same weights on the CPU, f32;
             both archs' train loss and gradients likewise
  serve      full-width gemma3-1b (f32) through repro_torch.launch.serve:
             batch 4, prompt 1024, 32 tokens, a delta snapshot every 8, a
             node kill and failover at 20; tokens and final logits equal to
             an uninterrupted run; delta_mask and flash_attention launched
             on that path; then the same decode without snapshots
  jamba      the same serve of the first 4 layers of Jamba-1.5-Large's
             superblock at full width, in bf16 (Mamba + dense, Mamba + MoE,
             Mamba + dense, attention + MoE: 23.0e9 parameters);
             ssm_scan, flash_attention and delta_mask launched on that path
  train      full-width gemma3-1b (f32, the 262,144 vocabulary) cut to its
             first superblock (6 layers, 5 local + 1 global) through
             repro_torch.launch.train: batch 4, seq 1024, 8 steps, a delta
             checkpoint of the train state every 3, a node kill after step
             7, a restore from the replica; losses from the resumed step on
             and the final parameters' CRC equal to an uninterrupted run
             without checkpoints; delta_mask, flash_attention and
             flash_attention_bwd launched on that path; then 2 steps of the
             whole 26-layer model; then jamba-1.5-large-398b-reduced (f32,
             batch 4, seq 1024, 4096-byte delta blocks) with the same
             checkpoints, kill and bit-exact resume, all five kernels
             launched; then full-width Jamba-1.5-Large cut to its first
             layer (Mamba + dense SwiGLU, 2.10e9 parameters), 3 steps
             without checkpoints. It runs in a child process with
             CUBLAS_WORKSPACE_CONFIG set, which the deterministic train
             step needs and which would slow the serve phases' decode
Then one JSON line with every kernel's numbers (launches summed over the
main-path runs: two serve runs and two train runs with a node kill, and
the Jamba L0 train run; flash_attention's entry is gemma3-1b's f32 case,
flash_attention_bwd's its window-512 train case, each with every case
under "cases"), and the last line {"ok": true, "device": {...}}. Times are
CUDA-event medians of 20 runs.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PORT = ROOT / "src" / "repro_torch"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# Dense tensor-core rates (H100 SXM data sheet): bf16 989 TFLOP/s; f32 work
# runs as 3xTF32, three TF32 products at 494.7 TFLOP/s for each f32 one
PEAK_FLOPS = {"float32": 494.7e12 / 3, "bfloat16": 989e12}
CUDA_CORE_F32_FLOPS = 67e12  # f32 outside the tensor cores, for comparison
REPS = 20
BWD_TOL = 1e-4  # flash_attention_bwd: of each gradient's largest element
SERVE_ARGS = ["--arch", "gemma3-1b", "--batch", "4", "--prompt-len", "1024",
              "--gen", "32", "--snapshot-every", "8", "--seed", "0"]
JAMBA_ARGS = ["--batch", "4", "--prompt-len", "1024", "--gen", "32",
              "--snapshot-every", "8", "--seed", "0", "--dtype", "bfloat16"]
JAMBA_LAYERS = 4  # of the 8-layer superblock: one superblock is 90.5 GB
TRAIN_ARGS = ["--batch", "4", "--seq", "1024", "--lr", "1e-3"]
KILL_ARGS = ["--steps", "8", "--ckpt-every", "3", "--inject-failure", "7"]
JAMBA_TRAIN_STEPS = 3  # the full-width L0 cut, without checkpoints


def time_ms(torch, fn) -> float:
    """Median of REPS CUDA-event timings of fn(), after a warm-up."""
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


def phase_device(torch) -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(f"device: {torch.cuda.get_device_name(0)}; "
          f"{torch.cuda.device_count()} visible; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)


def _kernel_name(mangled: str) -> str:
    """'_ZN12_GLOBAL__N_13mma14flash_fwd_tf32ILi256ELi32EEEvNS_6ParamsE'
    -> 'flash_fwd_tf32<256,32>': the innermost name and its integer
    template arguments."""
    name, rest = mangled, mangled[3 if mangled.startswith("_ZN") else 2:]
    while rest[:1].isdigit():
        n = re.match(r"\d+", rest).group()
        name, rest = rest[len(n):len(n) + int(n)], rest[len(n) + int(n):]
    args = re.match(r"I((?:Li-?\d+E)+)E", rest)
    if args:
        name += "<" + ",".join(re.findall(r"-?\d+", args.group(1))) + ">"
    return name


def ptxas_usage(log: str) -> list:
    """'kernel<args>: N registers, S bytes spill stores, L bytes spill
    loads' for each kernel instantiation in an ``nvcc -Xptxas -v`` log."""
    usage, name, spill = [], "?", ""
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\w+)", ln)
        if m:
            name = _kernel_name(m.group(1))
        m = re.search(r"(\d+ bytes spill stores, \d+ bytes spill loads)", ln)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            usage.append(f"{name}: {m.group(1)} registers, {spill}")
    return usage


def phase_build(_build) -> None:
    secs = _build.build()
    usage = []
    for name in _build.SOURCES:
        log = _build.library_path(name).with_suffix(".log")
        usage += ptxas_usage(log.read_text() if log.exists() else "")
    print(f"build: {len(_build.SOURCES)} kernels in {secs:.2f}s "
          f"(sm_90a); " + "; ".join(usage), flush=True)


def phase_delta(torch, ops, ref, changed_blocks) -> dict:
    n, block, bpt = 256 << 20, 1 << 16, 8
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    new = torch.randint(0, 256, (n,), dtype=torch.uint8, device=dev,
                        generator=gen)
    old = new.clone()
    changed = [0, 1, 7, 8, 1000, 2047, n // block - 1]
    for i, blk in enumerate(changed):
        off = blk * block + (0, block - 1, 12345)[i % 3]
        old[off] = old[off] ^ 0xFF
    mask = ops.delta_mask(new, old, block=block, bpt=bpt)
    plain = ref.delta_mask_ref(new, old, block)
    torch.cuda.synchronize()
    host = changed_blocks(new.cpu().numpy().tobytes(),
                          old.cpu().numpy().tobytes(), block)
    got = torch.nonzero(mask).flatten().tolist()
    if not (torch.equal(mask, plain) and got == host == changed):
        raise AssertionError(f"delta_mask: kernel {got}, host {host}, "
                             f"expected {changed}")
    ms = time_ms(torch, lambda: ops.delta_mask(new, old, block=block,
                                               bpt=bpt))
    plain_ms = time_ms(torch, lambda: ref.delta_mask_ref(new, old, block))
    bound_ms = (2 * n + n // block) / HBM_BYTES_PER_S * 1e3
    print(f"delta_mask: {n >> 20} MiB, block {block}: exact vs plain and "
          f"host scan; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({2 * n / ms / 1e6:.0f} GB/s)", flush=True)
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}


def _attn_work(b, h, hk, s, d, dv, window, itemsize):
    """Flops of the unmasked (q, k) pairs and bytes of q, k, v, o."""
    pairs = sum(min(i + 1, window or s) for i in range(s))
    flops = b * h * pairs * 2 * (d + dv)
    nbytes = itemsize * (b * h * s * d + b * hk * s * (d + dv)
                         + b * h * s * dv)
    return flops, nbytes


def phase_flash(torch, ops, ref) -> dict:
    import torch.nn.functional as F
    dev = torch.device("cuda")
    gemma = (4, 4, 1, 256)  # B, H, Hk, D of gemma3-1b's prefill
    cases = [(gemma, torch.float32, 1024, 512),
             (gemma, torch.float32, 1024, None),
             (gemma, torch.bfloat16, 1024, 512),
             (gemma, torch.bfloat16, 1024, None),
             (gemma, torch.float32, 1000, 512),
             (gemma, torch.bfloat16, 1000, None),
             ((4, 64, 8, 128), torch.bfloat16, 1024, None)]  # Jamba's
    results = {}
    for (b, h, hk, d), dtype, s, window in cases:
        gen = torch.Generator(device=dev).manual_seed(s + (window or 0) + h)
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for shape in ((b, h, s, d), (b, hk, s, d),
                                 (b, hk, s, d)))
        out = ops.flash_attention(q, k, v, window=window)
        exp = ref.flash_attention_ref(q, k, v, window=window)
        torch.cuda.synchronize()
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        err = (out.float() - exp.float()).abs().max().item()
        ok = out.shape == exp.shape and out.dtype == dtype and bool(
            torch.isfinite(out).all()) and torch.allclose(
                out.float(), exp.float(), atol=tol, rtol=tol)
        ms = time_ms(torch, lambda: ops.flash_attention(q, k, v,
                                                        window=window))
        plain_ms = time_ms(torch, lambda: ref.flash_attention_ref(
            q, k, v, window=window))
        ke, ve = (t.repeat_interleave(h // hk, dim=1) for t in (k, v))
        if window is None:
            def lib():
                return F.scaled_dot_product_attention(q, ke, ve,
                                                      is_causal=True)
        else:
            i = torch.arange(s, device=dev)
            allowed = (i[None, :] <= i[:, None]) & (
                i[:, None] - i[None, :] < window)

            def lib():
                return F.scaled_dot_product_attention(q, ke, ve,
                                                      attn_mask=allowed)
        library_ms = time_ms(torch, lib)
        name = str(dtype).split(".")[-1]
        flops, nbytes = _attn_work(b, h, hk, s, d, d, window,
                                   q.element_size())
        t_ops = flops / PEAK_FLOPS[name] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ms = max(t_ops, t_bytes)
        path = "mma" if dtype == torch.bfloat16 else "tf32"
        label = (f"{name} B={b} H={h} Hk={hk} S={s} D={d} window={window} "
                 f"{path}")
        rate = f"at {PEAK_FLOPS[name] / 1e12:.1f} TFLOP/s"
        if dtype == torch.float32:
            rate += (f" (3xTF32); at the CUDA-core "
                     f"{CUDA_CORE_F32_FLOPS / 1e12:.0f} TFLOP/s "
                     f"{max(flops / CUDA_CORE_F32_FLOPS * 1e3, t_bytes):.4f}"
                     f" ms")
        print(f"flash_attention[{label}]: max_abs_err {err:.3e} (tol "
              f"{tol:g}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
              f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms {rate} "
              f"({flops / ms / 1e9:.1f} TFLOP/s)", flush=True)
        if not ok:
            raise AssertionError(f"flash_attention {label}: max abs err "
                                 f"{err}")
        results[(name, s, window, h)] = {
            "label": label, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms}
        del q, k, v, ke, ve, out, exp
    # the kernel's entry: gemma3-1b's own case (f32 prefill of a local
    # layer, 22 of its 26), with the worst error of all cases, and every
    # case beside it
    main = dict(results[("float32", 1024, 512, 4)])
    del main["label"]
    main["max_abs_err"] = max(r["max_abs_err"] for r in results.values())
    main["cases"] = [{key: r[key] for key in (
        "label", "ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")}
        for r in results.values()]
    return main


def phase_flash_bwd(torch, ops, ref, flash) -> dict:
    """The backward kernel at gemma3-1b's train shapes (f32): local layers
    (window 512), the global layer, and a ragged S. Its bound counts the
    five products (Q K^T, dO V^T, P^T dO, dS K, dS^T Q) over the pairs the
    band holds."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    b, h, hk, d = 4, 4, 1, 256
    results = {}
    for s, window in ((1024, 512), (1024, None), (1000, 512)):
        gen = torch.Generator(device=dev).manual_seed(7 * s + (window or 0))
        q, k, v = (torch.randn(shape, generator=gen, device=dev)
                   for shape in ((b, h, s, d), (b, hk, s, d), (b, hk, s, d)))
        dout = torch.randn((b, h, s, d), generator=gen, device=dev)
        # the forward kernel's output and log-sum-exp, as training keeps them
        out, lse = flash.flash_attention_cuda(q, k, v, causal=True,
                                              window=window, scale=None,
                                              with_lse=True)

        def kernel():
            return flash.flash_attention_bwd_cuda(
                q, k, v, out, dout, lse, causal=True, window=window,
                scale=None)
        got, again = kernel(), kernel()
        exp = ref.flash_attention_bwd_ref(q, k, v, out, dout, window=window)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"flash_attention_bwd S={s} window={window}"
                                 ": two launches differ")
        # f32 sums of up to H/Hk*S terms in another order than the plain
        # version's: within 1e-4 of each gradient's largest element
        err, ok = 0.0, True
        for x, e in zip(got, exp):
            scale = e.abs().max().item()
            e_x = (x - e).abs().max().item()
            err = max(err, e_x)
            ok &= x.shape == e.shape and bool(torch.isfinite(x).all()) \
                and e_x <= BWD_TOL * scale
        ms = time_ms(torch, kernel)
        plain_ms = time_ms(torch, lambda: ref.flash_attention_bwd_ref(
            q, k, v, out, dout, window=window))
        qr, kr, vr = (t.repeat_interleave(h // t.shape[1], dim=1).detach()
                      .requires_grad_() for t in (q, k, v))
        i = torch.arange(s, device=dev)
        allowed = i[None, :] <= i[:, None]
        if window is not None:
            allowed &= i[:, None] - i[None, :] < window
        o_lib = F.scaled_dot_product_attention(qr, kr, vr, attn_mask=allowed)
        library_ms = time_ms(torch, lambda: torch.autograd.grad(
            o_lib, (qr, kr, vr), dout, retain_graph=True))
        pairs = sum(min(r + 1, window or s) for r in range(s))
        flops = b * h * pairs * 2 * (3 * d + 2 * d)
        nbytes = 4 * (2 * b * h * s * d + 2 * b * hk * s * 2 * d
                      + 2 * b * h * s * d)  # q, dq; k, v, dk, dv; o, dO
        t_ops = flops / PEAK_FLOPS["float32"] * 1e3
        t_core = flops / CUDA_CORE_F32_FLOPS * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        label = (f"f32 B={b} H={h} Hk={hk} S={s} D={d} window={window} "
                 f"tf32")
        print(f"flash_attention_bwd[{label}]: max_abs_err {err:.3e} (tol "
              f"{BWD_TOL:g} of each gradient's max); two launches bit-equal; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa backward "
              f"{library_ms:.4f} ms; bound {max(t_ops, t_bytes):.4f} ms at "
              f"{PEAK_FLOPS['float32'] / 1e12:.1f} TFLOP/s (3xTF32), "
              f"{max(t_core, t_bytes):.4f} ms at the CUDA-core "
              f"{CUDA_CORE_F32_FLOPS / 1e12:.0f} TFLOP/s, bytes "
              f"{t_bytes:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s)",
              flush=True)
        if not ok:
            raise AssertionError(f"flash_attention_bwd {label}: max abs err "
                                 f"{err}")
        results[(s, window)] = {
            "label": label, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms}
        del q, k, v, dout, out, lse, got, again, exp, qr, kr, vr, o_lib
        torch.cuda.empty_cache()
    main = dict(results[(1024, 512)])  # the local layers, 5 of 6
    del main["label"]
    main["max_abs_err"] = max(r["max_abs_err"] for r in results.values())
    main["cases"] = [{key: r[key] for key in (
        "label", "ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")}
        for r in results.values()]
    return main


def phase_ssm(torch, ops, ref, ssm) -> dict:
    """The scan at the Jamba prefill shape, then a ragged S and D (16376 is
    not a multiple of the kernel's 16 d's a block). Decays are
    exp(-uniform(0, 0.5)), as Mamba's exp(dt*A) with a small dt."""
    dev = torch.device("cuda")
    tol = 1e-4  # FMA and shuffle-sum order vs mul, add and einsum, f32
    result = None
    for b, s, d, n in ((4, 1024, 16384, 16), (4, 1000, 16376, 16)):
        gen = torch.Generator(device=dev).manual_seed(s)
        decay = torch.rand((b, s, d, n), generator=gen, device=dev)
        decay = decay.mul_(-0.5).exp_()
        u = torch.randn((b, s, d, n), generator=gen, device=dev)
        c = torch.randn((b, s, n), generator=gen, device=dev)
        s0 = torch.randn((b, d, n), generator=gen, device=dev)
        y, fin = ops.ssm_scan(decay, u, c, s0)
        ey, efin = ref.ssm_scan_ref(decay, u, c, s0)
        torch.cuda.synchronize()
        err = max((y - ey).abs().max().item(),
                  (fin - efin).abs().max().item())
        ok = y.shape == ey.shape and fin.shape == efin.shape and bool(
            torch.isfinite(y).all()) and torch.allclose(
                y, ey, atol=tol, rtol=tol) and torch.allclose(
                    fin, efin, atol=tol, rtol=tol)
        label = f"f32 B={b} S={s} D={d} N={n}"
        del y, fin, ey, efin
        if not ok:
            raise AssertionError(f"ssm_scan {label}: max abs err {err}")
        if result is not None:  # the ragged case: checked, not timed
            print(f"ssm_scan[{label}]: max_abs_err {err:.3e} (tol {tol:g})",
                  flush=True)
            result["max_abs_err"] = max(result["max_abs_err"], err)
            continue
        ms = time_ms(torch, lambda: ops.ssm_scan(decay, u, c, s0))
        kept_ms = time_ms(torch, lambda: ssm.ssm_scan_cuda(
            decay, u, c, s0, with_bounds=True))
        plain_ms = time_ms(torch, lambda: ref.ssm_scan_ref(decay, u, c, s0))
        nbytes = 4 * (2 * b * s * d * n + b * s * n + 2 * b * d * n
                      + b * s * d)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"ssm_scan[{label}]: max_abs_err {err:.3e} (tol {tol:g}); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s); keeping "
              f"the boundary states for a backward {kept_ms:.4f} ms",
              flush=True)
        result = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                  "bound_ms": bound_ms, "bound_by": "bytes",
                  "library_ms": None}
        del decay, u, c, s0
        torch.cuda.empty_cache()
    return result


def phase_ssm_bwd(torch, ref, ssm) -> dict:
    """The scan's backward kernel at the Jamba train shape, then a ragged S
    and D, from the forward kernel's boundary states; decays as in
    ``phase_ssm`` with 1 % of them exactly 0 (exp(dt*A) underflows in f32).
    Its bound counts the bytes of the function's inputs (decay, u, c,
    state0, dy) and outputs (d_decay, d_u, d_c, d_state0)."""
    dev = torch.device("cuda")
    result = None
    for b, s, d, n in ((4, 1024, 16384, 16), (4, 1000, 16376, 16)):
        gen = torch.Generator(device=dev).manual_seed(3 * s)
        decay = torch.rand((b, s, d, n), generator=gen, device=dev)
        decay = decay.mul_(-0.5).exp_()
        decay[torch.rand((b, s, d, n), generator=gen, device=dev) < 0.01] = 0
        u = torch.randn((b, s, d, n), generator=gen, device=dev)
        c = torch.randn((b, s, n), generator=gen, device=dev)
        s0 = torch.randn((b, d, n), generator=gen, device=dev)
        dy = torch.randn((b, s, d), generator=gen, device=dev)
        _, _, bounds = ssm.ssm_scan_cuda(decay, u, c, s0, with_bounds=True)
        # the plain scan's state entering each chunk
        st, bound_err = s0, 0.0
        for k in range(bounds.shape[1]):
            bound_err = max(bound_err, (bounds[:, k] - st).abs().max().item())
            t0, t1 = k * ssm.CHUNK, min(s, (k + 1) * ssm.CHUNK)
            _, st = ref.ssm_scan_ref(decay[:, t0:t1], u[:, t0:t1],
                                     c[:, t0:t1], st)
        if bound_err > 1e-4:
            raise AssertionError(f"ssm_scan boundary states: max abs err "
                                 f"{bound_err}")

        def kernel():
            return ssm.ssm_scan_bwd_cuda(decay, u, c, bounds, dy)
        got, again = kernel(), kernel()
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"ssm_scan_bwd B={b} S={s} D={d}: two "
                                 "launches differ")
        del again
        exp = ref.ssm_scan_bwd_ref(decay, u, c, s0, dy)
        # f32 sums in another order (FMA, shuffles, partials) than the
        # plain version's: within 1e-4 of each gradient's largest element
        err, worst, ok = 0.0, 0.0, True
        for x, e in zip(got, exp):
            e_x = (x - e).abs().max().item()
            rel = e_x / e.abs().max().item()
            err, worst = max(err, e_x), max(worst, rel)
            ok &= x.shape == e.shape and bool(torch.isfinite(x).all()) \
                and rel <= BWD_TOL
        del got, exp
        torch.cuda.empty_cache()
        label = f"f32 B={b} S={s} D={d} N={n}"
        if not ok:
            raise AssertionError(f"ssm_scan_bwd {label}: max abs err {err}")
        if result is not None:  # the ragged case: checked, not timed
            print(f"ssm_scan_bwd[{label}]: max_abs_err {err:.3e}, "
                  f"{worst:.3e} of its gradient's max (tol {BWD_TOL:g}); two "
                  f"launches bit-equal; boundary states max abs err "
                  f"{bound_err:.3e}", flush=True)
            result["max_abs_err"] = max(result["max_abs_err"], err)
            continue
        ms = time_ms(torch, kernel)
        plain_ms = time_ms(torch, lambda: ref.ssm_scan_bwd_ref(
            decay, u, c, s0, dy))
        nbytes = 4 * (4 * b * s * d * n + b * s * d + 2 * b * s * n
                      + 2 * b * d * n)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"ssm_scan_bwd[{label}]: max_abs_err {err:.3e}, {worst:.3e} "
              f"of its gradient's max (tol {BWD_TOL:g}); two launches "
              f"bit-equal; boundary states max abs err {bound_err:.3e} (tol "
              f"1e-4); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s); library: "
              f"none (no single call)", flush=True)
        result = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                  "bound_ms": bound_ms, "bound_by": "bytes",
                  "library_ms": None}
        del decay, u, c, s0, dy, bounds
        torch.cuda.empty_cache()
    return result


def phase_reference(torch, Model, RunConfig, get_config, tree_to_torch,
                    arch) -> None:
    """The card's path (kernels) against the CPU's (plain versions) on the
    same reduced weights: prefill 48 tokens, then 4 steps, f32."""
    cfg = get_config(arch)
    rc = RunConfig(param_dtype=torch.float32, cache_dtype=torch.float32)
    cpu, dev = Model(cfg, rc, "cpu"), Model(cfg, rc, "cuda")
    params_cpu = cpu.init(0)
    params_dev = tree_to_torch(params_cpu, "cuda")
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 52), generator=gen)
    c_cpu, c_dev = cpu.init_cache(2, 52), dev.init_cache(2, 52)
    l_cpu, c_cpu = cpu.prefill(params_cpu, toks[:, :48], c_cpu)
    l_dev, c_dev = dev.prefill(params_dev, toks[:, :48].cuda(), c_dev)
    worst = (l_dev.cpu() - l_cpu).abs().max().item()
    for step in range(4):
        t = toks[:, 48 + step:49 + step]
        l_cpu, c_cpu = cpu.decode_step(params_cpu, t, 48 + step, c_cpu)
        l_dev, c_dev = dev.decode_step(params_dev, t.cuda(), 48 + step,
                                       c_dev)
        worst = max(worst, (l_dev.cpu() - l_cpu).abs().max().item())
        if not torch.allclose(l_dev.cpu(), l_cpu, atol=1e-4, rtol=1e-4):
            raise AssertionError(f"reference {arch}: step {step} logits "
                                 f"differ by {worst}")
    print(f"reference: {arch} prefill 2x48 + 4 decode steps, card vs CPU "
          f"max abs logit diff {worst:.3e} (tol 1e-4)", flush=True)


def phase_train_reference(torch, Model, RunConfig, get_config,
                          tree_to_torch, tree_leaves, arch) -> None:
    """``arch``'s train loss and every gradient on the card (flash forward
    and backward kernels; for Jamba also the scan's) against the same
    weights and batch on the CPU (plain versions), f32: S = 100 in 64-token
    loss chunks."""
    cfg = get_config(arch)
    rc = RunConfig(param_dtype=torch.float32, cache_dtype=torch.float32,
                   loss_chunk=64)
    cpu, dev = Model(cfg, rc, "cpu"), Model(cfg, rc, "cuda")
    params = {"cpu": cpu.init(0)}
    params["cuda"] = tree_to_torch(params["cpu"], "cuda")
    gen = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (2, 101), generator=gen)
    out = {}
    for where, model in (("cpu", cpu), ("cuda", dev)):
        leaves = tree_leaves(params[where])
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = model.loss(params[where], {
            "tokens": toks[:, :-1].to(model.device),
            "labels": toks[:, 1:].to(model.device)})
        out[where] = (loss.item(), [g.cpu() for g in torch.autograd.grad(
            loss, leaves)])
    worst = 0.0
    for g_cpu, g_dev in zip(out["cpu"][1], out["cuda"][1]):
        err = (g_dev - g_cpu).abs().max().item()
        worst = max(worst, err / max(g_cpu.abs().max().item(), 1e-30))
    loss_err = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    print(f"reference: {arch} train loss 2x100, card vs CPU "
          f"relative loss diff {loss_err:.3e}, worst gradient diff "
          f"{worst:.3e} of its leaf's max (tol 1e-4)", flush=True)
    if loss_err > 1e-5 or worst > 1e-4:
        raise AssertionError(f"reference train {arch}: card and CPU differ")


def phase_serve(torch, serve, launches, label, args, needs, cfg) -> dict:
    """Serve ``cfg`` with a node kill at 20, then uninterrupted, then
    without snapshots; the kernels in ``needs`` must launch on the first
    run."""
    for k in launches:
        launches[k] = 0
    toks, stats = serve.main(args + ["--inject-failure", "20"], cfg=cfg)
    counts = dict(launches)
    torch.cuda.empty_cache()
    ref_toks, ref_stats = serve.main(args, cfg=cfg)
    torch.cuda.empty_cache()
    # decode alone: no snapshot, so no cluster thread competes for the host
    _, bare = serve.main(args + ["--snapshot-every", "0"], cfg=cfg)
    torch.cuda.empty_cache()
    if not (stats["logits_finite"] and ref_stats["logits_finite"]):
        raise AssertionError(f"{label}: non-finite logits")
    if toks.shape != (4, 32) or not (toks >= 0).all() \
            or not (toks < cfg.vocab_size).all():
        raise AssertionError(f"{label}: tokens {toks.shape}")
    if not ((toks == ref_toks).all()
            and stats["logits_crc"] == ref_stats["logits_crc"]):
        raise AssertionError(f"{label}: the resumed session differs from "
                             "the uninterrupted run")
    if min(counts[k] for k in needs) <= 0 or counts != stats["launches"]:
        raise AssertionError(f"{label}: kernel launches {counts}")
    peak = max(s["peak_bytes"] for s in (stats, ref_stats, bare))
    print(f"{label}: batch 4, prompt 1024, 32 tokens; prefill "
          f"{stats['prefill_s']:.4f} s; decode {stats['decode_tok_s']:.2f} "
          f"tok/s ({stats['decode_s']:.3f} s: {stats['decode_steps']} steps "
          f"of {stats['decode_step_ms']:.2f} ms, {stats['snapshots']} "
          f"snapshots {stats['snapshot_s']:.3f} s, of which delta scans "
          f"{stats['scan_s']:.3f} s); failover "
          f"{stats['failover_s']:.4f} s; bytes_logged/bytes_full "
          f"{stats['bytes_logged']}/{stats['bytes_full']} = "
          f"{stats['bytes_logged'] / stats['bytes_full']:.4f}; uninterrupted "
          f"decode {ref_stats['decode_tok_s']:.2f} tok/s (prefill "
          f"{ref_stats['prefill_s']:.4f} s); without snapshots "
          f"{bare['decode_tok_s']:.2f} tok/s ({bare['decode_step_ms']:.2f} "
          f"ms a step); peak memory {peak} bytes ({peak / 1e9:.2f} GB); "
          f"tokens and final logits equal; launches {counts}", flush=True)
    return counts


def train_kill_and_resume(torch, train, launches, label, args, cfg, needs):
    """Train ``cfg`` with a node kill after step 7 (checkpoints after steps
    2 and 5; resume at 6), then uninterrupted without checkpoints: the
    losses from the resumed step on and the final parameters must be
    bit-equal, and the kernels in ``needs`` must launch on the kill run.
    Returns (losses, stats, uninterrupted stats, the kill run's
    launches)."""
    for k in launches:
        launches[k] = 0
    losses, stats = train.main(args + KILL_ARGS, cfg=cfg)
    counts = dict(launches)
    torch.cuda.empty_cache()
    ref, ref_stats = train.main(args + ["--steps", "8", "--ckpt-every", "0"],
                                cfg=cfg)
    torch.cuda.empty_cache()
    if not all(map(math.isfinite, losses + ref)):
        raise AssertionError(f"{label}: non-finite losses {losses}, {ref}")
    # a random init with 0.02-scaled embeddings starts at ~ln(vocab)
    if abs(losses[0] - math.log(cfg.vocab_size)) > 0.5:
        raise AssertionError(f"{label}: first loss {losses[0]}")
    if not (len(losses) == 9 and losses[:7] == ref[:7]
            and losses[7:] == ref[6:]
            and stats["params_crc"] == ref_stats["params_crc"]):
        raise AssertionError(f"{label}: the resumed run differs from the "
                             f"uninterrupted one: {losses} vs {ref}, crc "
                             f"{stats['params_crc']} vs "
                             f"{ref_stats['params_crc']}")
    if min(counts[k] for k in needs) <= 0 or counts != stats["launches"]:
        raise AssertionError(f"{label}: kernel launches {counts}")
    print(f"{label}: batch 4, seq 1024, 8 steps (+2 re-run after the "
          f"failover); step {stats['step_ms']:.1f} ms; {stats['saves']} "
          f"checkpoints {stats['ckpt_s']:.3f} s, of which delta scans "
          f"{stats['scan_s']:.3f} s; failover {stats['failover_s']:.3f} s; "
          f"bytes_logged/bytes_full {stats['bytes_logged']}/"
          f"{stats['bytes_full']} = "
          f"{stats['bytes_logged'] / stats['bytes_full']:.4f}; loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; uninterrupted step "
          f"{ref_stats['step_ms']:.1f} ms; peak memory "
          f"{stats['peak_bytes']} bytes ({stats['peak_bytes'] / 1e9:.2f} "
          f"GB); losses from step 6 and final params CRC equal; launches "
          f"{counts}", flush=True)
    return counts


def phase_train(torch, train, launches, get_config, Stage) -> dict:
    """Train gemma3-1b's first superblock at full width with a node kill
    and a bit-exact resume, then 2 steps of the whole model; then
    jamba-1.5-large-398b-reduced with the same kill and resume, and 3 steps
    of full-width Jamba-1.5-Large cut to its first layer. Returns the
    kernel launches of the kill runs and the Jamba L0 run, summed."""
    gemma = get_config("gemma3-1b")
    cut = dataclasses.replace(gemma, stages=(
        Stage(block=gemma.stages[0].block, repeat=1),))
    counts = train_kill_and_resume(
        torch, train, launches, "train gemma3-1b 6 layers f32", TRAIN_ARGS,
        cut, ("delta_mask", "flash_attention", "flash_attention_bwd"))
    full, full_stats = train.main(TRAIN_ARGS + [
        "--arch", "gemma3-1b", "--steps", "2", "--ckpt-every", "0"])
    torch.cuda.empty_cache()
    if not all(map(math.isfinite, full)):
        raise AssertionError(f"train gemma3-1b 26 layers: losses {full}")
    print(f"train gemma3-1b 26 layers f32: batch 4, seq 1024, 2 steps; step "
          f"{full_stats['step_ms']:.1f} ms; loss {full[0]:.4f} -> "
          f"{full[-1]:.4f}; peak memory {full_stats['peak_bytes']} bytes "
          f"({full_stats['peak_bytes'] / 1e9:.2f} GB); launches "
          f"{full_stats['launches']}", flush=True)
    # Jamba's hybrid superblock (7 Mamba, 1 attention, 4 MoE): small
    # leaves, so 4096-byte delta blocks bring them to the delta_mask kernel
    jcounts = train_kill_and_resume(
        torch, train, launches, "train jamba-1.5-large-398b-reduced f32",
        TRAIN_ARGS + ["--delta-block", "4096"],
        get_config("jamba-1.5-large-398b-reduced"),
        ("delta_mask", "flash_attention", "flash_attention_bwd", "ssm_scan",
         "ssm_scan_bwd"))
    jamba = get_config("jamba-1.5-large-398b")
    l0 = dataclasses.replace(jamba, stages=(
        Stage(block=jamba.stages[0].block[:1], repeat=1),))
    for k in launches:
        launches[k] = 0
    losses, stats = train.main(TRAIN_ARGS + [
        "--steps", str(JAMBA_TRAIN_STEPS), "--ckpt-every", "0"], cfg=l0)
    lcounts = dict(launches)
    torch.cuda.empty_cache()
    label = "train jamba-1.5-large L0 (Mamba + dense) f32"
    if not all(map(math.isfinite, losses)) \
            or len(losses) != JAMBA_TRAIN_STEPS:
        raise AssertionError(f"{label}: losses {losses}")
    if min(lcounts[k] for k in ("ssm_scan", "ssm_scan_bwd")) <= 0 \
            or lcounts != stats["launches"]:
        raise AssertionError(f"{label}: kernel launches {lcounts}")
    print(f"{label}: batch 4, seq 1024, {JAMBA_TRAIN_STEPS} steps, no "
          f"checkpoints; step {stats['step_ms']:.1f} ms; loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} ({losses}); peak memory "
          f"{stats['peak_bytes']} bytes ({stats['peak_bytes'] / 1e9:.2f} GB)"
          f"; launches {lcounts}", flush=True)
    return {k: counts[k] + jcounts[k] + lcounts[k] for k in counts}


def run_train_phase(torch) -> dict:
    """``phase_train`` in a process of its own, which this one waits for:
    its deterministic train step needs ``CUBLAS_WORKSPACE_CONFIG`` before
    the process's first cuBLAS call, and here that setting would also slow
    the serve phases' decode (``tools/serve_ab.py``). Echoes its lines and
    returns its kernel launches."""
    torch.cuda.empty_cache()
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    proc = subprocess.run([sys.executable, __file__, "--train-phase"],
                          env=env, stdout=subprocess.PIPE, text=True,
                          timeout=1000)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0:
        print("\n".join(lines), flush=True)
        raise RuntimeError(f"train phase: exit code {proc.returncode}")
    print("\n".join(lines[:-1]), flush=True)
    return json.loads(lines[-1])


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (PORT / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {PORT} not found; run from a checkout of the "
              "repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(PORT.parent))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.ckpt.delta import changed_blocks
    from repro_torch.configs import get_config
    from repro_torch.configs.base import Stage
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import ssm_scan as ssm
    from repro_torch.launch import serve, train
    from repro_torch.models.transformer import Model, RunConfig
    from repro_torch.weights import tree_leaves, tree_to_torch

    if argv == ["--train-phase"]:  # run_train_phase's process
        print(json.dumps(phase_train(torch, train, ops.LAUNCHES, get_config,
                                     Stage)))
        return 0
    t0 = time.time()
    phase_device(torch)
    phase_build(_build)
    kernels = {"delta_mask": phase_delta(torch, ops, ref, changed_blocks),
               "flash_attention": phase_flash(torch, ops, ref),
               "ssm_scan": phase_ssm(torch, ops, ref, ssm),
               "flash_attention_bwd": phase_flash_bwd(torch, ops, ref,
                                                      flash),
               "ssm_scan_bwd": phase_ssm_bwd(torch, ref, ssm)}
    for arch in ("gemma3-1b-reduced", "jamba-1.5-large-398b-reduced"):
        phase_reference(torch, Model, RunConfig, get_config, tree_to_torch,
                        arch)
        phase_train_reference(torch, Model, RunConfig, get_config,
                              tree_to_torch, tree_leaves, arch)
    counts = phase_serve(torch, serve, ops.LAUNCHES, "serve gemma3-1b f32",
                         SERVE_ARGS, ("delta_mask", "flash_attention"),
                         get_config("gemma3-1b"))
    jamba = get_config("jamba-1.5-large-398b")
    cut = dataclasses.replace(jamba, stages=(
        Stage(block=jamba.stages[0].block[:JAMBA_LAYERS], repeat=1),))
    jcounts = phase_serve(torch, serve, ops.LAUNCHES,
                          f"serve jamba-1.5-large {JAMBA_LAYERS} layers bf16",
                          JAMBA_ARGS, ("delta_mask", "flash_attention",
                                       "ssm_scan"), cut)
    tcounts = run_train_phase(torch)
    counts = {k: counts[k] + jcounts[k] + tcounts[k] for k in counts}
    where = {"delta_mask": ("src/repro_torch/kernels/csrc/delta_mask.cu",
                            "src/repro/kernels/delta_encode.py:37"),
             "flash_attention": (
                 "src/repro_torch/kernels/csrc/flash_attention.cu",
                 "src/repro/kernels/flash_attention.py:89"),
             "ssm_scan": ("src/repro_torch/kernels/csrc/ssm_scan.cu",
                          "src/repro/kernels/ssm_scan.py:66"),
             # no Pallas backward: jax.value_and_grad differentiates the jnp
             # attention (src/repro/models/attention.py, chunked) there
             "flash_attention_bwd": (
                 "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                 "src/repro/launch/train.py:36 (jax.value_and_grad of the "
                 "jnp chunked attention; the JAX package has no backward "
                 "kernel)"),
             "ssm_scan_bwd": (
                 "src/repro_torch/kernels/csrc/ssm_scan_bwd.cu",
                 "src/repro/models/ssm.py:78 (jax.value_and_grad of the jnp "
                 "associative scan; the JAX package has no backward "
                 "kernel)")}
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": where[name][0],
         "replaces": where[name][1], "launches": counts[name], **res}
        for name, res in kernels.items()]}
    print(f"total: {time.time() - t0:.1f} s", flush=True)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

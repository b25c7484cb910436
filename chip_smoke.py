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
             D=16376) against its plain version; kernel, plain, bound ms
  reference  gemma3-1b-reduced and jamba-1.5-large-398b-reduced prefill +
             decode on the card against the same weights on the CPU, f32
  serve      full-width gemma3-1b (f32) through repro_torch.launch.serve:
             batch 4, prompt 1024, 32 tokens, a delta snapshot every 8, a
             node kill and failover at 20; tokens and final logits equal to
             an uninterrupted run; delta_mask and flash_attention launched
             on that path; then the same decode without snapshots
  jamba      the same serve of the first 4 layers of Jamba-1.5-Large's
             superblock at full width, in bf16 (Mamba + dense, Mamba + MoE,
             Mamba + dense, attention + MoE: 23.0e9 parameters);
             ssm_scan, flash_attention and delta_mask launched on that path
Then one JSON line with every kernel's numbers (launches summed over the
two serve runs with a node kill; flash_attention's entry is gemma3-1b's
f32 case, with every case under "cases"), and the last line {"ok": true,
"device": {...}}. Times are CUDA-event medians of 20 runs.
"""
from __future__ import annotations

import dataclasses
import json
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
SERVE_ARGS = ["--arch", "gemma3-1b", "--batch", "4", "--prompt-len", "1024",
              "--gen", "32", "--snapshot-every", "8", "--seed", "0"]
JAMBA_ARGS = ["--batch", "4", "--prompt-len", "1024", "--gen", "32",
              "--snapshot-every", "8", "--seed", "0", "--dtype", "bfloat16"]
JAMBA_LAYERS = 4  # of the 8-layer superblock: one superblock is 90.5 GB


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


def phase_ssm(torch, ops, ref) -> dict:
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
        plain_ms = time_ms(torch, lambda: ref.ssm_scan_ref(decay, u, c, s0))
        nbytes = 4 * (2 * b * s * d * n + b * s * n + 2 * b * d * n
                      + b * s * d)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"ssm_scan[{label}]: max_abs_err {err:.3e} (tol {tol:g}); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s)", flush=True)
        result = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                  "bound_ms": bound_ms, "bound_by": "bytes",
                  "library_ms": None}
        del decay, u, c, s0
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


def main() -> int:
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
    from repro_torch.launch import serve
    from repro_torch.models.transformer import Model, RunConfig
    from repro_torch.weights import tree_to_torch

    t0 = time.time()
    phase_device(torch)
    phase_build(_build)
    kernels = {"delta_mask": phase_delta(torch, ops, ref, changed_blocks),
               "flash_attention": phase_flash(torch, ops, ref),
               "ssm_scan": phase_ssm(torch, ops, ref)}
    for arch in ("gemma3-1b-reduced", "jamba-1.5-large-398b-reduced"):
        phase_reference(torch, Model, RunConfig, get_config, tree_to_torch,
                        arch)
    counts = phase_serve(torch, serve, ops.LAUNCHES, "serve gemma3-1b f32",
                         SERVE_ARGS, ("delta_mask", "flash_attention"),
                         get_config("gemma3-1b"))
    jamba = get_config("jamba-1.5-large-398b")
    cut = dataclasses.replace(jamba, stages=(
        Stage(block=jamba.stages[0].block[:JAMBA_LAYERS], repeat=1),))
    jcounts = phase_serve(torch, serve, ops.LAUNCHES,
                          f"serve jamba-1.5-large {JAMBA_LAYERS} layers bf16",
                          JAMBA_ARGS, tuple(kernels), cut)
    counts = {k: counts[k] + jcounts[k] for k in counts}
    where = {"delta_mask": ("src/repro_torch/kernels/csrc/delta_mask.cu",
                            "src/repro/kernels/delta_encode.py:37"),
             "flash_attention": (
                 "src/repro_torch/kernels/csrc/flash_attention.cu",
                 "src/repro/kernels/flash_attention.py:89"),
             "ssm_scan": ("src/repro_torch/kernels/csrc/ssm_scan.cu",
                          "src/repro/kernels/ssm_scan.py:66")}
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
    sys.exit(main())

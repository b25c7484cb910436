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
             bf16; ragged S=1000), at Jamba's (bf16, B=4, H=64, Hk=8,
             S=1024, D=128, global), at minicpm3-4b's MLA heads (f32
             and bf16, B=4, H=Hk=40, S=1024, D=96, Dv=64), at
             musicgen-large's (f32, B=4, H=Hk=32, S=64+1024, D=64), at
             qwen2-vl-2b's (f32, B=4, H=12, Hk=2, S=256+1024, D=128), at
             deepseek-moe-16b's (bf16 and f32, B=4, H=Hk=16, S=1024,
             D=128, global), at stablelm-12b's (bf16 and f32, B=4, H=32,
             Hk=8, S=1024, D=160), at phi3.5-moe's (bf16, H=32, Hk=8,
             D=128) and at qwen1.5-32b's (bf16, H=Hk=40, D=128) against
             its plain version; two launches bit-equal (f32 and
             bf16); kernel, plain, bound and library
             (scaled_dot_product_attention) ms, the kernels' device ms
             alone (torch.profiler; f32: the pre-pass included), apart from
             the host's work in a single call, and that host work: the
             host's µs a call with the card running behind (host_us; at
             D=160 both dtypes run instantiations of their own); each
             line names the
             kernel's path, wgmma (bf16) or wgmma-tf32 (f32 as 3xTF32),
             both warpgroup products fed by TMA, the rate its bound
             assumes, and where the kernel computes wider than D and Dv
             (f32: D to 8, Dv to chunks of 64; bf16: D to 16, Dv to 8), the
             bound of the padded work
  decode     the GQA decode-attention kernel at mistral-nemo-12b's chat
             shape (bf16, B=48, H=32, Hk=8, D=128, a 1,152-row cache at
             position 1,088) and at one row of a 32k cache (position
             32,767, split by the wrapper) against its plain version;
             kernel (card), device (torch.profiler) and plain ms, the
             host's µs a call, the bytes bound, and SDPA with enable_gqa
             over the live rows as the library yardstick (the port never
             calls it)
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
             none; ragged S=1000), minicpm3-4b's (f32, B=4, H=Hk=40,
             S=1024, D=96, Dv=64), musicgen-large's (H=Hk=32, S=1088, D=64),
             qwen2-vl-2b's (H=12, Hk=2, S=1280, D=128; a GQA group of 6 in
             its group sum), deepseek-moe-16b's (H=Hk=16, S=1024,
             D=128) and stablelm-12b's (H=32, Hk=8, S=1024, D=160: its
             own instantiations, dK^T and dV^T as three m64 tiles, so
             192 rows wide), fed the forward kernel's output and
             log-sum-exp, against its plain version; two launches
             bit-equal; kernel, plain, bound and library (the backward of
             scaled_dot_product_attention) ms, the five kernels' device
             ms alone (torch.profiler) and the host's µs a call
             (host_us); each line names the path, wgmma-tf32 (3xTF32
             warpgroup products on tiles that TMA brings), the dK/dV and
             dQ instantiations that ran, and where the products run
             wider than D or Dv, the bound of the padded work
  reference  gemma3-1b-reduced, jamba-1.5-large-398b-reduced,
             rwkv6-1.6b-reduced, minicpm3-4b-reduced, qwen2-vl-2b-reduced,
             musicgen-large-reduced, qwen1.5-32b-reduced,
             stablelm-12b-reduced (also once with its published 160-wide
             heads, 4 on 1 kv head), phi3.5-moe-42b-a6.6b-reduced and
             deepseek-moe-16b-reduced (its MoE
             stage stacked twice) prefill + decode on the card against the
             same weights on the CPU, f32 (qwen2-vl and musicgen with 4
             random front-end embeddings before the prompt, decoding after
             them); each arch's train loss and gradients likewise;
             deepseek-moe-16b-reduced once more with the RunConfig knobs
             set: capacity_factor=0.1 and moe_groups=1 serving, remat=False
             training
  roofline   beside the build and the kernel phases, a process on no card
             counts one step of every serve and train phase below on the
             meta device (repro_torch.roofline: counted FLOPs and bytes,
             the five kernels' analytic work, the compulsory bytes)
  dryrun     beside them too, a process on no card runs five production
             cells of repro_torch.launch.dryrun on a fake group of 512
             ranks (DTensors of meta shards): gemma3-1b train_4k pod1
             (dp_zero1, ZeRO-1), qwen1.5-32b prefill_32k pod1 (tp_fsdp,
             head_pad 16), stablelm-12b decode_32k pod2 (the 512-rank
             mesh), deepseek-moe-16b decode_32k pod1 (experts over model)
             and rwkv6-1.6b long_500k pod1 (batch 1, seq-sharded state);
             a line each: one chip's argument GB, counted TFLOP and GB,
             collective counts and wire GB, roofline terms at H100
             constants; each must count a collective unless its policy
             needs none, which the line then says
  mesh       gemma3-1b at full width, f32, over make_debug_mesh(1, 1) (a
             one-rank NCCL group), laid out by the sharding rules with
             run_config_for's hook: prefill 4 x 1024 and 8 greedy steps,
             tokens and every step's logits bit-equal to the plain run,
             flash_attention launched through ops' DTensor branch and
             decode_attention on the local shards; the same
             prefill at head_pad=8 (8 query heads on 1 kv head) within
             1e-4; ms and peak GB. In the train process (below), one step
             of gemma3-1b's 6-layer cut over the mesh (ZeRO-1 moments):
             loss and parameters' CRC bit-equal to the plain step
  serve      full-width gemma3-1b (f32) through repro_torch.launch.serve:
             batch 4, prompt 1024, 32 tokens, a delta snapshot every 8, a
             node kill and failover at 20; tokens and final logits equal to
             an uninterrupted run; delta_mask, flash_attention and
             decode_attention launched on that path (and on every serve
             path of an attention model below: all but rwkv6's and MLA's);
             then the same decode without snapshots
  jamba      the same serve of the first 4 layers of Jamba-1.5-Large's
             superblock at full width, in bf16 (Mamba + dense, Mamba + MoE,
             Mamba + dense, attention + MoE: 23.0e9 parameters);
             ssm_scan, flash_attention and delta_mask launched on that path
  rwkv6      the same serve of full-width rwkv6-1.6b (f32, 24 layers, a
             52 MB session state of shifts and wkv states): delta_mask
  minicpm3   the same serve of full-width minicpm3-4b cut to its first
             16 of 62 MLA layers (f32, a compressed 78 MB cache):
             delta_mask and flash_attention (D=96, Dv=64) launched on that
             path; then the whole 62 layers once without snapshots (a
             302 MB cache): prefill and 32 decode steps, tokens in range
             and logits finite
  qwen2-vl   the same serve of full-width qwen2-vl-2b cut to its first 14
             of 28 layers (f32, GQA 12 on 2 heads): 256 stub patch
             embeddings prefilled before each 1024-token prompt, decode
             from position 1280, a 150 MB KV cache; delta_mask and
             flash_attention launched
  musicgen   the same serve of full-width musicgen-large cut to its first
             4 of 48 layers (f32, MHA 32 heads of 64, sinusoidal
             positions, 64 conditioning embeddings before each prompt, a
             0.29 GB KV cache); then the whole 48 layers once without
             snapshots (a 3.52 GB cache): prefill and 32 decode steps,
             tokens in range and logits finite
  deepseek   the same serve of full-width deepseek-moe-16b in bf16 cut to
             its dense layer 0 and its first 4 MoE layers (MHA 16 heads of
             128, 64 routed experts top 6 and 2 shared; 2.85e9 parameters,
             a 0.17 GB KV cache): delta_mask and flash_attention launched
             on that path
  stablelm   the same serve of stablelm-12b in bf16 cut to its first 10
             of 40 layers (GQA 32 on 8 heads of 160, layernorm, a 0.22 GB
             KV cache): delta_mask and flash_attention (D=160) launched on
             that path; then the whole 40 layers once without snapshots
             (12.1e9 parameters, a 0.87 GB KV cache)
  phi3.5     phi3.5-moe-42b-a6.6b cut to its first 12 of 32 layers (bf16,
             GQA 32 on 8 heads of 128, 16 experts top 2 in every layer:
             15.9e9 parameters; the whole model is 83.7 GB) and
  qwen1.5    qwen1.5-32b cut to its first 32 of 64 layers (bf16, MHA 40
             heads of 128, qkv bias, 152,064 vocabulary: 18.4e9
             parameters; the whole model is 70.4 GB), each served once
             without snapshots: prefill and 32 decode steps, tokens in
             range and logits finite, flash_attention launched
  moe_knobs  the whole deepseek-moe-16b in bf16, one set of weights,
             through prefill and decode_step: prefill 4 x 1024 and 8 greedy
             steps with the defaults; with capacity_factor=0.1 twice
             (every step's logits bit-equal, the prefill's unequal to the
             defaults'); with capacity_factor=64/6 (nothing drops) under
             the policy's four groups and under moe_groups=1 (prefill
             logits within 2^-3); prefill and decode ms of each
  examples   the three example twins (examples/*_torch.py) on the card:
             quickstart's finite loss and its read after failover; the
             serve twin (rwkv6-1.6b-reduced, a kill at token 24) equal to
             an uninterrupted run; the train twin (gemma3-1b-reduced, 14
             steps, a kill after the tenth) resumed bit for bit
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
             without checkpoints; then rwkv6-1.6b-reduced and
             minicpm3-4b-reduced with the same kill and bit-exact resume
             (4096-byte delta blocks; MLA launches flash_attention and
             its backward), and 2 steps each of the whole rwkv6-1.6b and
             of full-width minicpm3-4b cut to its first 8 layers (one
             stacked stage, recomputed); then qwen2-vl-2b-reduced and
             musicgen-large-reduced with the same kill and bit-exact resume
             (the pipeline's front-end embeddings for each step), and 2
             steps each of the whole qwen2-vl-2b and the whole
             musicgen-large, flash_attention and its backward launched at
             S = 1024 + 256 and 1024 + 64; then deepseek-moe-16b cut to
             its dense layer 0 and 4 stacked MoE layers (f32, 2.85e9
             parameters), 2 steps with recompute (remat) and 2 without:
             losses and parameters' CRC bit-equal, step ms and peak GB of
             each, and the counted FLOPs that recompute adds (checked
             equal to the MoE layers' forward less each layer's shared
             experts' down projection, which torch's checkpoint does not
             recompute); then stablelm-12b cut to its first 4 of 40
             layers (f32, 2.14e9 parameters, a 34.2 GB train state), 2
             steps, flash_attention and its backward launched at D=160.
             The examples and train phases
             run in a child process with CUBLAS_WORKSPACE_CONFIG set, which
             the deterministic train step needs and which would slow the
             serve phases' decode
Each serve and train line ends with its phase's seconds and is followed by
a line for each of its steps (prefill and decode; train):
  roofline <label> <kind>: counted F TFLOP, B GB (min M GB), bound T ms
  (<dominant>), measured X ms, roofline_fraction R, model-flops share S;
  bound/measured Q; kernels K of the FLOPs
T is the larger of the counted FLOPs at the card's peak for the step's
dtype and the counted bytes at its memory rate; X is the least prefill of
the phase's three serve runs, the decode step without snapshots, or the
mean train step of the run without checkpoints (deepseek-moe-16b's with
and without recompute); R is repro_torch.roofline's (the model FLOPs, 6 or
2 x active parameters x rows, at the peak, over T);
S is model over counted FLOPs. Then one JSON line {"roofline": [...]}, an
entry for each of those steps; one JSON line {"dryrun": [...]}, the five
cells' counted terms; one JSON line with every kernel's numbers
(launches summed over the main-path runs: the eight serve runs with a
node kill and the five served once (the whole minicpm3-4b, musicgen-large
and stablelm-12b, phi3.5-moe's 12 layers, qwen1.5-32b's 32), the moe_knobs
runs, the quickstart and the two example runs with a kill, the six train
runs with a node kill, and the Jamba L0, gemma3-1b 26-layer, rwkv6-1.6b,
minicpm3 8-layer, qwen2-vl-2b, musicgen-large, both deepseek-moe-16b and the
stablelm-12b 4-layer train runs,
and the mesh phase's runs (serve and head_pad, and the mesh train step);
flash_attention's entry is gemma3-1b's f32 case, flash_attention_bwd's its
window-512 train case, each with every case under "cases"; each bound from
the work function in the kernel's module),
and the last line {"ok": true, "device": {...}}. Kernel times are CUDA-event
medians of 20 runs.
"""
from __future__ import annotations

import dataclasses
import importlib.util
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

# the card's rates are repro_torch.roofline's (H100 SXM data sheet): HBM
# 3.35e12 B/s, bf16 989e12 FLOP/s, f32 as 3xTF32 (494.7e12 / 3); and
CUDA_CORE_F32_FLOPS = 67e12  # f32 outside the tensor cores (the scans)
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
RWKV_ARGS = ["--arch", "rwkv6-1.6b"] + SERVE_ARGS[2:]
MINICPM_ARGS = ["--arch", "minicpm3-4b"] + SERVE_ARGS[2:]
# of 62 for the runs with snapshots: the whole model's three runs took
# 104 s on an H100 80GB HBM3 at 700 W (decode is host-bound, 180 ms a
# step); the whole model serves once without snapshots
MINICPM_SERVE_LAYERS = 16
# of 62: the whole model's 66 GB train state leaves no room for activations
MINICPM_TRAIN_LAYERS = 8
QWEN_VL_ARGS = ["--arch", "qwen2-vl-2b"] + SERVE_ARGS[2:]
# of 28 for the run with snapshots (the whole model's took 58 s), to keep
# the whole script inside its time limit beside the stablelm-12b serve
# (~240 s); the whole model trains
QWEN_VL_SERVE_LAYERS = 14
MUSICGEN_ARGS = ["--arch", "musicgen-large"] + SERVE_ARGS[2:]
# of 48 for the runs with snapshots: the whole model's 3.52 GB cache takes
# minutes to snapshot four times through the cluster; the whole model
# serves once without snapshots. 4 layers (a 0.29 GB cache) keep the whole
# script inside its time limit beside the deepseek-moe-16b serve (~190 s)
MUSICGEN_SERVE_LAYERS = 4
DEEPSEEK = "deepseek-moe-16b"
DEEPSEEK_ARGS = ["--arch", DEEPSEEK] + SERVE_ARGS[2:] + ["--dtype",
                                                          "bfloat16"]
# of 27 stacked MoE layers, after the dense layer 0: 2.85e9 parameters, a
# 45.7 GB f32 train state. Serving with snapshots runs the same cut (a
# 0.17 GB cache; the whole model's 0.97 GB took 164 s to serve three times
# with the cluster), and the moe_knobs phase the whole model
DEEPSEEK_MOE_LAYERS = 4
DEEPSEEK_TRAIN = f"train {DEEPSEEK} {1 + DEEPSEEK_MOE_LAYERS} layers f32"
# RunConfig overrides of a train phase, by its label (count_rooflines and
# the train phase read them)
TRAIN_RC = {DEEPSEEK_TRAIN + " remat off": {"remat": False}}
STABLELM = "stablelm-12b"  # 40 layers, GQA 32 on 8 heads of 160
STABLELM_ARGS = ["--arch", STABLELM] + SERVE_ARGS[2:] + ["--dtype",
                                                          "bfloat16"]
# of 40: 2.14e9 parameters, a 34.2 GB f32 train state (the whole model's
# would be 194 GB)
STABLELM_TRAIN_LAYERS = 4
# of 40 for the runs with snapshots: the whole model's three runs took
# 217 s on an H100 80GB HBM3 at 700 W, and with them the script ran past
# its 1200 s limit on a slower host; the whole model serves once without
# snapshots
STABLELM_SERVE_LAYERS = 10
STABLELM_TRAIN = f"train {STABLELM} {STABLELM_TRAIN_LAYERS} layers f32"
PHI = "phi3.5-moe-42b-a6.6b"  # 32 layers, each 16 experts top 2
PHI_ARGS = ["--arch", PHI] + SERVE_ARGS[2:] + ["--dtype", "bfloat16"]
# of 32: the whole model is 83.7 GB in bf16; 12 layers are 31.7 GB, beside
# the 20.1 GB f32 sample of the stacked expert leaf at init
PHI_SERVE_LAYERS = 12
QWEN = "qwen1.5-32b"  # 64 layers, MHA 40 heads of 128, qkv bias
QWEN_ARGS = ["--arch", QWEN] + SERVE_ARGS[2:] + ["--dtype", "bfloat16"]
# of 64: the whole model is 70.4 GB in bf16; 32 layers are 36.8 GB, beside
# the 17.9 GB f32 sample of the stacked MLP leaf at init
QWEN_SERVE_LAYERS = 32
MOE_DECODE = 8  # greedy decode steps of the moe_knobs phase
MOE_LOW_FACTOR = 0.1  # 10 slots an expert of a 1024-token group: 90 % drop
# E / top_k: an expert's capacity covers every token of its group
MOE_NO_DROP = 64 / 6
# prefill logits of one group against the policy's four, nothing dropped:
# the same function, its expert products batched otherwise, so other bf16
# roundings through 28 layers; 2^-3 is 8 bf16 ulps at the largest logits'
# scale (< 4)
MOE_GROUPS_TOL = 2.0 ** -3
MESH_DECODE = 8  # greedy decode steps of the mesh phase
HEAD_PAD = 8  # gemma3-1b's 4 query heads padded to 8 on its 1 kv head
# head_pad=8 prefill against the unpadded one: the same real heads, but
# the q and wo products run 2x wider (zero columns and rows), so cuBLAS may
# pick other tiles; the card-vs-CPU reference phase's tolerance
HEAD_PAD_TOL = 1e-4
# the production cells the dry-run phase counts, with the policy each
# exercises (repro_torch.launch.dryrun on a fake group of 512 ranks)
DRYRUN_CELLS = [
    ("gemma3-1b", "train_4k", "pod1", "dp_zero1: batch over data x model, "
     "ZeRO-1 moments, the flash backward's meta work"),
    ("qwen1.5-32b", "prefill_32k", "pod1", "tp_fsdp, head_pad=16, head-TP "
     "caches"),
    ("stablelm-12b", "decode_32k", "pod2", "tp_fsdp on the 512-rank mesh"),
    ("deepseek-moe-16b", "decode_32k", "pod1", "EP, experts over model"),
    ("rwkv6-1.6b", "long_500k", "pod1", "batch 1, so seq-sharded recurrent "
     "state")]


def kernel_device_ms(torch, fn, pattern, calls=10, tries=3) -> dict:
    """Device ms of each kernel of one fn() call whose name matches
    ``pattern``, by the name and template arguments torch.profiler gives
    it ('flash_bwd_dq<160, 4, 160>'): its device time summed over ``calls``
    calls after a warm-up, divided by ``calls``; the host's work between
    the launches is not in it. A profile that saw none of them (the
    profiler now and then returns no device events) is taken again, up to
    ``tries`` times; then it raises, so that no time is made up."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        times = {}
        for ev in prof.key_averages():
            m = re.search(pattern + r"\w*(?:<[^<>]*>)?", ev.key)
            if m and ev.self_device_time_total > 0:
                times[m.group()] = times.get(m.group(), 0.0) \
                    + ev.self_device_time_total / 1e3 / calls
        if times:
            return times
    raise RuntimeError(f"device_ms: {tries} profiles of {calls} calls saw "
                       f"no kernel matching {pattern!r}")


def device_ms(torch, fn, pattern, calls=10, tries=3) -> float:
    """Device ms of one fn() call: kernel_device_ms summed."""
    return sum(kernel_device_ms(torch, fn, pattern, calls, tries).values())


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


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def phase_device(torch) -> None:
    print(card())
    print(f"device: {torch.cuda.get_device_name(0)}; "
          f"{torch.cuda.device_count()} visible; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)


def _kernel_name(mangled: str) -> str:
    """'_ZN12_GLOBAL__N_12tf14flash_fwd_tf32ILi128ELi64ELi64ELi64ELi2ELi8E'
    'Li64EEEv14CUtensorMap_stS2_S2_NS0_4ArgsE' -> 'flash_fwd_tf32<128,64,
    64,64,2,8,64>': the innermost name and its integer template
    arguments."""
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


def bound(rl, work, flops_per_s):
    """(bound ms, "operations" or "bytes"): the larger of ``work``'s
    (flops, bytes) at ``flops_per_s`` and at the card's memory rate."""
    t_ops = work[0] / flops_per_s * 1e3
    t_bytes = work[1] / rl.HBM_BW * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def phase_delta(torch, ops, ref, changed_blocks, rl, delta) -> dict:
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
    bound_ms, bound_by = bound(rl, delta.work(n, block), CUDA_CORE_F32_FLOPS)
    print(f"delta_mask: {n >> 20} MiB, block {block}: exact vs plain and "
          f"host scan; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({2 * n / ms / 1e6:.0f} GB/s)", flush=True)
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def host_us(torch, fn, calls=50, blocks=5) -> float:
    """Host microseconds of fn() with the card running behind it: the
    median, over ``blocks`` blocks, of the mean of ``calls`` calls back to
    back, after a warm-up (the host's clock moves with its other load; a
    block's mean is steadier than one call)."""
    fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(blocks):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        means.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(means)


def phase_flash(torch, ops, ref, rl, flash) -> dict:
    import torch.nn.functional as F
    dev = torch.device("cuda")
    gemma = (4, 4, 1, 256, 256)  # B, H, Hk, D, Dv of gemma3-1b's prefill
    mla = (4, 40, 40, 96, 64)  # minicpm3-4b's MLA: 64 nope + 32 rope; v 64
    musicgen = (4, 32, 32, 64, 64)  # MHA, prefill of 64 + 1024 rows
    qwen_vl = (4, 12, 2, 128, 128)  # GQA group 6, prefill of 256 + 1024
    deepseek = (4, 16, 16, 128, 128)  # deepseek-moe-16b's MHA
    stablelm = (4, 32, 8, 160, 160)  # GQA 4, heads 160 wide: 5120 / 32
    cases = [(gemma, torch.float32, 1024, 512),
             (gemma, torch.float32, 1024, None),
             (gemma, torch.bfloat16, 1024, 512),
             (gemma, torch.bfloat16, 1024, None),
             (gemma, torch.float32, 1000, 512),
             (gemma, torch.bfloat16, 1000, None),
             ((4, 64, 8, 128, 128), torch.bfloat16, 1024, None),  # Jamba's
             (mla, torch.float32, 1024, None),
             (mla, torch.bfloat16, 1024, None),
             (musicgen, torch.float32, 1088, None),
             (qwen_vl, torch.float32, 1280, None),
             (deepseek, torch.bfloat16, 1024, None),
             (deepseek, torch.float32, 1024, None),
             (stablelm, torch.bfloat16, 1024, None),
             (stablelm, torch.float32, 1024, None),
             ((4, 32, 8, 128, 128), torch.bfloat16, 1024, None),  # phi3.5
             ((4, 40, 40, 128, 128), torch.bfloat16, 1024, None)]  # qwen1.5
    results = {}
    for (b, h, hk, d, dv), dtype, s, window in cases:
        gen = torch.Generator(device=dev).manual_seed(s + (window or 0) + h)
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for shape in ((b, h, s, d), (b, hk, s, d),
                                 (b, hk, s, dv)))
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
        dev_ms = device_ms(torch, lambda: ops.flash_attention(
            q, k, v, window=window), r"flash_fwd")
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
        peak = rl.PEAK_FLOPS[name]
        work = flash.work(b, h, hk, s, d, dv, window, q.element_size())
        flops, nbytes = work
        bound_ms, bound_by = bound(rl, work, peak)
        path = "wgmma" if dtype == torch.bfloat16 else "wgmma-tf32"
        label = (f"{name} B={b} H={h} Hk={hk} S={s} D={d}"
                 f"{'' if dv == d else f' Dv={dv}'} window={window} {path}")
        rate = f"at {peak / 1e12:.1f} TFLOP/s"
        if dtype == torch.float32:
            rate += (f" (3xTF32); at the CUDA-core "
                     f"{CUDA_CORE_F32_FLOPS / 1e12:.0f} TFLOP/s "
                     f"{bound(rl, work, CUDA_CORE_F32_FLOPS)[0]:.4f} ms")
        wd, wdv = flash.product_widths(d, dv, dtype)
        padded = flash.padded_flops(flops, d, dv, dtype=dtype)
        if wd != d or wdv != dv:  # the products run wider than D and Dv
            padded = (padded, nbytes)
            rate += (f"; the kernel computes Q K^T {wd} and P V {wdv} "
                     f"wide: {(d + dv) / (wd + wdv):.1%} of its products "
                     f"are real, bound at the padded work "
                     f"{bound(rl, padded, peak)[0]:.4f} ms")
        same = torch.equal(out, ops.flash_attention(q, k, v, window=window))
        host = host_us(torch, lambda: ops.flash_attention(q, k, v,
                                                          window=window))
        print(f"flash_attention[{label}]: max_abs_err {err:.3e} (tol "
              f"{tol:g}); two launches "
              f"{'bit-equal' if same else 'DIFFER'}; kernel {ms:.4f} ms "
              f"(device {dev_ms:.4f} ms, host {host:.1f} us a call), plain "
              f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms {rate} ({flops / ms / 1e9:.1f} TFLOP/s; "
              f"device {flops / dev_ms / 1e9:.1f})",
              flush=True)
        if not ok:
            raise AssertionError(f"flash_attention {label}: max abs err "
                                 f"{err}")
        if not same:
            raise AssertionError(f"flash_attention {label}: two launches "
                                 f"differ")
        results[(name, s, window, h, d)] = {
            "label": label, "max_abs_err": err, "ms": ms,
            "device_ms": dev_ms, "host_us": host, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}
        del q, k, v, ke, ve, out, exp
    # the kernel's entry: gemma3-1b's own case (f32 prefill of a local
    # layer, 22 of its 26), with the worst error of all cases, and every
    # case beside it
    main = dict(results[("float32", 1024, 512, 4, 256)])
    del main["label"]
    main["max_abs_err"] = max(r["max_abs_err"] for r in results.values())
    main["cases"] = [{key: r[key] for key in (
        "label", "ms", "device_ms", "host_us", "plain_ms", "library_ms",
        "bound_ms", "max_abs_err")} for r in results.values()]
    del main["device_ms"], main["host_us"]
    return main


def phase_decode(torch, ops, ref, rl, dattn) -> dict:
    """The decode kernel at the chat shape and at one row of a 32k cache
    (bf16), each row at the given position, against its plain version."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    # B, H, Hk, D, cache rows, position
    cases = [(48, 32, 8, 128, 1152, 1088), (1, 32, 8, 128, 32768, 32767)]
    results = {}
    for b, h, hk, d, s, pos in cases:
        gen = torch.Generator(device=dev).manual_seed(s + b)
        q = torch.randn((b, 1, h, d), generator=gen, device=dev).to(
            torch.bfloat16)
        k, v = (torch.randn((b, s, hk, d), generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(2))
        cur = torch.full((b,), pos, dtype=torch.int64, device=dev)

        def kernel():
            return ops.decode_attention(q, k, v, cur_pos=cur)
        out = kernel()
        exp = ref.decode_attention_ref(q.float(), k, v, cur_pos=cur)
        torch.cuda.synchronize()
        err = (out.float() - exp).abs().max().item()
        # one bf16 rounding of the f32 result (test_torch_decode_attention)
        ok = out.dtype == torch.bfloat16 and torch.allclose(
            out.float(), exp, rtol=2 ** -8, atol=1e-5)
        same = torch.equal(out, kernel())
        ms = time_ms(torch, kernel)
        dev_ms = device_ms(torch, kernel, r"decode_")
        host = host_us(torch, kernel)
        plain_ms = time_ms(torch, lambda: ref.decode_attention_ref(
            q, k, v, cur_pos=cur))
        n = pos + 1  # every row shares the position: the live rows alone
        qs, ks, vs = (t.transpose(1, 2) for t in (q, k[:, :n], v[:, :n]))
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, ks, vs, enable_gqa=True))
        work = dattn.work(b, h, hk, n, d, None, 2)
        bound_ms, bound_by = bound(rl, work, CUDA_CORE_F32_FLOPS)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        g = h // hk
        splits = dattn.split_count(b * hk * -(-g // dattn.head_group(g)),
                                   s, sms)
        label = (f"bf16 B={b} H={h} Hk={hk} D={d} S={s} pos={pos} "
                 f"splits={splits}")
        print(f"decode_attention[{label}]: max_abs_err {err:.3e}; two "
              f"launches {'bit-equal' if same else 'DIFFER'}; kernel "
              f"{ms:.4f} ms (device {dev_ms:.4f} ms, host {host:.1f} us a "
              f"call), plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}: {work[1] / 1e6:.1f} "
              f"MB; {work[1] / dev_ms / 1e6:.0f} GB/s on the device, "
              f"{bound_ms / dev_ms:.1%} of the bound)", flush=True)
        if not ok or not same:
            raise AssertionError(f"decode_attention {label}: max abs err "
                                 f"{err}, two launches equal {same}")
        results[(b, s)] = {
            "label": label, "max_abs_err": err, "ms": ms,
            "device_ms": dev_ms, "host_us": host, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}
        del q, k, v, out, exp
    main = dict(results[(48, 1152)])
    del main["label"]
    main["max_abs_err"] = max(r["max_abs_err"] for r in results.values())
    main["cases"] = list(results.values())
    return main


def phase_flash_bwd(torch, ref, rl, flash) -> dict:
    """The backward kernel at gemma3-1b's train shapes (f32): local layers
    (window 512), the global layer, and a ragged S; then at minicpm3-4b's
    MLA heads (D = 96, Dv = 64, H = Hk = 40), musicgen-large's (MHA, D = 64,
    S = 64 + 1024), qwen2-vl-2b's (a GQA group of 6, D = 128, S = 256 +
    1024), deepseek-moe-16b's (MHA, D = 128) and stablelm-12b's (GQA 4,
    D = 160, on instantiations of its own: 160-wide tiles of 32 keys, dK^T
    and dV^T as three m64 tiles, 192 rows of which 160 real). Each line
    names the dK/dV and dQ instantiations the profiler saw and gives the
    five kernels' device ms alone beside the single call, and the host's µs
    a call with the card running behind. Its bound counts the five products
    (Q K^T, dO V^T, P^T dO, dS K, dS^T Q) over the pairs the band holds."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    gemma, mla = (4, 4, 1, 256, 256), (4, 40, 40, 96, 64)
    musicgen, qwen_vl = (4, 32, 32, 64, 64), (4, 12, 2, 128, 128)
    deepseek, stablelm = (4, 16, 16, 128, 128), (4, 32, 8, 160, 160)
    results = {}
    for (b, h, hk, d, dv), s, window in ((gemma, 1024, 512),
                                         (gemma, 1024, None),
                                         (gemma, 1000, 512),
                                         (mla, 1024, None),
                                         (musicgen, 1088, None),
                                         (qwen_vl, 1280, None),
                                         (deepseek, 1024, None),
                                         (stablelm, 1024, None)):
        gen = torch.Generator(device=dev).manual_seed(7 * s + (window or 0)
                                                      + h)
        q, k, v = (torch.randn(shape, generator=gen, device=dev)
                   for shape in ((b, h, s, d), (b, hk, s, d), (b, hk, s, dv)))
        dout = torch.randn((b, h, s, dv), generator=gen, device=dev)
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
        per_kernel = kernel_device_ms(torch, kernel, r"flash_bwd_")
        dev_ms = sum(per_kernel.values())
        inst = " ".join(sorted(name[len("flash_bwd_"):].replace(" ", "")
                               for name in per_kernel
                               if re.match(r"flash_bwd_(dkdv|dq)<", name)))
        host = host_us(torch, kernel)
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
        peak = rl.PEAK_FLOPS["float32"]
        work = flash.bwd_work(b, h, hk, s, d, dv, window)
        flops, nbytes = work
        bound_ms, bound_by = bound(rl, work, peak)
        label = (f"f32 B={b} H={h} Hk={hk} S={s} D={d}"
                 f"{'' if dv == d else f' Dv={dv}'} window={window} "
                 f"wgmma-tf32 {inst}")
        widths = flash.bwd_product_widths(d, dv)
        padded = ""
        if sum(widths) != 3 * d + 2 * dv:  # some products run wider
            t_pad = bound(rl, (flash.padded_flops(flops, d, dv,
                                                  backward=True), nbytes),
                          peak)[0]
            padded = (f"; the kernel computes its five products at widths "
                      f"{'/'.join(map(str, widths))} "
                      f"({(3 * d + 2 * dv) / sum(widths):.1%} of them "
                      f"real), bound at the padded work {t_pad:.4f} ms")
        print(f"flash_attention_bwd[{label}]: max_abs_err {err:.3e} (tol "
              f"{BWD_TOL:g} of each gradient's max); two launches bit-equal; "
              f"kernel {ms:.4f} ms (device {dev_ms:.4f} ms, host {host:.1f} "
              f"us a call), plain {plain_ms:.4f} ms, sdpa backward "
              f"{library_ms:.4f} ms; bound {bound_ms:.4f} ms at "
              f"{peak / 1e12:.1f} TFLOP/s (3xTF32), "
              f"{bound(rl, work, CUDA_CORE_F32_FLOPS)[0]:.4f} ms at the "
              f"CUDA-core {CUDA_CORE_F32_FLOPS / 1e12:.0f} TFLOP/s, bytes "
              f"{bound(rl, (0, nbytes), peak)[0]:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s){padded}", flush=True)
        if not ok:
            raise AssertionError(f"flash_attention_bwd {label}: max abs err "
                                 f"{err}")
        results[(s, window, h, d)] = {
            "label": label, "max_abs_err": err, "ms": ms,
            "device_ms": dev_ms, "host_us": host,
            "kernel_device_ms": per_kernel, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}
        del q, k, v, dout, out, lse, got, again, exp, qr, kr, vr, o_lib
        torch.cuda.empty_cache()
    main = dict(results[(1024, 512, 4, 256)])  # gemma's local layers
    main["max_abs_err"] = max(r["max_abs_err"] for r in results.values())
    main["cases"] = [{key: r[key] for key in (
        "label", "ms", "device_ms", "host_us", "kernel_device_ms",
        "plain_ms", "library_ms", "bound_ms", "max_abs_err")}
        for r in results.values()]
    for key in ("label", "device_ms", "host_us", "kernel_device_ms"):
        del main[key]
    return main


def phase_ssm(torch, ops, ref, rl, ssm) -> dict:
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
        nbytes = ssm.work(b, s, d, n)[1]
        bound_ms, bound_by = bound(rl, ssm.work(b, s, d, n),
                                   CUDA_CORE_F32_FLOPS)
        print(f"ssm_scan[{label}]: max_abs_err {err:.3e} (tol {tol:g}); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s); keeping "
              f"the boundary states for a backward {kept_ms:.4f} ms",
              flush=True)
        result = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                  "bound_ms": bound_ms, "bound_by": bound_by,
                  "library_ms": None}
        del decay, u, c, s0
        torch.cuda.empty_cache()
    return result


def phase_ssm_bwd(torch, ref, rl, ssm) -> dict:
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
        nbytes = ssm.bwd_work(b, s, d, n)[1]
        bound_ms, bound_by = bound(rl, ssm.bwd_work(b, s, d, n),
                                   CUDA_CORE_F32_FLOPS)
        print(f"ssm_scan_bwd[{label}]: max_abs_err {err:.3e}, {worst:.3e} "
              f"of its gradient's max (tol {BWD_TOL:g}); two launches "
              f"bit-equal; boundary states max abs err {bound_err:.3e} (tol "
              f"1e-4); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s); library: "
              f"none (no single call)", flush=True)
        result = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                  "bound_ms": bound_ms, "bound_by": bound_by,
                  "library_ms": None}
        del decay, u, c, s0, dy, bounds
        torch.cuda.empty_cache()
    return result


def phase_reference(torch, Model, RunConfig, cfg, tree_to_torch,
                    overrides) -> None:
    """The card's path (kernels) against the CPU's (plain versions) on the
    same reduced weights: prefill 48 tokens, then 4 steps, f32, with the
    ``RunConfig`` ``overrides``. An arch with a front end prefills its
    ``n_frontend`` random embeddings first and decodes after them."""
    rc = dataclasses.replace(RunConfig(param_dtype=torch.float32,
                                       cache_dtype=torch.float32,
                                       rwkv_chunk=16), **overrides)
    arch = _ref_label(cfg, overrides)
    cpu, dev = Model(cfg, rc, "cpu"), Model(cfg, rc, "cuda")
    params_cpu = cpu.init(0)
    params_dev = tree_to_torch(params_cpu, "cuda")
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 52), generator=gen)
    nf = cfg.n_frontend
    front = torch.randn((2, nf, cfg.d_model), generator=gen) if nf else None
    c_cpu, c_dev = cpu.init_cache(2, nf + 52), dev.init_cache(2, nf + 52)
    l_cpu, c_cpu = cpu.prefill(params_cpu, toks[:, :48], c_cpu, front)
    l_dev, c_dev = dev.prefill(params_dev, toks[:, :48].cuda(), c_dev,
                               None if front is None else front.cuda())
    worst = (l_dev.cpu() - l_cpu).abs().max().item()
    for step in range(4):
        t = toks[:, 48 + step:49 + step]
        l_cpu, c_cpu = cpu.decode_step(params_cpu, t, nf + 48 + step, c_cpu)
        l_dev, c_dev = dev.decode_step(params_dev, t.cuda(), nf + 48 + step,
                                       c_dev)
        worst = max(worst, (l_dev.cpu() - l_cpu).abs().max().item())
        if not torch.allclose(l_dev.cpu(), l_cpu, atol=1e-4, rtol=1e-4):
            raise AssertionError(f"reference {arch}: step {step} logits "
                                 f"differ by {worst}")
    rows = f"({nf} front-end + 48)" if nf else "48"
    print(f"reference: {arch} prefill 2x{rows} + 4 decode steps, card vs "
          f"CPU max abs logit diff {worst:.3e} (tol 1e-4)", flush=True)


def phase_train_reference(torch, Model, RunConfig, cfg, tree_to_torch,
                          tree_leaves, overrides) -> None:
    """``cfg``'s train loss and every gradient on the card (flash forward
    and backward kernels; for Jamba also the scan's) against the same
    weights and batch on the CPU (plain versions), f32, with the
    ``RunConfig`` ``overrides``: S = 100 in 64-token loss chunks; with
    random front-end embeddings where the arch has them."""
    rc = dataclasses.replace(RunConfig(param_dtype=torch.float32,
                                       cache_dtype=torch.float32,
                                       loss_chunk=64, rwkv_chunk=16),
                             **overrides)
    arch = _ref_label(cfg, overrides)
    cpu, dev = Model(cfg, rc, "cpu"), Model(cfg, rc, "cuda")
    params = {"cpu": cpu.init(0)}
    params["cuda"] = tree_to_torch(params["cpu"], "cuda")
    gen = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (2, 101), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.n_frontend:
        batch["frontend_embeds"] = torch.randn(
            (2, cfg.n_frontend, cfg.d_model), generator=gen)
    out = {}
    for where, model in (("cpu", cpu), ("cuda", dev)):
        leaves = tree_leaves(params[where])
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = model.loss(params[where], {
            k: v.to(model.device) for k, v in batch.items()})
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


def reference_runs(get_config, Stage) -> list:
    """(config, serve overrides, train overrides) of each card-against-CPU
    reference. deepseek-moe-16b-reduced's MoE stage is stacked twice, so
    that training has a repeat to recompute, and runs twice: with the
    defaults, then with the knobs set (a factor that drops, one group, no
    recompute). stablelm-12b-reduced runs once more with its published
    head width, 160 (4 heads on 1 kv head), where reducing makes every
    head 16 wide."""
    runs = [(get_config(arch), {}, {}) for arch in (
        "gemma3-1b-reduced", "jamba-1.5-large-398b-reduced",
        "rwkv6-1.6b-reduced", "minicpm3-4b-reduced", "qwen2-vl-2b-reduced",
        "musicgen-large-reduced", QWEN + "-reduced", STABLELM + "-reduced",
        PHI + "-reduced")]
    ds = get_config(DEEPSEEK + "-reduced")
    ds = dataclasses.replace(ds, stages=(
        ds.stages[0], dataclasses.replace(ds.stages[1], repeat=2)))
    sl = get_config(STABLELM + "-reduced")
    (layer,) = sl.stages[0].block
    wide = dataclasses.replace(layer, attn=dataclasses.replace(
        layer.attn, head_dim=160, n_heads=4, n_kv_heads=1))
    sl = dataclasses.replace(sl, name=f"{sl.name} (4 heads on 1, 160 wide)",
                             stages=(Stage(block=(wide,), repeat=1),))
    return runs + [(ds, {}, {}),
                   (ds, {"capacity_factor": MOE_LOW_FACTOR, "moe_groups": 1},
                    {"remat": False}),
                   (sl, {}, {})]


def _ref_label(cfg, overrides) -> str:
    """A reference line's name: the arch, its stacked stages and the
    knobs set."""
    reps = [st.repeat for st in cfg.stages]
    label = cfg.name + (f" (stage repeats {reps})" if max(reps) > 1 else "")
    knobs = ", ".join(f"{k}={v}" for k, v in overrides.items())
    return label + (f" [{knobs}]" if knobs else "")


def serve_runs(get_config, Stage) -> list:
    """(label, serve arguments, kernels that must launch, cfg, whether it
    runs once without snapshots) of every serve phase."""
    jamba = get_config("jamba-1.5-large-398b")
    musicgen = get_config("musicgen-large")
    phi, qwen = get_config(PHI), get_config(QWEN)
    qwen_vl = get_config("qwen2-vl-2b")
    minicpm, stablelm = get_config("minicpm3-4b"), get_config(STABLELM)
    return [
        ("serve gemma3-1b f32", SERVE_ARGS,
         ("delta_mask", "flash_attention", "decode_attention"),
         get_config("gemma3-1b"), False),
        (f"serve jamba-1.5-large {JAMBA_LAYERS} layers bf16", JAMBA_ARGS,
         ("delta_mask", "flash_attention", "ssm_scan", "decode_attention"),
         _cut(jamba, Stage, jamba.stages[0].block[:JAMBA_LAYERS], 1), False),
        ("serve rwkv6-1.6b f32", RWKV_ARGS, ("delta_mask",),
         get_config("rwkv6-1.6b"), False),
        (f"serve minicpm3-4b {MINICPM_SERVE_LAYERS} layers f32", MINICPM_ARGS,
         ("delta_mask", "flash_attention"),
         _cut(minicpm, Stage, minicpm.stages[0].block, MINICPM_SERVE_LAYERS),
         False),
        ("serve minicpm3-4b 62 layers f32", MINICPM_ARGS,
         ("flash_attention",), minicpm, True),
        (f"serve qwen2-vl-2b {QWEN_VL_SERVE_LAYERS} layers f32", QWEN_VL_ARGS,
         ("delta_mask", "flash_attention", "decode_attention"),
         _cut(qwen_vl, Stage, qwen_vl.stages[0].block, QWEN_VL_SERVE_LAYERS),
         False),
        (f"serve musicgen-large {MUSICGEN_SERVE_LAYERS} layers f32",
         MUSICGEN_ARGS, ("delta_mask", "flash_attention", "decode_attention"),
         _cut(musicgen, Stage, musicgen.stages[0].block,
              MUSICGEN_SERVE_LAYERS), False),
        ("serve musicgen-large 48 layers f32", MUSICGEN_ARGS,
         ("flash_attention", "decode_attention"), musicgen, True),
        (f"serve {DEEPSEEK} {1 + DEEPSEEK_MOE_LAYERS} layers bf16",
         DEEPSEEK_ARGS, ("delta_mask", "flash_attention", "decode_attention"),
         _deepseek_cut(get_config, Stage), False),
        (f"serve {STABLELM} {STABLELM_SERVE_LAYERS} layers bf16",
         STABLELM_ARGS, ("delta_mask", "flash_attention", "decode_attention"),
         _cut(stablelm, Stage, stablelm.stages[0].block,
              STABLELM_SERVE_LAYERS), False),
        (f"serve {STABLELM} 40 layers bf16", STABLELM_ARGS,
         ("flash_attention", "decode_attention"), stablelm, True),
        (f"serve {PHI} {PHI_SERVE_LAYERS} layers bf16", PHI_ARGS,
         ("flash_attention", "decode_attention"),
         _cut(phi, Stage, phi.stages[0].block, PHI_SERVE_LAYERS), True),
        (f"serve {QWEN} {QWEN_SERVE_LAYERS} layers bf16", QWEN_ARGS,
         ("flash_attention", "decode_attention"),
         _cut(qwen, Stage, qwen.stages[0].block, QWEN_SERVE_LAYERS), True)]


def train_configs(get_config, Stage) -> dict:
    """The config of every train phase, by its label."""
    gemma = get_config("gemma3-1b")
    jamba = get_config("jamba-1.5-large-398b")
    minicpm = get_config("minicpm3-4b")
    stablelm = get_config(STABLELM)
    deepseek_cut = _deepseek_cut(get_config, Stage)
    return {
        "train gemma3-1b 6 layers f32": _cut(gemma, Stage,
                                             gemma.stages[0].block, 1),
        "train gemma3-1b 26 layers f32": gemma,
        "train jamba-1.5-large-398b-reduced f32":
            get_config("jamba-1.5-large-398b-reduced"),
        "train jamba-1.5-large L0 (Mamba + dense) f32":
            _cut(jamba, Stage, jamba.stages[0].block[:1], 1),
        "train rwkv6-1.6b-reduced f32": get_config("rwkv6-1.6b-reduced"),
        "train minicpm3-4b-reduced f32": get_config("minicpm3-4b-reduced"),
        "train rwkv6-1.6b 24 layers f32": get_config("rwkv6-1.6b"),
        f"train minicpm3-4b {MINICPM_TRAIN_LAYERS} layers f32":
            _cut(minicpm, Stage, minicpm.stages[0].block,
                 MINICPM_TRAIN_LAYERS),
        "train qwen2-vl-2b-reduced f32": get_config("qwen2-vl-2b-reduced"),
        "train musicgen-large-reduced f32":
            get_config("musicgen-large-reduced"),
        "train qwen2-vl-2b whole f32": get_config("qwen2-vl-2b"),
        "train musicgen-large whole f32": get_config("musicgen-large"),
        DEEPSEEK_TRAIN: deepseek_cut,
        DEEPSEEK_TRAIN + " remat off": deepseek_cut,
        STABLELM_TRAIN: _cut(stablelm, Stage, stablelm.stages[0].block,
                             STABLELM_TRAIN_LAYERS)}


def _deepseek_cut(get_config, Stage):
    """deepseek-moe-16b's both stages: the dense layer 0, then its first
    DEEPSEEK_MOE_LAYERS MoE layers, stacked."""
    deepseek = get_config(DEEPSEEK)
    return dataclasses.replace(deepseek, stages=(
        deepseek.stages[0], Stage(block=deepseek.stages[1].block,
                                  repeat=DEEPSEEK_MOE_LAYERS)))


def _cut(cfg, Stage, block, repeat):
    """``cfg`` cut to one stage: ``block`` repeated ``repeat`` times."""
    return dataclasses.replace(cfg, stages=(Stage(block=block,
                                                  repeat=repeat),))


def count_rooflines() -> dict:
    """The counted roofline terms of one step of every serve and train
    phase, by "<label> <kind>", on the meta device (no card): serve
    prefills batch 4 x (front-end rows + 1024) and decodes one step at the
    loop's first position against its cache of front-end rows + 1024 + 32
    positions; train takes one step of batch 4 x 1024 after the front-end
    rows. Model FLOPs count every row."""
    from repro_torch import roofline
    from repro_torch.configs import get_config
    from repro_torch.configs.base import Stage
    from repro_torch.launch import serve, train
    from repro_torch.models import count_active_params

    plan = []
    for label, args, _, cfg, _ in serve_runs(get_config, Stage):
        dtype = serve.DTYPES[args[args.index("--dtype") + 1]
                             if "--dtype" in args else "float32"]
        nf = cfg.n_frontend
        plan.append((label, "prefill", cfg, serve.run_config(dtype),
                     dict(seq=1024, frontend_rows=nf), 4 * (nf + 1024)))
        plan.append((label, "decode", cfg, serve.run_config(dtype),
                     dict(seq=nf + 1024 + 32, pos=nf + 1024), 4))
    cfgs = train_configs(get_config, Stage)
    for label, cfg in cfgs.items():
        plan.append((label, "train", cfg, dataclasses.replace(
            train.RUN_CONFIG, **TRAIN_RC.get(label, {})),
                     dict(seq=1024, frontend_rows=cfg.n_frontend),
                     4 * (cfg.n_frontend + 1024)))
    out = {}
    for label, kind, cfg, rc, shape, rows in plan:
        cost = roofline.step_cost(cfg, rc, kind, 4, **shape)
        out[f"{label} {kind}"] = roofline.roofline_terms(
            cost, dtype=rc.param_dtype, model_flops_per_chip=(
                roofline.model_flops(count_active_params(cfg), kind, rows)))
    out[f"{DEEPSEEK_TRAIN} train"]["recompute"] = recompute_flops(
        roofline, cfgs[DEEPSEEK_TRAIN], train.RUN_CONFIG, out)
    return out


def recompute_flops(roofline, cfg, rc, terms) -> dict:
    """What recompute adds to the deepseek train step's counted FLOPs: the
    difference of the remat-on and remat-off counts, against the forward of
    the stacked MoE layers (a prefill of the cut less one of the dense
    layer 0 alone) less each layer's last product, the shared experts' down
    projection, which ``torch.utils.checkpoint`` does not recompute (it
    stops once every tensor the backward saved is back, and that product's
    output is none of them). Raises unless the two are equal."""
    on = terms[f"{DEEPSEEK_TRAIN} train"]["counted_flops_per_chip"]
    off = terms[f"{DEEPSEEK_TRAIN} remat off train"]["counted_flops_per_chip"]
    rows = 4 * 1024
    prefill = [roofline.step_cost(c, rc, "prefill", 4, seq=1024).flops
               for c in (cfg, dataclasses.replace(cfg,
                                                  stages=cfg.stages[:1]))]
    moe = cfg.stages[1].block[0].mlp.moe
    last = DEEPSEEK_MOE_LAYERS * 2 * rows * moe.n_shared \
        * moe.d_expert * cfg.d_model
    forward = prefill[0] - prefill[1]
    if on - off != forward - last:
        raise AssertionError(f"recompute: remat on - off {on - off} FLOPs, "
                             f"forward {forward} less {last}")
    return {"flops": on - off, "forward_flops": forward,
            "not_recomputed_flops": last}


class Rooflines:
    """The counted terms of every phase's step and the entries printed so
    far: ``report`` prints a step's counted work and bound beside its
    measured time."""

    def __init__(self, terms: dict):
        self.terms = terms
        self.entries = []

    def report(self, label: str, kind: str, measured_s: float) -> None:
        t = self.terms[f"{label} {kind}"]
        bound_s = t["step_s_lower_bound"]
        print(f"roofline {label} {kind}: counted "
              f"{t['counted_flops_per_chip'] / 1e12:.4f} TFLOP, "
              f"{t['counted_bytes_per_chip'] / 1e9:.3f} GB (min "
              f"{t['min_bytes_per_chip'] / 1e9:.3f} GB), bound "
              f"{bound_s * 1e3:.4f} ms ({t['dominant']}), measured "
              f"{measured_s * 1e3:.4f} ms, roofline_fraction "
              f"{t['roofline_fraction']:.4f}, model-flops share "
              f"{t['useful_flops_ratio']:.4f}; bound/measured "
              f"{bound_s / measured_s:.4f}; kernels "
              f"{t['kernel_flops_share']:.1%} of the FLOPs", flush=True)
        self.entries.append({
            "label": label, "kind": kind,
            "counted_flops": t["counted_flops_per_chip"],
            "counted_bytes": t["counted_bytes_per_chip"],
            "min_bytes": t["min_bytes_per_chip"],
            "kernel_flops_share": t["kernel_flops_share"],
            "bound_ms": bound_s * 1e3, "dominant": t["dominant"],
            "measured_ms": measured_s * 1e3,
            "bound_over_measured": bound_s / measured_s,
            "roofline_fraction": t["roofline_fraction"],
            "model_flops_share": t["useful_flops_ratio"]})


def phase_serve(torch, serve, launches, roof, label, args, needs,
                cfg) -> dict:
    """Serve ``cfg`` with a node kill at 20, then uninterrupted, then
    without snapshots; the kernels in ``needs`` must launch on the first
    run. An arch with a front end prefills its ``n_frontend`` stub
    embeddings before each prompt. The roofline lines hold the least
    prefill of the three runs and the decode step without snapshots."""
    t0 = time.time()
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
    print(f"{label}: batch 4, {_rows(cfg)}, 32 tokens; prefill "
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
          f"ms a step, prefill {bare['prefill_s']:.4f} s); peak memory "
          f"{peak} bytes ({peak / 1e9:.2f} GB); tokens and final logits "
          f"equal; launches {counts}; phase {time.time() - t0:.1f} s",
          flush=True)
    roof.report(label, "prefill", min(r["prefill_s"]
                                      for r in (stats, ref_stats, bare)))
    roof.report(label, "decode", bare["decode_step_ms"] / 1e3)
    return counts


def _rows(cfg) -> str:
    """What a serve run prefills: the prompt, after the front end's rows."""
    nf = cfg.n_frontend
    return f"{nf} front-end rows + prompt 1024" if nf else "prompt 1024"


def serve_once(torch, serve, launches, roof, label, args, needs,
               cfg) -> dict:
    """Serve ``cfg`` once without snapshots (no kill): tokens in range,
    logits finite, the kernels in ``needs`` launched."""
    t0 = time.time()
    for k in launches:
        launches[k] = 0
    toks, stats = serve.main(args + ["--snapshot-every", "0"], cfg=cfg)
    counts = dict(launches)
    torch.cuda.empty_cache()
    if not stats["logits_finite"] or toks.shape != (4, 32) \
            or not (toks >= 0).all() or not (toks < cfg.vocab_size).all():
        raise AssertionError(f"{label}: tokens {toks.shape}, logits finite "
                             f"{stats['logits_finite']}")
    if min(counts[k] for k in needs) <= 0 or counts != stats["launches"]:
        raise AssertionError(f"{label}: kernel launches {counts}")
    print(f"{label}: batch 4, {_rows(cfg)}, 32 tokens, no snapshots; "
          f"prefill {stats['prefill_s']:.4f} s; decode "
          f"{stats['decode_tok_s']:.2f} tok/s ({stats['decode_step_ms']:.2f} "
          f"ms a step); peak memory {stats['peak_bytes']} bytes "
          f"({stats['peak_bytes'] / 1e9:.2f} GB); tokens in range, logits "
          f"finite; launches {counts}; phase {time.time() - t0:.1f} s",
          flush=True)
    roof.report(label, "prefill", stats["prefill_s"])
    roof.report(label, "decode", stats["decode_step_ms"] / 1e3)
    return counts


def train_kill_and_resume(torch, train, launches, roof, label, args, cfg,
                          needs):
    """Train ``cfg`` with a node kill after step 7 (checkpoints after steps
    2 and 5; resume at 6), then uninterrupted without checkpoints: the
    losses from the resumed step on and the final parameters must be
    bit-equal, and the kernels in ``needs`` must launch on the kill run.
    The roofline line holds the uninterrupted run's mean step. Returns the
    kill run's launches."""
    t0 = time.time()
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
          f"{counts}; phase {time.time() - t0:.1f} s", flush=True)
    roof.report(label, "train", ref_stats["step_ms"] / 1e3)
    return counts


def phase_train(torch, train, launches, roof, get_config, Stage) -> dict:
    """Train gemma3-1b's first superblock at full width with a node kill
    and a bit-exact resume, then 2 steps of the whole model; then
    jamba-1.5-large-398b-reduced with the same kill and resume, and 3 steps
    of full-width Jamba-1.5-Large cut to its first layer; then the same
    for RWKV6 and MLA, and the two front-end archs; deepseek-moe-16b's cut
    with and without recompute; stablelm-12b cut to STABLELM_TRAIN_LAYERS
    layers, 2 steps. Returns the kernel launches of the kill runs and the
    full-width runs without checkpoints, summed."""
    cfgs = train_configs(get_config, Stage)
    kill_args = TRAIN_ARGS + ["--delta-block", "4096"]
    # the reduced archs' small leaves reach the delta_mask kernel with
    # 4096-byte delta blocks; gemma3-1b's with the default 64 KiB
    total = [train_kill_and_resume(
        torch, train, launches, roof, "train gemma3-1b 6 layers f32",
        TRAIN_ARGS, cfgs["train gemma3-1b 6 layers f32"],
        ("delta_mask", "flash_attention", "flash_attention_bwd"))]
    total.append(train_steps(torch, train, launches, roof,
                             "train gemma3-1b 26 layers f32", cfgs, 2,
                             ("flash_attention", "flash_attention_bwd"))[0])
    label = "train jamba-1.5-large-398b-reduced f32"
    total.append(train_kill_and_resume(
        torch, train, launches, roof, label, kill_args, cfgs[label],
        ("delta_mask", "flash_attention", "flash_attention_bwd", "ssm_scan",
         "ssm_scan_bwd")))
    total.append(train_steps(torch, train, launches, roof,
                             "train jamba-1.5-large L0 (Mamba + dense) f32",
                             cfgs, JAMBA_TRAIN_STEPS,
                             ("ssm_scan", "ssm_scan_bwd"))[0])
    for label, needs in (
            ("train rwkv6-1.6b-reduced f32", ("delta_mask",)),
            ("train minicpm3-4b-reduced f32",
             ("delta_mask", "flash_attention", "flash_attention_bwd"))):
        total.append(train_kill_and_resume(
            torch, train, launches, roof, label, kill_args, cfgs[label],
            needs))
    total.append(train_steps(torch, train, launches, roof,
                             "train rwkv6-1.6b 24 layers f32", cfgs, 2,
                             ())[0])
    total.append(train_steps(
        torch, train, launches, roof,
        f"train minicpm3-4b {MINICPM_TRAIN_LAYERS} layers f32", cfgs, 2,
        ("flash_attention", "flash_attention_bwd"))[0])
    # the front ends: each step's front-end embeddings from the pipeline;
    # the whole models' attention sees 256 + 1024 and 64 + 1024 rows
    for arch in ("qwen2-vl-2b", "musicgen-large"):
        label = f"train {arch}-reduced f32"
        total.append(train_kill_and_resume(
            torch, train, launches, roof, label, kill_args, cfgs[label],
            ("delta_mask", "flash_attention", "flash_attention_bwd")))
    for arch in ("qwen2-vl-2b", "musicgen-large"):
        total.append(train_steps(
            torch, train, launches, roof, f"train {arch} whole f32", cfgs,
            2, ("flash_attention", "flash_attention_bwd"))[0])
    total.append(phase_train_remat(torch, train, launches, roof, cfgs))
    # stablelm-12b's 160-wide heads through the f32 forward and backward
    total.append(train_steps(torch, train, launches, roof, STABLELM_TRAIN,
                             cfgs, 2, ("flash_attention",
                                       "flash_attention_bwd"))[0])
    return {k: sum(c[k] for c in total) for k in launches}


def train_steps(torch, train, launches, roof, label, cfgs, steps,
                needs) -> tuple:
    """``steps`` steps of ``cfgs[label]`` without checkpoints, with the
    label's ``TRAIN_RC`` overrides; the kernels in ``needs`` must launch.
    Returns (the launches, the losses, the run's stats)."""
    t0 = time.time()
    cfg = cfgs[label]
    for k in launches:
        launches[k] = 0
    rc = dataclasses.replace(train.RUN_CONFIG, **TRAIN_RC.get(label, {}))
    losses, stats = train.main(TRAIN_ARGS + ["--steps", str(steps),
                                             "--ckpt-every", "0"], cfg=cfg,
                               rc=rc)
    counts = dict(launches)
    torch.cuda.empty_cache()
    if not all(map(math.isfinite, losses)) or len(losses) != steps:
        raise AssertionError(f"{label}: losses {losses}")
    if any(counts[k] <= 0 for k in needs) or counts != stats["launches"]:
        raise AssertionError(f"{label}: kernel launches {counts}")
    rows = (f"{cfg.n_frontend} front-end rows + seq 1024" if cfg.n_frontend
            else "seq 1024")
    print(f"{label}: batch 4, {rows}, {steps} steps, no checkpoints; step "
          f"{stats['step_ms']:.1f} ms; loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} ({losses}); peak memory {stats['peak_bytes']} "
          f"bytes ({stats['peak_bytes'] / 1e9:.2f} GB); launches {counts}; "
          f"phase {time.time() - t0:.1f} s", flush=True)
    roof.report(label, "train", stats["step_ms"] / 1e3)
    return counts, losses, stats


def phase_train_remat(torch, train, launches, roof, cfgs) -> dict:
    """deepseek-moe-16b cut to its dense layer 0 and DEEPSEEK_MOE_LAYERS
    stacked MoE layers (f32, 64 experts top 6 and 2 shared): 2 steps
    without checkpoints with recompute, then 2 without; the losses and the
    parameters' CRC must be bit-equal, since recompute does not change the
    function. Returns both runs' launches, summed."""
    t0 = time.time()
    runs = [train_steps(torch, train, launches, roof, label, cfgs, 2,
                        ("flash_attention", "flash_attention_bwd"))
            for label in (DEEPSEEK_TRAIN, DEEPSEEK_TRAIN + " remat off")]
    (on, l_on, s_on), (off, l_off, s_off) = runs
    if l_on != l_off or s_on["params_crc"] != s_off["params_crc"]:
        raise AssertionError(f"{DEEPSEEK_TRAIN}: remat on {l_on}, crc "
                             f"{s_on['params_crc']}; off {l_off}, crc "
                             f"{s_off['params_crc']}")
    rec = roof.terms[f"{DEEPSEEK_TRAIN} train"]["recompute"]
    print(f"remat [{card()}]: {DEEPSEEK_TRAIN}, 2 steps: losses {l_on} and "
          f"params CRC {s_on['params_crc']} bit-equal with recompute on and "
          f"off; step {s_on['step_ms']:.1f} ms on, {s_off['step_ms']:.1f} ms "
          f"off; peak {s_on['peak_bytes'] / 1e9:.2f} GB on, "
          f"{s_off['peak_bytes'] / 1e9:.2f} GB off; recompute counted "
          f"{rec['flops'] / 1e12:.4f} TFLOP (the MoE layers' forward "
          f"{rec['forward_flops'] / 1e12:.4f} less the shared experts' down "
          f"projections {rec['not_recomputed_flops'] / 1e12:.4f}); phase "
          f"{time.time() - t0:.1f} s", flush=True)
    return {k: on[k] + off[k] for k in launches}


def _example(name):
    """The module of ``examples/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_examples(torch, launches) -> dict:
    """The three example twins on the card, in this process: quickstart's
    finite loss and its read after failover; the serve twin
    (rwkv6-1.6b-reduced, a kill at token 24) against the same run without
    the kill; the train twin (gemma3-1b-reduced, 14 steps, a kill after the
    tenth, resumed at step 8) against the same steps without kill or
    checkpoints, bit for bit. Returns the launches of the quickstart and
    of the two runs with a kill, summed."""
    t0 = time.time()
    total = []

    def launched(fn, *args):
        for k in launches:
            launches[k] = 0
        out = fn(*args)
        total.append(dict(launches))
        return out

    quick = _example("quickstart_torch")
    loss, read = launched(quick.main, ["--device", "cuda"])
    if not math.isfinite(loss) or read != b"assise" \
            or total[-1]["flash_attention"] <= 0:
        raise AssertionError(f"examples quickstart: loss {loss}, read "
                             f"{read!r}, launches {total[-1]}")
    serve_twin = _example("serve_failover_torch")
    toks, stats = launched(serve_twin.main, [])
    ref_toks, ref_stats = serve_twin.main(["--inject-failure", "0"])
    if not ((toks == ref_toks).all() and stats["failover_s"] > 0
            and stats["logits_crc"] == ref_stats["logits_crc"]):
        raise AssertionError("examples serve twin: the resumed session "
                             "differs from the uninterrupted run")
    train_twin = _example("train_failover_torch")
    losses, tstats = launched(train_twin.main, [])
    ref, ref_tstats = train_twin.main(["--inject-failure", "0",
                                       "--ckpt-every", "0"])
    if not (len(losses) == 16 and losses[:10] == ref[:10]
            and losses[10:] == ref[8:]
            and tstats["params_crc"] == ref_tstats["params_crc"]
            and total[-1]["flash_attention_bwd"] > 0):
        raise AssertionError(f"examples train twin: {losses} vs {ref}, "
                             f"launches {total[-1]}")
    counts = {k: sum(c[k] for c in total) for k in launches}
    print(f"examples: quickstart_torch loss {loss:.4f}, read after failover "
          f"{read!r}; serve_failover_torch rwkv6-1.6b-reduced 4x48 tokens "
          f"equal to an uninterrupted run (failover "
          f"{stats['failover_s']:.4f} s); train_failover_torch "
          f"gemma3-1b-reduced {len(losses)} steps run, losses from step 8 "
          f"and final params CRC equal to an uninterrupted run (loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}); launches {counts}; phase "
          f"{time.time() - t0:.1f} s", flush=True)
    return counts


def _greedy(torch, tf, cfg, rc, params, caches, prompts, n_dec):
    """Prefill ``prompts`` and decode ``n_dec`` greedy tokens. Returns
    (the tokens (B, n_dec), every step's logits), as plain tensors; on a
    mesh the tokens fed back are laid out as the prompts."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def full(t):
        return t.full_tensor() if isinstance(t, DTensor) else t
    logits, caches = tf.prefill(cfg, params, prompts, caches, rc)
    steps, toks = [full(logits)], []
    for i in range(n_dec):
        tok = steps[-1].argmax(-1)[:, None]
        toks.append(tok)
        if isinstance(prompts, DTensor):
            tok = distribute_tensor(tok, prompts.device_mesh,
                                    prompts.placements)
        logits, caches = tf.decode_step(cfg, params, tok,
                                        prompts.shape[1] + i, caches, rc)
        steps.append(full(logits))
    return torch.cat(toks, 1), steps


def phase_moe_knobs(torch, ops, get_config) -> dict:
    """The whole deepseek-moe-16b in bf16 (serving's RunConfig), one set of
    weights, through ``prefill`` and ``decode_step``: prefill 4 x 1024 and
    MOE_DECODE greedy steps under (i) the defaults, (ii) capacity factor
    MOE_LOW_FACTOR, twice: every step's logits bit-equal between the two,
    and the prefill's unequal to (i)'s, and (iii) factor MOE_NO_DROP, once
    with the policy's four groups and once with ``moe_groups=1``: prefill
    logits within MOE_GROUPS_TOL. Returns the launches of every run."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf
    t0 = time.time()
    cfg, dev, b, s = get_config(DEEPSEEK), torch.device("cuda"), 4, 1024
    rc = serve.run_config(torch.bfloat16)
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            rc, dev)
    prompts = torch.randint(0, cfg.vocab_size, (b, s), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(1))
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0

    def run(**knobs):
        """(every step's logits, prefill ms, decode ms a step)."""
        krc = dataclasses.replace(rc, **knobs)
        caches = tf.init_cache(cfg, b, s + MOE_DECODE, krc, dev)
        torch.cuda.synchronize()
        t1 = time.time()
        logits, caches = tf.prefill(cfg, params, prompts, caches, krc)
        torch.cuda.synchronize()
        t2 = time.time()
        steps = [logits]
        for i in range(MOE_DECODE):
            logits, caches = tf.decode_step(
                cfg, params, logits.argmax(-1)[:, None], s + i, caches, krc)
            steps.append(logits)
        torch.cuda.synchronize()
        t3 = time.time()
        del caches
        torch.cuda.empty_cache()
        return steps, (t2 - t1) * 1e3, (t3 - t2) * 1e3 / MOE_DECODE

    default = run()
    low, low_again = run(capacity_factor=MOE_LOW_FACTOR), run(
        capacity_factor=MOE_LOW_FACTOR)
    groups = run(capacity_factor=MOE_NO_DROP)
    one = run(capacity_factor=MOE_NO_DROP, moe_groups=1)
    counts = dict(ops.LAUNCHES)
    del params
    torch.cuda.empty_cache()
    if not all(torch.isfinite(x).all() for r in (default, low, groups, one)
               for x in r[0]):
        raise AssertionError("moe_knobs: non-finite logits")
    if not all(torch.equal(x, y) for x, y in zip(low[0], low_again[0])):
        raise AssertionError(f"moe_knobs: capacity_factor={MOE_LOW_FACTOR} "
                             "runs differ")
    low_diff = (low[0][0] - default[0][0]).abs().max().item()
    if torch.equal(low[0][0], default[0][0]):
        raise AssertionError(f"moe_knobs: capacity_factor={MOE_LOW_FACTOR} "
                             "did not change the prefill logits")
    err = (one[0][0].float() - groups[0][0].float()).abs().max().item()
    if err > MOE_GROUPS_TOL:
        raise AssertionError(f"moe_knobs: moe_groups=1 prefill logits "
                             f"differ by {err}")
    if counts["flash_attention"] <= 0 or counts["decode_attention"] <= 0:
        raise AssertionError(f"moe_knobs: launches {counts}")
    times = "; ".join(
        f"{name} prefill {r[1]:.2f} ms, decode {r[2]:.2f} ms a step"
        for name, r in (("defaults", default),
                        (f"factor {MOE_LOW_FACTOR}", low),
                        (f"factor {MOE_NO_DROP:.4f}", groups),
                        (f"factor {MOE_NO_DROP:.4f}, 1 group", one)))
    print(f"moe_knobs [{card()}]: {DEEPSEEK} bf16, batch {b}, prompt {s}, "
          f"{MOE_DECODE} greedy steps; factor {MOE_LOW_FACTOR}: two runs "
          f"bit-equal, prefill logits {low_diff:.3e} from the defaults'; "
          f"factor {MOE_NO_DROP:.4f}: one group against four, max abs "
          f"prefill logit diff {err:.3e} (tol {MOE_GROUPS_TOL:g}); {times}; "
          f"launches {counts}; phase {time.time() - t0:.1f} s", flush=True)
    return counts


def phase_mesh(torch, ops, get_config) -> dict:
    """gemma3-1b at full width, f32, over ``make_debug_mesh(1, 1)`` (a
    one-rank NCCL group), laid out by the sharding rules
    (``distribute_state``) with ``run_config_for``'s hook, under
    ``implicit_replication``: (a) prefill 4 x 1024 and 8 greedy steps, the
    tokens and every step's logits bit-equal to the plain run's, flash
    launched through ``ops``' DTensor branch; (b) the same prefill at
    head_pad=8 within HEAD_PAD_TOL of the plain logits. Returns the
    launches of (a) and (b)."""
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import sharding
    from repro_torch.models import transformer as tf
    t0 = time.time()
    cfg = get_config("gemma3-1b")
    rc = tf.RunConfig(param_dtype=torch.float32, cache_dtype=torch.float32,
                      rwkv_chunk=16)  # launch/serve.py's f32
    b, s, dev = 4, 1024, torch.device("cuda")

    def fresh(head_pad=1):
        gen = torch.Generator(device=dev).manual_seed(0)
        return tf.init_params(cfg, gen, dataclasses.replace(
            rc, head_pad=head_pad), dev)
    prompts = torch.randint(0, cfg.vocab_size, (b, s), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(1))
    plain_tok, plain_logits = _greedy(
        torch, tf, cfg, rc, fresh(),
        tf.init_cache(cfg, b, s + MESH_DECODE, rc, dev), prompts,
        MESH_DECODE)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mesh = mesh_mod.make_debug_mesh(1, 1)
    try:
        shape = ShapeSpec("mesh", "prefill", s, b)
        policy = sharding.choose_policy(cfg, shape)
        mrc = sharding.run_config_for(cfg, shape, mesh, base=rc,
                                      policy=policy)
        st = sharding.distribute_state(
            cfg, mesh, policy, b, params=fresh(),
            caches=tf.init_cache(cfg, b, s + MESH_DECODE, rc, dev),
            inputs={"tokens": prompts})
        for counts in (ops.LAUNCHES, ops.SHARDED):
            for k in counts:
                counts[k] = 0
        torch.cuda.reset_peak_memory_stats()
        t1 = time.time()
        with implicit_replication():
            tok, logits = _greedy(torch, tf, cfg, mrc, st["params"],
                                  st["caches"], st["inputs"]["tokens"],
                                  MESH_DECODE)
        torch.cuda.synchronize()
        mesh_s = time.time() - t1
        peak = torch.cuda.max_memory_allocated()
        if not (torch.equal(tok, plain_tok) and all(
                torch.equal(x, y) for x, y in zip(logits, plain_logits))):
            worst = max((x - y).abs().max().item()
                        for x, y in zip(logits, plain_logits))
            raise AssertionError(f"mesh: tokens or logits differ from the "
                                 f"plain run (max {worst})")
        del st, logits
        torch.cuda.empty_cache()
        prc = dataclasses.replace(mrc, head_pad=HEAD_PAD)
        st = sharding.distribute_state(
            cfg, mesh, policy, b, params=fresh(HEAD_PAD),
            caches=tf.init_cache(cfg, b, s, prc, dev),
            inputs={"tokens": prompts})
        with implicit_replication():
            padded, _ = tf.prefill(cfg, st["params"], st["inputs"]["tokens"],
                                   st["caches"], prc)
        padded = padded.full_tensor()
        err = (padded - plain_logits[0]).abs().max().item()
        counts, sharded = dict(ops.LAUNCHES), dict(ops.SHARDED)
        del st
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    if not torch.allclose(padded, plain_logits[0], atol=HEAD_PAD_TOL,
                          rtol=HEAD_PAD_TOL):
        raise AssertionError(f"mesh head_pad={HEAD_PAD}: logits differ by "
                             f"{err}")
    if counts["flash_attention"] <= 0 or counts["decode_attention"] <= 0 \
            or sharded["flash_attention"] != counts["flash_attention"]:
        raise AssertionError(f"mesh: launches {counts}, DTensor calls "
                             f"{sharded}")
    print(f"mesh [{card()}]: gemma3-1b f32 over a 1x1 mesh "
          f"({policy.mode}), batch {b}, prompt {s}, {MESH_DECODE} greedy "
          f"steps: tokens and every step's logits bit-equal to the plain "
          f"run ({mesh_s * 1e3:.1f} ms, peak {peak / 1e9:.2f} GB); "
          f"head_pad={HEAD_PAD} prefill max abs logit diff {err:.3e} (tol {HEAD_PAD_TOL:g}); flash through "
          f"ops' DTensor branch {sharded['flash_attention']} times; "
          f"launches {counts}; phase {time.time() - t0:.1f} s", flush=True)
    return counts


def phase_mesh_train(torch, ops, train, get_config, Stage) -> dict:
    """One train step of gemma3-1b's first superblock (6 layers, full
    width, f32) over ``make_debug_mesh(1, 1)``, laid out by the rules
    (parameters, ZeRO-1 moments, batch) with ``run_config_for``'s hook:
    the loss and the parameters' CRC bit-equal to the plain step's.
    Returns the mesh step's launches."""
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import sharding
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.weights import tree_map
    t0 = time.time()
    cfg = train_configs(get_config, Stage)["train gemma3-1b 6 layers f32"]
    rc, dev, b, s = train.RUN_CONFIG, torch.device("cuda"), 4, 1024
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=5)
    toks = torch.randint(0, cfg.vocab_size, (b, s + 1), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(2))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def fresh():
        return tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                              rc, dev)
    step = train.make_train_step(cfg, rc, opt_cfg)
    params = fresh()
    with train.deterministic():
        _, _, metrics = step(params, adamw_init(params), batch)
    loss, crc = metrics["loss"].item(), train.params_crc(params)
    del params, metrics
    torch.cuda.empty_cache()
    mesh = mesh_mod.make_debug_mesh(1, 1)
    try:
        shape = ShapeSpec("mesh", "train", s, b)
        policy = sharding.choose_policy(cfg, shape)
        mrc = sharding.run_config_for(cfg, shape, mesh, base=rc,
                                      policy=policy)
        params = fresh()
        st = sharding.distribute_state(cfg, mesh, policy, b, params=params,
                                       opt=adamw_init(params), inputs=batch)
        del params
        for counts in (ops.LAUNCHES, ops.SHARDED):
            for k in counts:
                counts[k] = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t1 = time.time()
        with train.deterministic(), implicit_replication():
            p_mesh, _, m_mesh = train.make_train_step(cfg, mrc, opt_cfg)(
                st["params"], st["opt"], st["inputs"])
        torch.cuda.synchronize()
        step_ms = (time.time() - t1) * 1e3
        counts, sharded = dict(ops.LAUNCHES), dict(ops.SHARDED)
        peak = torch.cuda.max_memory_allocated()
        mesh_loss = m_mesh["loss"].full_tensor().item()
        mesh_crc = train.params_crc(tree_map(lambda t: t.full_tensor(),
                                             p_mesh))
        del st, p_mesh, m_mesh
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    if mesh_loss != loss or mesh_crc != crc:
        raise AssertionError(f"mesh train: loss {mesh_loss} vs {loss}, crc "
                             f"{mesh_crc} vs {crc}")
    if min(counts["flash_attention"], counts["flash_attention_bwd"]) <= 0 \
            or sharded["flash_attention"] <= 0:
        raise AssertionError(f"mesh train: launches {counts}, DTensor calls "
                             f"{sharded}")
    print(f"mesh train [{card()}]: gemma3-1b 6 layers f32 over a 1x1 mesh "
          f"({policy.mode}), batch {b} x {s}, one step: loss {mesh_loss:.6f} "
          f"and params CRC {mesh_crc} bit-equal to the plain step "
          f"({step_ms:.1f} ms, peak {peak / 1e9:.2f} GB); launches {counts}; "
          f"phase {time.time() - t0:.1f} s", flush=True)
    return counts


def dry_run_cells() -> list:
    """The records of DRYRUN_CELLS (repro_torch.launch.dryrun on a fake
    group of 512 ranks, meta shards, no card), each with its seconds."""
    from repro_torch.launch import dryrun
    out = []
    for arch, shape, mesh_kind, _ in DRYRUN_CELLS:
        t0 = time.time()
        rec = dryrun.run_cell(arch, shape, mesh_kind, out_dir=str(
            ROOT / "build" / "dryrun"))
        rec["seconds"] = time.time() - t0
        out.append(rec)
    return out


def report_dryrun(records: list) -> list:
    """One line a dry-run cell; each must count a collective unless its
    policy needs none (data parallel with replicated parameters, serving:
    no gradient, no sharded weight), which the line then says."""
    for (arch, shape, mesh_kind, why), rec in zip(DRYRUN_CELLS, records):
        r, mem = rec["roofline"], rec["memory"]
        needs = not (rec["policy"]["mode"] == "dp_zero1"
                     and not shape.startswith("train"))
        if needs and not r["collective_s"] > 0:
            raise AssertionError(f"dryrun {arch} {shape} {mesh_kind}: no "
                                 "collective counted")
        note = "" if r["collective_s"] > 0 else (
            "; no collective: data parallel with replicated parameters, "
            "serving")
        colls = ", ".join(f"{k} {int(v)}" for k, v in
                          sorted(r["coll_counts"].items())) or "none"
        print(f"dryrun {arch} {shape} {mesh_kind} ({why}): OK, "
              f"{rec['chips']} chips, head_pad {rec['rc']['head_pad']}; per "
              f"chip (meta-device counts at H100 constants): arguments "
              f"{mem['argument_bytes'] / 1e9:.3f} GB, counted "
              f"{r['counted_flops_per_chip'] / 1e12:.4f} TFLOP and "
              f"{r['counted_bytes_per_chip'] / 1e9:.3f} GB; collectives "
              f"{colls}, wire {r['coll_wire_bytes_per_chip'] / 1e9:.4f} GB "
              f"({r['coll_wire_inter_node_bytes_per_chip'] / 1e9:.4f} GB "
              f"across nodes); compute {r['compute_s']:.4e} s, memory "
              f"{r['memory_s']:.4e} s, collective {r['collective_s']:.4e} s "
              f"({r['dominant']}), roofline_fraction "
              f"{r.get('roofline_fraction', 0.0):.4f}; "
              f"{rec['seconds']:.1f} s of one host core{note}", flush=True)
    return [{"arch": a, "shape": sh, "mesh": mk,
             "argument_bytes": rec["memory"]["argument_bytes"],
             **{k: rec["roofline"][k] for k in (
                 "counted_flops_per_chip", "counted_bytes_per_chip",
                 "coll_counts", "coll_wire_bytes_per_chip",
                 "coll_wire_inter_node_bytes_per_chip", "compute_s",
                 "memory_s", "collective_s", "dominant")}}
            for (a, sh, mk, _), rec in zip(DRYRUN_CELLS, records)]


def run_train_phase(torch, terms: dict) -> dict:
    """``phase_examples`` and ``phase_train`` in a process of its own, which
    this one waits for: the deterministic train step needs
    ``CUBLAS_WORKSPACE_CONFIG`` before the process's first cuBLAS call, and
    here that setting would also slow the serve phases' decode
    (``tools/serve_ab.py``). Hands it the counted roofline terms on its
    standard input, echoes its lines and returns its last line: the
    launches of both phases and its roofline entries."""
    torch.cuda.empty_cache()
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    proc = subprocess.run([sys.executable, __file__, "--train-phase"],
                          env=env, input=json.dumps(terms),
                          stdout=subprocess.PIPE, text=True, timeout=1000)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0:
        print("\n".join(lines), flush=True)
        raise RuntimeError(f"train phase: exit code {proc.returncode}")
    print("\n".join(lines[:-1]), flush=True)
    return json.loads(lines[-1])


def main(argv) -> int:
    if argv == ["--count-rooflines"]:  # main's counting process: no card
        sys.path.insert(0, str(PORT.parent))
        print(json.dumps(count_rooflines()))
        return 0
    if argv == ["--dry-run"]:  # main's dry-run process: no card
        sys.path.insert(0, str(PORT.parent))
        print(json.dumps(dry_run_cells()))
        return 0
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

    from repro_torch import roofline as rl
    from repro_torch.ckpt.delta import changed_blocks
    from repro_torch.configs import get_config
    from repro_torch.configs.base import Stage
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import decode_attention as dattn
    from repro_torch.kernels import delta_encode as delta
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import ssm_scan as ssm
    from repro_torch.launch import serve, train
    from repro_torch.models import Model, RunConfig
    from repro_torch.weights import tree_leaves, tree_to_torch

    if argv == ["--train-phase"]:  # run_train_phase's process
        roof = Rooflines(json.load(sys.stdin))
        examples = phase_examples(torch, ops.LAUNCHES)
        launches = phase_train(torch, train, ops.LAUNCHES, roof, get_config,
                               Stage)
        mesh_train = phase_mesh_train(torch, ops, train, get_config, Stage)
        print(json.dumps({"launches": launches, "examples": examples,
                          "mesh_train": mesh_train,
                          "roofline": roof.entries}))
        return 0
    t0 = time.time()
    phase_device(torch)
    # the meta-device counts take a minute or two of one host core: they
    # run beside the build and the kernel phases, on no card
    no_card = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    counter = subprocess.Popen(
        [sys.executable, __file__, "--count-rooflines"], text=True,
        stdout=subprocess.PIPE, env=no_card)
    # the dry run's five cells on a fake group of 512 ranks, likewise
    dry = subprocess.Popen([sys.executable, __file__, "--dry-run"],
                           text=True, stdout=subprocess.PIPE, env=no_card)
    try:
        phase_build(_build)
        kernels = {
            "delta_mask": phase_delta(torch, ops, ref, changed_blocks, rl,
                                      delta),
            "flash_attention": phase_flash(torch, ops, ref, rl, flash),
            "decode_attention": phase_decode(torch, ops, ref, rl, dattn),
            "ssm_scan": phase_ssm(torch, ops, ref, rl, ssm),
            "flash_attention_bwd": phase_flash_bwd(torch, ref, rl, flash),
            "ssm_scan_bwd": phase_ssm_bwd(torch, ref, rl, ssm)}
        for case in kernels["flash_attention_bwd"]["cases"]:
            # stablelm-12b's heads run instantiations of their own widths
            label = case["label"]
            if " D=160 " in label and "dkdv<160," not in label:
                raise AssertionError(f"flash_attention_bwd: {label}")
        for cfg, serve_over, train_over in reference_runs(get_config,
                                                          Stage):
            phase_reference(torch, Model, RunConfig, cfg, tree_to_torch,
                            serve_over)
            phase_train_reference(torch, Model, RunConfig, cfg,
                                  tree_to_torch, tree_leaves, train_over)
        out, _ = counter.communicate(timeout=900)
        if counter.returncode != 0:
            raise RuntimeError(f"roofline counts: exit code "
                               f"{counter.returncode}")
        dry_out, _ = dry.communicate(timeout=600)
        if dry.returncode != 0:
            raise RuntimeError(f"dry run: exit code {dry.returncode}")
    finally:
        for proc in (counter, dry):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    terms = json.loads(out)
    print(f"roofline: counted {len(terms)} steps on the meta device in the "
          f"background", flush=True)
    dryrun_entries = report_dryrun(json.loads(dry_out))
    roof = Rooflines(terms)
    runs = [phase_mesh(torch, ops, get_config)]
    for label, args, needs, cfg, once in serve_runs(get_config, Stage):
        run = serve_once if once else phase_serve
        runs.append(run(torch, serve, ops.LAUNCHES, roof, label, args, needs,
                        cfg))
    runs.append(phase_moe_knobs(torch, ops, get_config))
    child = run_train_phase(torch, terms)
    runs += [child["launches"], child["examples"], child["mesh_train"]]
    roof.entries += child["roofline"]
    counts = {k: sum(c[k] for c in runs) for k in ops.LAUNCHES}
    where = {"delta_mask": ("src/repro_torch/kernels/csrc/delta_mask.cu",
                            "src/repro/kernels/delta_encode.py:37"),
             "flash_attention": (
                 "src/repro_torch/kernels/csrc/flash_attention.cu",
                 "src/repro/kernels/flash_attention.py:89"),
             # the JAX package's decode attention is jnp, not Pallas
             "decode_attention": (
                 "src/repro_torch/kernels/csrc/decode_attention.cu",
                 "none: src/repro/models/attention.py:287 decode_attention "
                 "is jnp"),
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
    print(json.dumps({"roofline": roof.entries}))
    print(json.dumps({"dryrun": dryrun_entries}))
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

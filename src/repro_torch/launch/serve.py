"""Batched serving: prefill + greedy decode loop with Assise-backed
session state, on the card by default.

Port of ``repro/launch/serve.py``. Every --snapshot-every tokens the KV
caches (plus the sampler cursor) are checkpointed in delta mode through a
3-node Assise cluster: the changed-block scan of each snapshot runs on
the ``delta_mask`` kernel, and prefill attention on the flash-attention
kernel. --inject-failure kills the serving node mid-generation and
resumes decode on the cache replica from the last snapshot, the paper's
failover applied to inference sessions.

Example (on a machine with an NVIDIA H100):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
      --batch 4 --prompt-len 1024 --gen 32 --snapshot-every 8 \\
      --inject-failure 20
Add ``--device cpu`` to run on the CPU (use ``gemma3-1b-reduced`` there).
"""
from __future__ import annotations

import argparse
import shutil
import tempfile
import time
import zlib

import numpy as np
import torch

from repro_torch.ckpt import AssiseCheckpointer, CheckpointConfig
from repro_torch.ckpt.checkpoint import unflatten_into
from repro_torch.configs import get_config
from repro_torch.core import AssiseCluster
from repro_torch.kernels.ops import LAUNCHES
from repro_torch.models.transformer import Model, RunConfig
from repro_torch.weights import tree_to_torch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    """Returns (tokens (batch, gen) numpy, stats dict)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=48)
    ap.add_argument("--snapshot-every", type=int, default=16)
    ap.add_argument("--inject-failure", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--workdir", default=None,
                    help="cluster directory (default: a fresh temporary "
                         "directory, removed at the end)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    rc = RunConfig(param_dtype=torch.float32, cache_dtype=torch.float32)
    model = Model(cfg, rc, device=args.device)
    dev = model.device
    params = model.init(args.seed)
    max_len = args.prompt_len + args.gen
    launches0 = dict(LAUNCHES)

    workdir = args.workdir or tempfile.mkdtemp(prefix="repro_torch_serve_")
    cluster = AssiseCluster(workdir, n_nodes=3, replication=2,
                            n_reserve=1, mode="optimistic")
    try:
        store = cluster.open_process("server0")
        ckpt = AssiseCheckpointer(store, CheckpointConfig(
            prefix="/serve/sess0", mode="optimistic", delta=True), device=dev)
        ckpts = [ckpt]

        rng = np.random.default_rng(args.seed)
        prompts = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (args.batch, args.prompt_len),
            dtype=np.int32)).long().to(dev)

        caches = model.init_cache(args.batch, max_len)
        _sync(dev)
        t0 = time.time()
        logits, caches = model.prefill(params, prompts, caches)
        _sync(dev)
        t_prefill = time.time() - t0
        generated = []
        pos = args.prompt_len
        tok = logits.argmax(-1)[:, None]
        t_snap = t_failover = 0.0
        steps = 0
        t0 = time.time()
        i = 0
        while i < args.gen:
            generated.append(tok[:, 0].cpu().numpy())
            logits, caches = model.decode_step(params, tok, pos + i, caches)
            tok = logits.argmax(-1)[:, None]
            i += 1
            steps += 1
            if args.snapshot_every and i % args.snapshot_every == 0:
                t_s = time.time()
                ckpt.save(i, {"caches": caches},
                          extra={"i": i, "tok": tok.tolist(),
                                 "gen": np.stack(generated).tolist()})
                t_snap += time.time() - t_s
            if args.inject_failure and i == args.inject_failure:
                print(f">>> killing serving node at token {i}", flush=True)
                cluster.kill_process(store)
                cluster.kill_node(store.sfs.node_id)
                cluster.detect_failures_now()
                t_f = time.time()
                store = cluster.failover_process("server0")
                ckpt = AssiseCheckpointer(store, CheckpointConfig(
                    prefix="/serve/sess0", mode="optimistic", delta=True),
                    device=dev)
                ckpts.append(ckpt)
                flat, man = ckpt.restore()
                tree = unflatten_into({"caches": caches}, flat)
                caches = tree_to_torch(tree["caches"], dev)
                i = man["extra"]["i"]
                tok = torch.tensor(man["extra"]["tok"], dtype=torch.int64,
                                   device=dev)
                generated = [np.asarray(g) for g in man["extra"]["gen"]]
                _sync(dev)
                t_failover = time.time() - t_f
                print(f">>> session failover in {t_failover:.3f}s; "
                      f"resumed at token {i} on {store.sfs.node_id}",
                      flush=True)
                args.inject_failure = 0

        _sync(dev)
        dt = time.time() - t0
        toks = np.stack(generated, axis=1)
        print(f"prefill {args.batch}x{args.prompt_len} in {t_prefill:.2f}s; "
              f"decoded {args.gen} tokens/seq in {dt:.2f}s "
              f"({args.batch*args.gen/dt:.1f} tok/s)")
        print("sample:", toks[0][:16].tolist())
    finally:
        cluster.close()
        if args.workdir is None:
            shutil.rmtree(workdir, ignore_errors=True)
    stats = {
        "device": str(dev),
        "prefill_s": t_prefill,
        "decode_s": dt,
        "decode_tok_s": args.batch * args.gen / dt,
        # decode steps run (a failover re-runs those since the snapshot)
        # and their mean time, snapshots and failover excluded
        "decode_steps": steps,
        "decode_step_ms": (dt - t_snap - t_failover) / steps * 1e3,
        "snapshot_s": t_snap,
        "scan_s": sum(c.stats["scan_s"] for c in ckpts),
        "failover_s": t_failover,
        "snapshots": sum(c.stats["saves"] for c in ckpts),
        "bytes_logged": sum(c.stats["bytes_logged"] for c in ckpts),
        "bytes_full": sum(c.stats["bytes_full"] for c in ckpts),
        "launches": {k: LAUNCHES[k] - launches0[k] for k in LAUNCHES},
        # the last step's logits read every layer's cache: equal digests
        # mean a resumed session computed exactly what an uninterrupted one
        "logits_crc": zlib.crc32(logits.float().cpu().numpy().tobytes()),
        "logits_finite": bool(torch.isfinite(logits).all()),
    }
    return toks, stats


if __name__ == "__main__":
    main()

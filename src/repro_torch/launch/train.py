"""End-to-end training, on the card by default.

Port of ``repro/launch/train.py``. Trains an architecture with AdamW on
the ``TokenPipeline``, with the Assise layer underneath: every
--ckpt-every steps the train state (parameters and AdamW moments) is
logged in delta mode through a 3-node Assise cluster, with the pipeline's
cursor beside it; the changed-block scan runs on the ``delta_mask``
kernel, every attention layer's forward and backward on the
flash-attention kernels, and every Mamba layer's recurrence on the
``ssm_scan`` forward and backward kernels. --inject-failure kills the
worker process and its node after that many steps, restores the state
from the cache replica and resumes, bit for bit as an uninterrupted run
(the paper's failover, as a training concern). The train step runs with deterministic
algorithms, so that a resumed run repeats the uninterrupted one exactly.

Example (on a machine with an NVIDIA H100):
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
      --batch 4 --seq 1024 --steps 8 --ckpt-every 3 --inject-failure 7
Add ``--device cpu`` to run on the CPU (use a ``-reduced`` arch there).
"""
from __future__ import annotations

import argparse
import contextlib
import os
import shutil
import tempfile
import time
import zlib

import torch

from repro_torch import device as device_mod
from repro_torch.ckpt import AssiseCheckpointer, CheckpointConfig
from repro_torch.ckpt.checkpoint import _flatten, unflatten_into
from repro_torch.configs import get_config
from repro_torch.core import AssiseCluster, obs_model
from repro_torch.data import TokenPipeline
from repro_torch.kernels.ops import LAUNCHES
from repro_torch.models.transformer import Model, RunConfig, loss_fn
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.weights import tree_leaves, tree_unflatten


# what training runs: f32 weights, 64-token loss chunks, 16-token wkv chunks
RUN_CONFIG = RunConfig(param_dtype=torch.float32, cache_dtype=torch.float32,
                       loss_chunk=64, rwkv_chunk=16)


def make_train_step(cfg, rc, opt_cfg):
    """Returns step_fn(params, opt_state, batch) -> (params, opt_state,
    metrics): the loss and every parameter's gradient by autograd, then
    AdamW, which updates the parameters and moments in place (the JAX
    step donates them). Under the profiler a step is a ``train/step``
    span."""
    def step_fn(params, opt_state, batch):
        with obs_model.span("step", batch["tokens"], "train"):
            leaves = tree_leaves(params)
            for p in leaves:
                p.requires_grad_(True)
            loss, metrics = loss_fn(cfg, rc, params, batch)
            grads = tree_unflatten(params,
                                   torch.autograd.grad(loss, leaves))
            with torch.no_grad():
                params, opt_state, gnorm = adamw_update(opt_cfg, grads,
                                                        opt_state, params)
        return params, opt_state, {"loss": loss.detach(), "gnorm": gnorm,
                                   "xent": metrics["xent"].detach(),
                                   "aux": metrics["aux"].detach()}
    return step_fn


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms for the enclosed run (the backward of the
    embedding and label gathers sum without atomics). On the card cuBLAS
    also needs ``CUBLAS_WORKSPACE_CONFIG`` set before the process's first
    cuBLAS call: the command line sets it, a caller of ``main`` sets it
    itself, and without it torch raises at the first product."""
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev)


def to_device(batch, device, param_dtype):
    """A pipeline batch on ``device``: tokens and labels as int64 indices,
    a front end's embeddings (``frontend_embeds``) in the parameters'
    dtype."""
    return {k: torch.from_numpy(v).to(
        device, param_dtype if k == "frontend_embeds" else torch.int64)
        for k, v in batch.items()}


def params_crc(params) -> int:
    """CRC-32 of every parameter's bytes, leaves in name order."""
    crc = 0
    for _, arr in sorted(_flatten(params).items()):
        crc = zlib.crc32(arr.tobytes(), crc)
    return crc


def main(argv=None, cfg=None, rc=None):
    """Returns (losses, stats). ``losses`` holds every step run, a step
    re-run after a failover included. ``cfg`` (an ``ArchConfig``)
    overrides ``--arch``, for a config that has no name, such as a depth
    cut; ``rc`` (a ``RunConfig``) overrides ``RUN_CONFIG``, for knobs the
    command line does not take, such as ``remat``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b-reduced")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-every", type=int, default=5)
    ap.add_argument("--mode", default="pessimistic",
                    choices=["pessimistic", "optimistic"])
    ap.add_argument("--inject-failure", type=int, default=0,
                    help="kill worker+node after this step, then restore")
    ap.add_argument("--workdir", default=None,
                    help="cluster directory (default: a fresh temporary "
                         "directory, removed at the end)")
    ap.add_argument("--no-delta", action="store_true")
    ap.add_argument("--delta-block", type=int,
                    default=CheckpointConfig.delta_block,
                    help="bytes of a delta block; a leaf reaches the "
                         "delta_mask kernel from 8 blocks up")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = cfg or get_config(args.arch)
    rc = rc or RUN_CONFIG
    dev = device_mod.resolve(args.device)
    model = Model(cfg, rc, device=dev)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=5)
    ckpt_cfg = CheckpointConfig(mode=args.mode, delta=not args.no_delta,
                                delta_block=args.delta_block)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    launches0 = dict(LAUNCHES)

    # Assise substrate: this worker + one cache replica + one reserve.
    workdir = args.workdir or tempfile.mkdtemp(prefix="repro_torch_train_")
    cluster = AssiseCluster(workdir, n_nodes=3, replication=2,
                            n_reserve=1, mode=args.mode)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=args.seq,
                         global_batch=args.batch, seed=7,
                         frontend=cfg.n_frontend, d_model=cfg.d_model)
    try:
        store = cluster.open_process("trainer0")
        ckpt = AssiseCheckpointer(store, ckpt_cfg, device=dev)
        ckpts = [ckpt]
        params = model.init(0)
        opt_state = adamw_init(params)
        step_fn = make_train_step(cfg, rc, opt_cfg)

        losses = []
        t_step = t_ckpt = t_failover = 0.0
        n_run = 0
        with deterministic():
            step = 0
            while step < args.steps:
                batch = to_device(pipe.next(), dev, rc.param_dtype)
                device_mod.sync(dev)
                t0 = time.time()
                params, opt_state, metrics = step_fn(params, opt_state,
                                                     batch)
                loss = metrics["loss"].item()
                t_step += time.time() - t0
                n_run += 1
                losses.append(loss)
                print(f"step {step:4d} loss {loss:.4f} gnorm "
                      f"{metrics['gnorm'].item():.3f}", flush=True)
                if args.ckpt_every and (step + 1) % args.ckpt_every == 0:
                    t0 = time.time()
                    ckpt.save(step, {"params": params, "opt": opt_state},
                              extra={"pipe": pipe.snapshot().decode()})
                    t_ckpt += time.time() - t0
                    print(f"  ckpt@{step}: logged "
                          f"{ckpt.stats['bytes_logged']/1e6:.2f}MB (full "
                          f"would be {ckpt.stats['bytes_full']/1e6:.2f}MB)",
                          flush=True)
                step += 1

                if args.inject_failure and step == args.inject_failure:
                    print(">>> injecting failure: killing worker + primary "
                          "node", flush=True)
                    cluster.kill_process(store)
                    cluster.kill_node(store.sfs.node_id)
                    cluster.detect_failures_now()
                    t0 = time.time()
                    store = cluster.failover_process("trainer0")
                    ckpt = AssiseCheckpointer(store, ckpt_cfg, device=dev)
                    ckpts.append(ckpt)
                    restored = ckpt.restore()
                    if restored is None:
                        raise RuntimeError("no checkpoint on the replica")
                    flat, man = restored
                    tree = unflatten_into({"params": params,
                                           "opt": opt_state}, flat)
                    params, opt_state = tree["params"], tree["opt"]
                    pipe.restore(man["extra"]["pipe"].encode())
                    step = man["step"] + 1
                    device_mod.sync(dev)
                    t_failover = time.time() - t0
                    print(f">>> failover complete in {t_failover:.3f}s; "
                          f"resumed at step {step} (replica node "
                          f"{store.sfs.node_id})", flush=True)
                    args.inject_failure = 0  # only once
        print(f"done: {args.steps} steps ({n_run} run); final loss "
              f"{losses[-1]:.4f} (start {losses[0]:.4f})")
    finally:
        pipe.close()
        cluster.close()
        if args.workdir is None:
            shutil.rmtree(workdir, ignore_errors=True)
    stats = {
        "device": str(dev),
        "steps_run": n_run,
        "step_ms": t_step / n_run * 1e3,
        "ckpt_s": t_ckpt,
        "scan_s": sum(c.stats["scan_s"] for c in ckpts),
        "failover_s": t_failover,
        "saves": sum(c.stats["saves"] for c in ckpts),
        "bytes_logged": sum(c.stats["bytes_logged"] for c in ckpts),
        "bytes_full": sum(c.stats["bytes_full"] for c in ckpts),
        "params_crc": params_crc(params),
        "launches": {k: LAUNCHES[k] - launches0[k] for k in LAUNCHES},
        "peak_bytes": torch.cuda.max_memory_allocated(dev)
        if dev.type == "cuda" else None,
    }
    return losses, stats


if __name__ == "__main__":
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    main()

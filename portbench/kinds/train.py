"""Training: the port's train step (``repro_torch.launch.train.
make_train_step`` with ``RUN_CONFIG`` and ``AdamWConfig()``) under its
deterministic algorithms, one step a batch of fresh rows from the seed.

Set-up makes the weights from the seed and builds one step with its
optimizer state, then drives that same object through the first
``CHECKED_STEPS`` steps (the cell's warm-up too), keeping what the
reference is compared on: each step's loss, each leaf's norm of the first
gradient as the optimizer got it (its first moment over 1 - b1 after one
step) and of the parameters' change over those steps. The window then
runs steps on until ``seconds`` have passed, each ending with its loss on
the host as the train command prints it. Afterwards the program's state
is freed and the plain reference trains the same weights on the same
batches; ``readings_of`` gives the numbers compared. ``controls`` adds
them for the reference in the program's place in a lower precision
("tf32", "fp8") or with half of each batch left out ("half_batch").
"""
from __future__ import annotations

import contextlib
import math
import time

import torch

from portbench import check, traffic, weights
from portbench.record import Record

CHECKED_STEPS = 3  # set-up's steps, which the reference follows
TRACED_STEPS = 3  # a traced run traces the window's first steps


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _norms(tree) -> dict:
    return {n: float(torch.linalg.vector_norm(t, dtype=torch.float64))
            for n, t in weights.named(tree).items()}


def _change(params, leaves, seed, device) -> dict:
    """Each leaf's norm of its change from the seed's initial weights."""
    start = weights.named(weights.make(leaves, torch.float32, seed, device))
    return {n: float(torch.linalg.vector_norm(p.detach() - start[n],
                                              dtype=torch.float64))
            for n, p in weights.named(params).items()}


@contextlib.contextmanager
def _router_probs(n: int):
    """Records the router probabilities the program routes by (the
    softmax of the logits its ``_route`` gets, as it computes them) for
    its first ``n`` routings: the forward pass of a step, which a
    recompute repeats."""
    from repro_torch.models import moe
    real = moe._route
    probs = []

    def spy(logits, spec, capacity):
        if len(probs) < n:
            with torch.no_grad():
                probs.append(torch.softmax(logits.detach().float(), dim=-1))
        return real(logits, spec, capacity)
    moe._route = spy
    try:
        yield probs
    finally:
        moe._route = real


def run(cell, seed: int, seconds: float, trace: bool, device, t_start,
        controls=()):
    from repro_torch.launch import train as port_train
    from repro_torch.optim import adamw as port_adamw

    from portbench import profiling

    device = torch.device(device)
    cfg, tr, fam = cell.config, cell.traffic, cell.family
    rec = Record(cell=cell.name, config=cfg, traffic=tr, work=fam.work)
    rc = port_train.RUN_CONFIG
    fam.port.check_run_config(cfg, rc)
    arch = fam.port.arch_config(cfg)
    leaves = fam.layout.leaves(cfg)
    vocab = cfg["vocab_size"]
    n_check = CHECKED_STEPS
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    def mark(part):  # the end of a part of set-up, the card's work done
        _sync(device)
        rec.setup_marks[part] = time.perf_counter() - t_start
    mark("imports")
    params = weights.make(leaves, torch.float32, seed, device)
    opt_cfg = port_adamw.AdamWConfig()
    opt = port_adamw.adamw_init(params)
    mark("weights_and_state")
    step_fn = port_train.make_train_step(arch, rc, opt_cfg)
    losses = []
    spans = rec.spans
    real_update = port_train.adamw_update
    n_moe = sum(r for kind, r in fam.layout.stages(cfg) if kind == "moe")
    with port_train.deterministic():
        for t in range(1, n_check + 1):
            batch = traffic.batch(tr, vocab, seed, t, device)
            with _router_probs(n_moe if t == 1 else 0) as routes:
                params, opt, out = step_fn(params, opt, batch)
            losses.append(out["loss"].item())
            if t == 1:
                routed = routes
                first = {n: g / (1 - opt_cfg.b1)
                         for n, g in _norms(opt["m"]).items()}
        mark("checked_steps")
        change = _change(params, leaves, seed, device)
        mark("change")
        rec.setup_s = time.perf_counter() - t_start

        stretch = profiling.Stretch(device) if trace else None
        in_stretch = False
        if trace:  # spans inside the step: its update, synchronised
            def timed_update(*args, **kw):
                _sync(device)
                a = time.perf_counter()
                res = real_update(*args, **kw)
                _sync(device)
                b = time.perf_counter()
                spans.append(("fwd_bwd", a - timed_update.start, in_stretch))
                spans.append(("optimizer", b - a, in_stretch))
                return res
            port_train.adamw_update = timed_update
        try:
            t0 = time.perf_counter()
            deadline = t0 + seconds
            last, k, bad = t0, 0, 0
            while last < deadline:
                batch = traffic.batch(tr, vocab, seed, n_check + 1 + k,
                                      device)
                if trace and k == 0:
                    stretch.start("steps")
                    in_stretch = True
                if trace:
                    _sync(device)
                    timed_update.start = time.perf_counter()
                params, opt, out = step_fn(params, opt, batch)
                loss = out["loss"].item()
                last = time.perf_counter()
                bad += not math.isfinite(loss)
                k += 1
                if in_stretch and (k == TRACED_STEPS or last >= deadline):
                    stretch.stop()
                    rec.traced_steps = k
                    in_stretch = False
        finally:
            port_train.adamw_update = real_update
    rec.window_s = last - t0
    rec.steps = k
    rec.tokens = k * tr["batch"] * tr["seq_len"]
    if device.type == "cuda":
        rec.peak_bytes = torch.cuda.max_memory_allocated(device)
    if trace:
        rec.stretch = stretch.summary()
    del params, opt, out, step_fn, batch
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ref = reference_readings(cfg, fam, seed, device, tr, n_check, opt_cfg)
    readings = readings_of((losses, first, change, routed), ref, cfg)
    for control in controls:  # the reference in the program's place
        how = {"rows": slice(0, tr["batch"] // 2)} \
            if control == "half_batch" else {"precision": control}
        low = reference_readings(cfg, fam, seed, device, tr, n_check,
                                 opt_cfg, **how)
        readings.update({f"{k}.{control}": v
                         for k, v in readings_of(low, ref, cfg).items()})
    return rec, readings, k, bad


def reference_readings(cfg, fam, seed, device, tr, n_check, opt_cfg,
                       precision="f32", rows=None):
    """The reference's (losses, first gradient norms, change norms, first
    step's router probabilities) over the first ``n_check`` steps from the
    seed's weights."""
    leaves = fam.layout.leaves(cfg)
    params = weights.named(weights.make(leaves, torch.float32, seed,
                                        device))
    batches = [traffic.batch(tr, cfg["vocab_size"], seed, t, device)
               for t in range(1, n_check + 1)]
    opt = {k: getattr(opt_cfg, k) for k in (
        "lr", "b1", "b2", "eps", "weight_decay", "grad_clip",
        "warmup_steps")}
    probs = []
    losses, first = fam.reference.train(cfg, params, batches, opt,
                                        precision=precision, rows=rows,
                                        router_probs=probs)
    start = weights.named(weights.make(leaves, torch.float32, seed, device))
    change = {n: float(torch.linalg.vector_norm(p - start[n],
                                                dtype=torch.float64))
              for n, p in params.items()}
    return losses, first, change, probs


def readings_of(prog, ref, cfg) -> dict:
    """The numbers compared: the worst step's loss gap, the worst leaf's
    gap of the first gradient's norm and of the change's norm (leaves
    whose reference gradient is nought to rounding left out), and, with
    routed experts, how far the first step's routing lies from the
    reference's (``check.route_regret``)."""
    losses, first, change, probs = prog
    r_losses, r_first, r_change, r_probs = ref
    out = {"loss_gap": check.loss_gap(losses, r_losses),
           "grad_gap": check.worst(check.leaf_gaps(first, r_first))[0],
           "change_gap": check.worst(check.leaf_gaps(
               change, r_change, skip=check.still(r_first)))[0]}
    if r_probs:
        out["route_regret"] = check.route_regret(
            r_probs, probs, cfg["num_experts_per_tok"])
    return out

"""Serving: closed-loop rounds through the port's ``Model`` as
``repro_torch.launch.serve`` drives it: ``init_cache`` once, then a round
is one ``prefill`` of every session's prompt and a ``decode_step`` a
token, greedy, each token copied to the host as a server streams it.

Set-up makes the weights from the seed, the cache for the mix's prompt
and output lengths, and warms the cell's two shapes (one prefill,
``WARM_STEPS`` decode steps). The window then runs rounds until
``seconds`` have passed; a round under way stops at the next step
boundary and its tokens so far count. A traced run traces the window's
first round, its prefill and its decode steps as two parts. The
readings that decide ``correct`` compare a sample, drawn from the seed,
of the sessions that finished with the plain reference's
logits over each prompt and its served tokens (``check.served_gap``);
``controls`` adds the same reading of the reference in each of those
lower precisions in the program's place (``calibrate.py``).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import check, seeds, traffic, weights
from portbench.record import Record

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
WARM_STEPS = 2


def run(cell, seed: int, seconds: float, trace: bool, device, t_start,
        controls=()):
    from repro_torch.launch import serve as port_serve
    from repro_torch.models import transformer as port_model

    from portbench import aten, profiling

    device = torch.device(device)
    cfg, tr, spec, fam = cell.config, cell.traffic, cell.spec, cell.family
    rec = Record(cell=cell.name, config=cfg, traffic=tr, work=fam.work)
    dtype = DTYPES[cfg["dtype"]]
    rc = port_serve.run_config(dtype)
    fam.port.check_run_config(cfg, rc)
    model = port_model.Model(fam.port.arch_config(cfg), rc, device=device)
    vocab = cfg["vocab_size"]
    sessions, plen, gen = tr["sessions"], tr["prompt_len"], tr["gen"]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    def mark(part):  # the end of a part of set-up, the card's work done
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        rec.setup_marks[part] = time.perf_counter() - t_start
    mark("imports")
    params = weights.make(fam.layout.leaves(cfg), dtype, seed, device)
    caches = model.init_cache(sessions, plen + gen)
    mark("weights_and_cache")
    logits, caches = model.prefill(
        params, traffic.prompts(tr, vocab, seed, traffic.WARM_UP, device),
        caches)
    tok = logits.argmax(-1)[:, None]
    for i in range(WARM_STEPS):
        logits, caches = model.decode_step(params, tok, plen + i, caches)
        tok = logits.argmax(-1)[:, None]
    tok.cpu()
    mark("warm_up")
    rec.setup_s = time.perf_counter() - t_start

    stretch = profiling.Stretch(device) if trace else None
    rounds = []  # (prompts, served tokens (sessions, n) on the host)
    t0 = time.perf_counter()
    deadline = t0 + seconds
    last = t0
    r = 0
    while time.perf_counter() < deadline:
        prompts = traffic.prompts(tr, vocab, seed, r, device)
        traced = trace and r == 0
        if traced:
            stretch.start("prefill")
        a = time.perf_counter()
        logits, caches = model.prefill(params, prompts, caches)
        tok = logits.argmax(-1)[:, None]
        out = [tok[:, 0].cpu()]
        rec.spans.append(("prefill", time.perf_counter() - a, traced))
        rec.prefills.append((sessions, plen))
        if traced:
            stretch.stop()
            rec.traced_prefills.append((sessions, plen))
            stretch.start("decode")
        last = time.perf_counter()
        for i in range(1, gen):
            if last >= deadline:
                break
            logits, caches = model.decode_step(params, tok, plen + i - 1,
                                               caches)
            tok = logits.argmax(-1)[:, None]
            out.append(tok[:, 0].cpu())
            t = time.perf_counter()
            rec.itl_s.append(t - last)
            rec.spans.append(("decode_step", t - last, traced))
            rec.decodes.append((sessions, plen + i - 1))
            last = t
        if traced:
            stretch.stop()
        rounds.append((prompts, torch.stack(out, 1)))
        r += 1
    rec.window_s = last - t0
    rec.tokens = sum(t.numel() for _, t in rounds)
    rec.steps = len(rec.decodes)
    if device.type == "cuda":
        rec.peak_bytes = torch.cuda.max_memory_allocated(device)

    finished = [k for k, (_, t) in enumerate(rounds) if t.shape[1] == gen]
    if not finished:  # the window ended inside the first round: finish it
        prompts, served = rounds[-1]
        tok = served[:, -1:].to(device)
        out = [served]
        for i in range(served.shape[1], gen):
            logits, caches = model.decode_step(params, tok, plen + i - 1,
                                               caches)
            tok = logits.argmax(-1)[:, None]
            out.append(tok.cpu())
        rounds[-1] = (prompts, torch.cat(out, 1))
        finished = [len(rounds) - 1]
    if trace:
        count = aten.Count()
        with count:
            model.decode_step(params, tok, plen, caches)
        rec.counters["aten_calls_decode"] = sum(count.calls.values())
        rec.stretch = stretch.summary() if stretch else None
    del caches, logits, tok
    if device.type == "cuda":
        torch.cuda.empty_cache()

    pool = [(k, s) for k in finished for s in range(sessions)]
    rng = np.random.default_rng(seeds.derive(seed, "sample"))
    pick = rng.choice(len(pool), size=min(spec["check"]["sessions"],
                                          len(pool)), replace=False)
    rows = [pool[j] for j in sorted(pick)]
    served = torch.stack([rounds[k][1][s] for k, s in rows]).to(device)
    seqs = torch.cat([torch.stack([rounds[k][0][s] for k, s in rows]),
                      served[:, :-1]], dim=1)
    readings = {"max_gap": float("inf")}
    if int(served.max()) < vocab and int(served.min()) >= 0:
        ref = fam.reference.serve_logits(cfg, params, seqs, plen - 1)
        readings["max_gap"] = check.served_gap(ref, served)
        for prec in controls:  # the reference in a lower precision
            low = fam.reference.serve_logits(cfg, params, seqs, plen - 1,
                                             precision=prec)
            readings["max_gap." + prec] = check.served_gap(
                ref, low.argmax(-1))
            del low
    return rec, readings, sessions * len(rounds), 0

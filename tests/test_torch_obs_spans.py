"""The model path's spans (``repro_torch.core.obs_model.span``): nothing while
the profiler is off, the span tree under it, the host clock they share
with the profiler's events, no change to a single bit of the model's
results, and how device times nest. On the CPU the spans carry no
device times; the ``timed`` tests give them timing events that read the
host's clock instead. The ``cuda`` test reads real ones on the card."""
import contextlib
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import (ArchConfig, AttnSpec, LayerSpec,
                                      MLPSpec, Stage)
from repro_torch.core import obs_model
from repro_torch.launch import train as ptrain
from repro_torch.models import transformer as tf
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.weights import tree_leaves

LAYERS = 2
B, S, CHUNK = 2, 32, 16  # two loss chunks a row
PROMPT, STEPS = 8, 3
CPU = torch.device("cpu")


def _cfg():
    attn = AttnSpec(n_heads=4, n_kv_heads=2, head_dim=16, rope=True,
                    rope_theta=1e4)
    spec = LayerSpec(kind="attn", attn=attn,
                     mlp=MLPSpec(kind="dense", d_ff=96, act="swiglu"))
    return ArchConfig(name="tiny-dense", family="dense", d_model=64,
                      vocab_size=512,
                      stages=(Stage(block=(spec,), repeat=LAYERS),))


def _rc(remat=True):
    return tf.RunConfig(param_dtype=torch.float32,
                        cache_dtype=torch.float32, loss_chunk=CHUNK,
                        remat=remat)


def _params(cfg, rc, device=CPU):
    gen = torch.Generator(device=device).manual_seed(0)
    return tf.init_params(cfg, gen, rc, device=device)


def _batch(device=CPU):
    g = torch.Generator().manual_seed(1)
    return {k: torch.randint(0, 512, (B, S), generator=g).to(device)
            for k in ("tokens", "labels")}


def _serve(cfg, rc, params, device=CPU):
    """A prefill and ``STEPS`` greedy decode steps; every step's logits."""
    model = tf.Model(cfg, rc, device=device)
    caches = model.init_cache(B, PROMPT + STEPS)
    prompts = _batch(device)["tokens"][:, :PROMPT]
    logits, caches = model.prefill(params, prompts, caches)
    out = [logits]
    for i in range(STEPS):
        logits, caches = model.decode_step(
            params, logits.argmax(-1)[:, None], PROMPT + i, caches)
        out.append(logits)
    return out


def _train(cfg, rc, device=CPU):
    """One train step from fresh weights: (loss, every gradient), and the
    step's metrics through ``make_train_step``."""
    params = _params(cfg, rc, device)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = tf.loss_fn(cfg, rc, params, _batch(device))
    grads = torch.autograd.grad(loss, leaves)
    step = ptrain.make_train_step(cfg, rc, AdamWConfig())
    params = _params(cfg, rc, device)
    _, _, metrics = step(params, adamw_init(params), _batch(device))
    return loss.detach(), grads, metrics["loss"]


@pytest.fixture(autouse=True)
def fresh_spans():
    obs_model.reset_model_spans()
    yield
    obs_model.reset_model_spans()


@pytest.fixture()
def records(monkeypatch):
    """Every span record, in the order the records close (the spans
    themselves keep totals alone)."""
    got = []
    close = obs_model.ModelSpans.close

    def keep(self, rec):
        got.append(rec)
        close(self, rec)
    monkeypatch.setattr(obs_model.ModelSpans, "close", keep)
    return got


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


class _Plain(contextlib.nullcontext):
    """A span that is a bare ``nullcontext``."""

    def __enter__(self):
        return self

    def input(self, x):
        return x

    output = input


def test_nothing_is_recorded_with_the_profiler_off(records):
    cfg, rc = _cfg(), _rc()
    _serve(cfg, rc, _params(cfg, rc))
    _train(cfg, rc)
    assert obs_model.model_spans() == {"spans": {}, "counters": {}}
    assert records == []


@pytest.mark.parametrize("what", ["decode", "train"])
def test_spans_off_dispatch_no_aten_call(what, monkeypatch):
    """With the profiler off, a decode step and a train step dispatch the
    aten calls they dispatch with every span a bare ``nullcontext``."""
    cfg, rc = _cfg(), _rc()
    params = _params(cfg, rc)

    def count():
        if what == "decode":
            model = tf.Model(cfg, rc, device=CPU)
            caches = model.init_cache(B, PROMPT + 1)
            tok = _batch()["tokens"][:, :1]
            with _Count() as c:
                model.decode_step(params, tok, PROMPT, caches)
            return c.n
        step = ptrain.make_train_step(cfg, rc, AdamWConfig())
        p = _params(cfg, rc)
        opt = adamw_init(p)
        batch = _batch()
        with _Count() as c:
            step(p, opt, batch)
        return c.n
    with_spans = count()
    monkeypatch.setattr(obs_model, "span", lambda *a, **kw: _Plain())
    assert count() == with_spans > 0


@pytest.mark.parametrize("remat", [True, False])
def test_span_tree_under_the_profiler(remat, records):
    cfg, rc = _cfg(), _rc(remat)
    params = _params(cfg, rc)
    with profile(activities=[ProfilerActivity.CPU]):
        _serve(cfg, rc, params)
        _train(cfg, rc)
    got = obs_model.model_spans()["spans"]
    chunks = S // CHUNK
    assert got["prefill/step"]["fwd"]["count"] == 1
    assert got["decode/step"]["fwd"]["count"] == STEPS
    for mode, steps in (("prefill", 1), ("decode", STEPS)):
        for layer in ("attn", "attn.core", "mlp"):
            assert got[f"{mode}/{layer}"] == {"fwd": got[f"{mode}/{layer}"][
                "fwd"]}, (mode, layer)  # no backward in serving
            assert got[f"{mode}/{layer}"]["fwd"]["count"] == LAYERS * steps
        assert got[f"{mode}/head"]["fwd"]["count"] == steps
    # the loss and gradients once outside the step, once inside it
    assert got["train/step"]["fwd"]["count"] == 1
    for layer in ("attn", "attn.core", "mlp"):
        phases = got[f"train/{layer}"]
        assert phases["fwd"]["count"] == phases["bwd"]["count"] == 2 * LAYERS
        assert ("recompute" in phases) == remat
        if remat:
            assert phases["recompute"]["count"] == 2 * LAYERS
    head = got["train/head"]  # a span a loss chunk, recomputed either way
    assert head["fwd"]["count"] == head["bwd"]["count"] == 2 * chunks
    assert head["recompute"]["count"] == 2 * chunks
    for phases in got.values():
        for v in phases.values():
            assert v["device_ms"] is None and v["host_ms"] > 0

    assert {r.phase for r in records} == (
        {"fwd", "bwd", "recompute"})
    for r in records:
        assert r.t0 <= r.t1
        if r.parent is not None:
            p = r.parent
            assert p.t0 <= r.t0 and r.t1 <= p.t1, (r, p)
            assert r.step == p.step
        if r.phase == "recompute" and r.name != "train/head":
            assert r.parent.phase in ("bwd", "recompute")
    assert obs_model.model_spans()["counters"] == {}  # bytes: the card's


def test_host_intervals_hold_the_ops_issued_inside_them(records):
    """The spans' ``time.time_ns()`` and the profiler's events share a
    clock: each decode attention's one softmax starts inside its
    ``decode/attn.core`` span, and every softmax of the steps does."""
    cfg, rc = _cfg(), _rc()
    params = _params(cfg, rc)
    model = tf.Model(cfg, rc, device=CPU)
    caches = model.init_cache(B, PROMPT + STEPS)
    tok = _batch()["tokens"][:, :1]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(STEPS):
            model.decode_step(params, tok, PROMPT + i, caches)
    starts = [e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.name() == "aten::softmax"]
    cores = [r for r in records if r.name == "decode/attn.core"]
    assert len(cores) == len(starts) == LAYERS * STEPS
    for r in cores:
        assert sum(r.t0 <= t <= r.t1 for t in starts) == 1
    steps = [r for r in records if r.name == "decode/step"]
    assert all(any(r.t0 <= t <= r.t1 for r in steps) for t in starts)


@pytest.mark.parametrize("remat", [True, False])
def test_tracing_changes_no_bit(remat):
    cfg, rc = _cfg(), _rc(remat)
    params = _params(cfg, rc)
    off = (_serve(cfg, rc, params), _train(cfg, rc))
    with profile(activities=[ProfilerActivity.CPU]):
        on = (_serve(cfg, rc, params), _train(cfg, rc))
    assert obs_model.model_spans()["spans"]
    for a, b in zip(off[0], on[0]):
        assert torch.equal(a, b)
    (loss0, grads0, step0), (loss1, grads1, step1) = off[1], on[1]
    assert torch.equal(loss0, loss1) and torch.equal(step0, step1)
    assert len(grads0) == len(grads1)
    assert all(torch.equal(a, b) for a, b in zip(grads0, grads1))


class _Clock:
    """A timing event that reads the host's clock."""

    def record(self, stream):
        self.t = time.perf_counter_ns()

    def query(self):
        return True

    def elapsed_time(self, end):
        return (end.t - self.t) / 1e6


@pytest.fixture()
def timed(monkeypatch):
    """Spans on the CPU with timing events on the host's clock, and an
    allocator whose running total grows by 1 GiB a read."""
    monkeypatch.setattr(obs_model, "_timed", lambda device: True)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: "stream")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "Event", lambda **kw: _Clock())
    total = [0]

    def allocated(index):
        total[0] += 2 ** 30
        return total[0]
    monkeypatch.setattr(obs_model, "_allocated", allocated)


@pytest.mark.parametrize("remat", [True, False])
def test_device_times_nest(remat, timed, records):
    """A span's self time is its own less its children's, and a backward's
    time leaves out the recompute that ran inside it, which its
    ``recompute`` records count."""
    cfg, rc = _cfg(), _rc(remat)
    params = _params(cfg, rc)
    with profile(activities=[ProfilerActivity.CPU]):
        _serve(cfg, rc, params)
        step = ptrain.make_train_step(cfg, rc, AdamWConfig())
        p = _params(cfg, rc)
        step(p, adamw_init(p), _batch())
    got = obs_model.model_spans()
    assert got["counters"]["decode/attn.core.bytes"] == \
        LAYERS * STEPS * 2 ** 30  # at decode attention alone, 1 GiB a span
    for r in records:
        kids = [c for c in records if c.parent is r]
        if r.phase == "bwd":
            assert r.less_ms == pytest.approx(
                sum(c.device_ms for c in kids if c.phase == "recompute")
                + sum(c.less_ms for c in kids if c.phase == "bwd"))
            assert (r.less_ms > 0) == (r.name == "train/head" or (
                remat and r.name == "train/mlp"))
        assert r.self_ms >= -1e-6
    for (name, phase), (n, _, dev, own) in obs_model.MODEL.totals.items():
        mine = [r for r in records if (r.name, r.phase) == (name, phase)]
        assert n == len(mine)
        assert dev == pytest.approx(sum(r.device_ms for r in mine))
        assert own == pytest.approx(sum(r.self_ms for r in mine))


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_device_times_and_bytes_on_the_card(cuda):
    """On the card every span reads device time from its timing events;
    a decode step's attention, MLP and head lie inside its step, and
    decode attention's counter holds its outputs alone: the decode kernel
    reads the caches where they lie, copying nothing."""
    cfg, rc = _cfg(), _rc()
    params = _params(cfg, rc, cuda)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        _serve(cfg, rc, params, cuda)
        _train(cfg, rc, cuda)
    got = obs_model.model_spans()
    spans = got["spans"]
    for name, phases in spans.items():
        for phase, v in phases.items():
            assert v["device_ms"] > 0, (name, phase)
            assert v["self_device_ms"] <= v["device_ms"] + 1e-6
    step = spans["decode/step"]["fwd"]["device_ms"]
    inside = sum(spans[f"decode/{k}"]["fwd"]["device_ms"]
                 for k in ("attn", "mlp", "head"))
    assert inside <= step
    out = B * 4 * 16 * 4  # (B, 1, H, D) f32, a whole 512-byte block
    assert list(got["counters"]) == ["decode/attn.core.bytes"]
    assert got["counters"]["decode/attn.core.bytes"] == LAYERS * STEPS * out


def test_a_long_trace_reads_its_events_as_it_goes(timed, monkeypatch):
    """Past ``RESOLVE_AT`` closed records, a step's start reads the events
    the card has passed and returns them to the pool, and the totals come
    out as when every record is read at the end."""
    cfg, rc = _cfg(), _rc()
    params = _params(cfg, rc)
    with profile(activities=[ProfilerActivity.CPU]):
        _serve(cfg, rc, params)
    whole = obs_model.model_spans()["spans"]
    obs_model.reset_model_spans()
    monkeypatch.setattr(obs_model, "RESOLVE_AT", 1)
    made = []
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda **kw: made.append(1) or _Clock())
    per_step = 3 * LAYERS + 2  # the step, the head, each layer's three
    with profile(activities=[ProfilerActivity.CPU]):
        _serve(cfg, rc, params)
        # read at the last step's start: only that step's records wait
        assert len(obs_model.MODEL.pending) == per_step
    assert len(made) < 2 * per_step * (1 + STEPS)  # events came back
    got = obs_model.model_spans()["spans"]
    assert {k: {p: v["count"] for p, v in ph.items()}
            for k, ph in got.items()} == {
        k: {p: v["count"] for p, v in ph.items()} for k, ph in whole.items()}
    assert not obs_model.MODEL.pending

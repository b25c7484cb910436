"""The per-layer metrics that read the port's own spans (``spans.py``,
``metrics/*``) over a tiny dense model of the port: None from an empty
record, from spans without device times (on the CPU) and from a port
that keeps no spans; over spans with timing events (here events that
read the host's clock), the mean per traced step of what they name."""
import sys
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.core
from portbench import manifest
from repro_torch.configs.base import (ArchConfig, AttnSpec, LayerSpec,
                                      MLPSpec, Stage)
from repro_torch.core import obs_model
from repro_torch.launch import train as ptrain
from repro_torch.models import transformer as tf
from repro_torch.optim.adamw import AdamWConfig, adamw_init

LAYERS = 2
B, S, CHUNK = 2, 32, 16  # two loss chunks a row
PROMPT, STEPS = 8, 3
READERS = ["decode_attn_ms.serve", "decode_attn_gib.serve",
           "decode_mlp_ms.serve", "head_ms.train", "mlp_ms.train",
           "recompute_ms.train"]


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


def _params(cfg, rc):
    return tf.init_params(cfg, torch.Generator().manual_seed(0), rc,
                          device=torch.device("cpu"))


def _batch():
    g = torch.Generator().manual_seed(1)
    return {k: torch.randint(0, 512, (B, S), generator=g)
            for k in ("tokens", "labels")}


def _traced(remat=True):
    """A prefill, ``STEPS`` decode steps and one train step, under the
    profiler."""
    cfg, rc = _cfg(), _rc(remat)
    params = _params(cfg, rc)
    model = tf.Model(cfg, rc, device=torch.device("cpu"))
    caches = model.init_cache(B, PROMPT + STEPS)
    with profile(activities=[ProfilerActivity.CPU]):
        prompts = _batch()["tokens"][:, :PROMPT]
        logits, caches = model.prefill(params, prompts, caches)
        for i in range(STEPS):
            logits, caches = model.decode_step(
                params, logits.argmax(-1)[:, None], PROMPT + i, caches)
        step = ptrain.make_train_step(cfg, rc, AdamWConfig())
        p = _params(cfg, rc)
        step(p, adamw_init(p), _batch())


@pytest.fixture(autouse=True)
def fresh_spans():
    obs_model.reset_model_spans()
    yield
    obs_model.reset_model_spans()


@pytest.fixture()
def records(monkeypatch):
    """Every span record, in the order the records close."""
    got = []
    close = obs_model.ModelSpans.close

    def keep(self, rec):
        got.append(rec)
        close(self, rec)
    monkeypatch.setattr(obs_model.ModelSpans, "close", keep)
    return got


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


def _read_all():
    return {name: manifest.reader(name)(None) for name in READERS}


def test_readers_read_nothing_from_an_empty_record():
    assert _read_all() == dict.fromkeys(READERS)


def test_readers_read_nothing_without_device_times():
    _traced()
    assert obs_model.model_spans()["spans"]["decode/step"]
    assert _read_all() == dict.fromkeys(READERS)


def test_readers_read_nothing_from_a_port_without_spans(monkeypatch, timed):
    """A port without ``core/obs_model.py`` (its import fails) reads None,
    and nothing raises."""
    _traced()
    assert None not in _read_all().values()
    monkeypatch.delattr(repro_torch.core, "obs_model")
    monkeypatch.setitem(sys.modules, "repro_torch.core.obs_model", None)
    assert _read_all() == dict.fromkeys(READERS)


@pytest.mark.parametrize("remat", [True, False])
def test_readers_over_timed_spans(remat, timed, records):
    _traced(remat)
    got = _read_all()

    def total(name, phase="fwd"):
        return sum(r.device_ms for r in records
                   if r.name == name and r.phase == phase)

    assert got["decode_attn_ms.serve"] == pytest.approx(
        total("decode/attn.core") / STEPS)
    assert got["decode_attn_gib.serve"] == LAYERS  # 1 GiB a span
    assert got["decode_mlp_ms.serve"] == pytest.approx(
        total("decode/mlp") / STEPS)
    for name, layer in (("head_ms.train", "train/head"),
                        ("mlp_ms.train", "train/mlp")):
        want = sum(total(layer, ph) for ph in ("fwd", "recompute", "bwd"))
        assert got[name] == pytest.approx(want) and want > 0
    # the outermost recompute spans, each a forward computed again once
    top = [r for r in records if r.phase == "recompute"
           and r.parent.phase != "recompute"]
    assert len(top) == (2 * LAYERS if remat else 0) + S // CHUNK
    assert got["recompute_ms.train"] == pytest.approx(
        sum(r.device_ms for r in top))

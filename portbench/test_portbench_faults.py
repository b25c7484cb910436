"""Whole runs of tiny cells on the CPU through the harness (the look for a
card skipped): a sound run comes out correct, a run with the timed path
broken underneath does not, and the controls the limits rest on read
beyond them. The limits here are the tiny sizes' own, set as the cells'
are: above the program's readings, below the control's and the faults'."""
import time

import pytest
import torch

from portbench import check, harness, manifest, tiny
from portbench.kinds import serve, train

SERVE = "mistral-nemo-12b.chat"
TRAIN = "mistral-nemo-12b-l5.train"
SERVE_LIMITS = {"max_gap": 5e-3}
TRAIN_LIMITS = {"loss_gap": 5e-7, "grad_gap": 5e-6, "change_gap": 5e-5}


def run(name, limits, seed=3):
    return harness.run(manifest.benchmark(), name, seed, 0.3, False, "cpu",
                       time.perf_counter(),
                       cell=tiny.cell(name, "float32", limits))


@pytest.mark.parametrize("name,limits", [(SERVE, SERVE_LIMITS),
                                         (TRAIN, TRAIN_LIMITS)])
def test_sound_run_is_correct(name, limits):
    out = run(name, limits)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"


def test_token_altered_where_produced(monkeypatch):
    from repro_torch.models.transformer import Model
    real = Model.decode_step

    def altered(self, params, tokens, pos, caches):
        logits, caches = real(self, params, tokens, pos, caches)
        if pos == tiny.TINY_TRAFFIC["prompt_len"] + 2:  # one token a session
            logits = logits.roll(1, dims=-1)
        return logits, caches
    monkeypatch.setattr(Model, "decode_step", altered)
    out = run(SERVE, SERVE_LIMITS)
    assert not out["correct"], out["checks"]


def test_step_returns_its_state_unchanged(monkeypatch):
    from repro_torch.launch import train as port_train

    def unchanged(cfg, grads, opt_state, params):
        return params, dict(opt_state, step=opt_state["step"] + 1), \
            torch.zeros(())
    monkeypatch.setattr(port_train, "adamw_update", unchanged)
    out = run(TRAIN, TRAIN_LIMITS)
    assert not out["correct"], out["checks"]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out(monkeypatch):
    from repro_torch.launch import train as port_train
    real = port_train.loss_fn

    def half(cfg, rc, params, batch):
        rows = batch["tokens"].shape[0] // 2
        return real(cfg, rc, params, {k: v[:rows] for k, v in batch.items()})
    monkeypatch.setattr(port_train, "loss_fn", half)
    out = run(TRAIN, TRAIN_LIMITS)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_serve_control_fails(seed):
    """The fp8 reference in the program's place reads beyond the limit
    that the program's bf16 tokens stay under, and far beyond them."""
    cell = tiny.cell(SERVE, "float32", SERVE_LIMITS)
    _, readings, _, _ = serve.run(cell, seed, 0.001, False, "cpu",
                                  time.perf_counter(), controls=("fp8",))
    assert readings["max_gap.fp8"] > SERVE_LIMITS["max_gap"]
    assert readings["max_gap.fp8"] >= 3 * readings["max_gap"]
    assert check.judge(readings, SERVE_LIMITS)[0]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_train_control_fails(seed):
    """The reference in TF32 in the program's place fails a limit the
    program keeps; so does the reference on half of each batch."""
    cell = tiny.cell(TRAIN, limits=TRAIN_LIMITS)
    _, readings, _, _ = train.run(cell, seed, 0.001, False, "cpu",
                                  time.perf_counter(),
                                  controls=("tf32", "half_batch"))
    assert check.judge(readings, TRAIN_LIMITS)[0]
    for control in ("tf32", "half_batch"):
        low = {k: readings[f"{k}.{control}"] for k in TRAIN_LIMITS}
        assert not check.judge(low, TRAIN_LIMITS)[0], (control, low)


@pytest.mark.parametrize("name,limits,host_read", [
    (SERVE, SERVE_LIMITS, {"prefill_ms.serve", "decode_step_ms.serve",
                           "aten_calls_decode.serve"}),
    (TRAIN, TRAIN_LIMITS, {"fwd_bwd_ms.train", "optimizer_ms.train"})])
def test_traced_run_reads_its_per_layer_metrics(name, limits, host_read):
    """A --trace 1 run reports per-layer metrics only, those of its cell;
    on the CPU the host's spans and counters (no device share: no card,
    no peak)."""
    out = harness.run(manifest.benchmark(), name, 5, 5.0, True, "cpu",
                      time.perf_counter(),
                      cell=tiny.cell(name, "float32", limits))
    own = {m["name"] for m in manifest.metrics(manifest.benchmark(), name,
                                               True)}
    assert host_read <= set(out["metrics"]) <= own
    assert out["correct"]
    assert out["device"]["window_s"] > 0

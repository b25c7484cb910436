"""The port's ``RunConfig`` knobs ``capacity_factor``, ``moe_groups`` and
``remat`` against the JAX package's, on the CPU at reduced sizes, and the
dry run's flags for them.

Weights come from the JAX package's ``init_params`` and are handed to the
port as numpy (``repro_torch.weights``); tokens are made from a seed with
numpy. Everything runs in float32. The MoE stage of each reduced arch is
stacked twice, so that training has a repeat to recompute (a reduced
config has one repeat a stage).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.ckpt.checkpoint as jckpt
import repro_torch.ckpt.checkpoint as pckpt
from repro.configs import get_config as jax_get_config
from repro.models import transformer as jtf
from repro_torch.configs import SHAPES
from repro_torch.configs import get_config as port_get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.sharding import run_config_for
from repro_torch.models import transformer as ptf
from repro_torch.weights import params_from_jax, tree_leaves, tree_unflatten

CPU = torch.device("cpu")
PORT_RC = ptf.RunConfig(param_dtype=torch.float32,
                        cache_dtype=torch.float32, loss_chunk=64,
                        rwkv_chunk=16)  # the small_rc fixture's chunks
KNOBS = ("capacity_factor", "moe_groups", "remat")
ARCHS = ["deepseek-moe-16b-reduced", "phi3.5-moe-42b-a6.6b-reduced"]
# serving: logits within 1e-4 of JAX's; training: the loss within 1e-5
# relative and each gradient leaf within 1e-5 of its largest element, as
# tests/test_torch_train.py
SERVE_TOL = dict(atol=1e-4, rtol=1e-4)
REL = 1e-5


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _configs(arch):
    """The JAX and port configs of ``arch`` with the last stage (the MoE
    layers) repeated twice."""
    def fix(cfg):
        st = list(cfg.stages)
        st[-1] = dataclasses.replace(st[-1], repeat=2)
        return dataclasses.replace(cfg, stages=tuple(st))
    return fix(jax_get_config(arch)), fix(port_get_config(arch))


def test_knobs_match_jax_run_config():
    """The three fields carry the JAX ``RunConfig``'s names, types and
    defaults."""
    jf = {f.name: f for f in dataclasses.fields(jtf.RunConfig)}
    pf = {f.name: f for f in dataclasses.fields(ptf.RunConfig)}
    for name in KNOBS:
        assert pf[name].default == jf[name].default, name
        assert type(pf[name].default) is type(jf[name].default), name
    assert ptf.RunConfig().capacity_factor == 1.25
    assert ptf.RunConfig().moe_groups == 0 and ptf.RunConfig().remat


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("knob", [{"capacity_factor": 0.1},
                                  {"moe_groups": 2}])
def test_serving_knobs_match_jax(arch, knob, small_rc):
    """Prefill of 4 x 40 tokens, then 4 teacher-forced decode steps, with a
    knob set in both packages: logits within 1e-4. Factor 0.1 keeps 3
    slots an expert of a 40-token prefill group (80 assignments on 4
    experts) and 1 of a decode group; 2 groups split the prefill's 160
    tokens where the policy takes 4 sequences, and the decode's 4 tokens
    where it takes 1 group. The port's logits under the factor differ from
    its logits without it."""
    jcfg, pcfg = _configs(arch)
    b, s, n_dec = 4, 40, 4
    jrc = dataclasses.replace(small_rc, **knob)
    prc = dataclasses.replace(PORT_RC, **knob)
    model = jtf.Model(jcfg, jrc)
    jparams = model.init(jax.random.key(0))
    jcaches = model.init_cache(b, s + n_dec)
    params = params_from_jax(_np_tree(jparams), CPU)
    caches = ptf.init_cache(pcfg, b, s + n_dec, prc, CPU)
    plain = ptf.init_cache(pcfg, b, s + n_dec, PORT_RC, CPU)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size,
                                             (b, s + n_dec), dtype=np.int32)
    jl, jcaches = jax.jit(model.prefill)(jparams, jnp.asarray(toks[:, :s]),
                                         jcaches)
    t = torch.from_numpy(toks).long()
    pl, caches = ptf.prefill(pcfg, params, t[:, :s], caches, prc)
    bl, plain = ptf.prefill(pcfg, params, t[:, :s], plain, PORT_RC)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **SERVE_TOL)
    differs = not torch.equal(pl, bl)
    jdecode = jax.jit(model.decode_step)
    for step in range(n_dec):
        pos = s + step
        jl, jcaches = jdecode(jparams, jnp.asarray(toks[:, pos:pos + 1]),
                              jnp.asarray(pos, jnp.int32), jcaches)
        pl, caches = ptf.decode_step(pcfg, params, t[:, pos:pos + 1], pos,
                                     caches, prc)
        bl, plain = ptf.decode_step(pcfg, params, t[:, pos:pos + 1], pos,
                                    plain, PORT_RC)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **SERVE_TOL)
        differs |= not torch.equal(pl, bl)
    # groups change the function only through what drops: at the default
    # factor these routes drop nothing
    assert differs or "capacity_factor" not in knob


def _batch(vocab, b=2, s=100, seed=0):
    """S = 100 in 64-token loss chunks, a few labels masked with -1."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1), dtype=np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    batch["labels"][0, :5] = -1
    return batch


def _port_grads(pcfg, rc, params, batch):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = ptf.loss_fn(pcfg, rc, params, {
        k: torch.from_numpy(v) for k, v in batch.items()})
    return loss, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("arch", ARCHS)
def test_training_without_remat_matches_jax(arch, small_rc):
    """``remat=False`` in both packages: the loss and every gradient leaf
    against ``jax.value_and_grad``; the port's loss and gradients without
    recompute equal those with it bit for bit."""
    jcfg, pcfg = _configs(arch)
    jrc = dataclasses.replace(small_rc, remat=False)
    jparams = jtf.init_params(jcfg, jax.random.key(0), jrc)
    batch = _batch(jcfg.vocab_size)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jtf.loss_fn(jcfg, jrc, p, jax.tree.map(jnp.asarray,
                                                         batch)),
        has_aux=True))(jparams)
    params = params_from_jax(_np_tree(jparams), CPU)
    loss, grads = _port_grads(pcfg, dataclasses.replace(PORT_RC,
                                                        remat=False),
                              params, batch)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=REL, atol=1e-7)
    got = pckpt._flatten(tree_unflatten(params, grads))
    exp = jckpt._flatten(jg)
    assert sorted(got) == sorted(exp)
    for name, e in exp.items():
        np.testing.assert_allclose(got[name], e, rtol=0,
                                   atol=REL * np.abs(e).max(), err_msg=name)
    loss_r, grads_r = _port_grads(pcfg, PORT_RC, params, batch)
    assert torch.equal(loss, loss_r)
    assert all(torch.equal(a, r) for a, r in zip(grads, grads_r))


def test_remat_off_keeps_the_forward(monkeypatch):
    """With ``remat`` on, the stacked stage's forward runs again in the
    backward; with it off, it runs once. Counted on the MoE dispatch, one a
    MoE layer."""
    _, pcfg = _configs("deepseek-moe-16b-reduced")
    params = ptf.init_params(pcfg, torch.Generator().manual_seed(0),
                             PORT_RC, device=CPU)
    batch = _batch(pcfg.vocab_size, s=40)
    calls = []
    real = ptf.moe_mod._dispatch
    monkeypatch.setattr(ptf.moe_mod, "_dispatch",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    n = {}
    for remat in (True, False):
        calls.clear()
        _port_grads(pcfg, dataclasses.replace(PORT_RC, remat=remat),
                    params, batch)
        n[remat] = len(calls)
    assert n == {True: 4, False: 2}


# -- the dry run's flags ------------------------------------------------------

# deepseek-moe-16b-reduced cannot be laid out on pod1 (its 4 experts do not
# split over the 16-wide model axis), so the cell runs deepseek-moe-16b at
# its published widths cut to 5 layers (the dense layer 0 and 4 stacked MoE
# layers: 2.85e9 parameters, tensor parallel with FSDP as the whole arch)
DRY_CELL = ["--arch", "deepseek-moe-16b", "--shape", "train_4k", "--mesh",
            "pod1"]
DRY_FLAGS = {"default": [], "no_remat": ["--no-remat"],
             "factor": ["--capacity-factor", "0.1"],
             # a multiple of the data axis (16), over which the dispatch
             # groups are laid out
             "groups": ["--moe-groups", "16"]}


def _cut(cfg):
    return dataclasses.replace(cfg, stages=(
        cfg.stages[0], dataclasses.replace(cfg.stages[1], repeat=4)))


@pytest.fixture(scope="module")
def dry_records(tmp_path_factory):
    """Each flag set of ``DRY_FLAGS`` through ``dryrun.main`` in this
    process (which runs ``run_cell``): its cell's record."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        real = dryrun.get_config
        mp.setattr(dryrun, "get_config", lambda arch: _cut(real(arch)))
        try:
            for key, flags in DRY_FLAGS.items():
                d = tmp_path_factory.mktemp(key)
                with pytest.raises(SystemExit) as done:
                    dryrun.main(DRY_CELL + flags + ["--out-dir", str(d)])
                assert done.value.code == 0, key
                (path,) = d.glob("*.json")
                out[key] = json.loads(path.read_text())
            out["run_config_for"] = run_config_for(
                _cut(port_get_config("deepseek-moe-16b")),
                SHAPES["train_4k"], make_production_mesh(),
                base=ptf.RunConfig(capacity_factor=0.1, moe_groups=16,
                                   remat=False))
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
    return out


def test_dryrun_no_remat_counts_fewer_flops(dry_records):
    """Without recompute the stacked MoE layers' forward is not counted
    twice."""
    default, off = dry_records["default"], dry_records["no_remat"]
    assert default["rc"]["remat"] == "True" and off["rc"]["remat"] == "False"
    assert off["counted"]["flops"] < default["counted"]["flops"]


def test_dryrun_capacity_factor_counts_fewer_flops(dry_records):
    """Factor 0.1 gives each expert fewer slots, so smaller products."""
    default, low = dry_records["default"], dry_records["factor"]
    assert low["rc"]["capacity_factor"] == "0.1"
    assert low["counted"]["flops"] < default["counted"]["flops"]


def test_dryrun_moe_groups_is_accepted(dry_records):
    """16 groups of 65,536 tokens where the policy takes 256 sequences:
    other capacities, so other counts. (2 groups would not split over the
    data axis.)"""
    rec = dry_records["groups"]
    assert rec["rc"]["moe_groups"] == "16"
    assert dry_records["default"]["rc"]["moe_groups"] == "0"
    assert rec["counted"]["flops"] != dry_records["default"]["counted"][
        "flops"]


def test_run_config_for_carries_the_knobs(dry_records):
    rc = dry_records["run_config_for"]
    assert (rc.capacity_factor, rc.moe_groups, rc.remat) == (0.1, 16, False)
    assert rc.shard is not None


@pytest.mark.parametrize("flag", [["--attn-impl", "naive"],
                                  ["--chunk-q", "256"], ["--chunk-kv", "256"],
                                  ["--mamba-chunk", "64"], ["--dump-hlo"]])
def test_dryrun_jax_only_flags_raise(flag, tmp_path):
    with pytest.raises(SystemExit, match="JAX-only"):
        dryrun.main(DRY_CELL + flag + ["--out-dir", str(tmp_path)])
    assert not list(tmp_path.iterdir())

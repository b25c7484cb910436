"""The port's training slice (repro_torch.models train mode, loss_fn,
repro_torch.launch.train, the train-state checkpoint) against the JAX
package, on the CPU at reduced sizes.

Inputs come from a seed with numpy; the JAX parameters are handed to the
port as numpy (``repro_torch.weights``). Everything runs in float32.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ckpt.checkpoint as jckpt
import repro.core as jcore
import repro_torch.ckpt.checkpoint as pckpt
import repro_torch.core as pcore
import repro_torch.kernels.ref as pref
from repro.configs import get_config as jax_get_config
from repro.data import TokenPipeline
from repro.launch import train as jtrain
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro_torch.configs import get_config as port_get_config
from repro_torch.launch import train as ptrain
from repro_torch.models import transformer as ptf
from repro_torch.optim import adamw as padamw
from repro_torch.weights import (params_from_jax, tree_leaves, tree_to_torch,
                                 tree_unflatten)

CPU = torch.device("cpu")
PORT_RC = ptf.RunConfig(param_dtype=torch.float32,
                        cache_dtype=torch.float32, loss_chunk=64,
                        rwkv_chunk=16)
# f32 loss and gradients: the loss within 1e-5 relative, each gradient leaf
# within 1e-5 of its largest element (the measured worst is ~1e-6)
REL = 1e-5


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _configs(arch, repeat0=1):
    def fix(cfg):
        if repeat0 == 1:
            return cfg
        st = list(cfg.stages)
        st[0] = dataclasses.replace(st[0], repeat=repeat0)
        return dataclasses.replace(cfg, stages=tuple(st))
    return fix(jax_get_config(arch)), fix(port_get_config(arch))


def _batch(vocab, b=2, s=100, seed=0, cfg=None):
    """S = 100 with 64-token loss chunks: two chunks, 28 padded labels; a
    few labels masked with -1. For an arch with a front end, random
    ``frontend_embeds`` (std 1) drawn after the tokens."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1), dtype=np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    batch["labels"][0, :5] = -1
    if cfg is not None and cfg.n_frontend:
        batch["frontend_embeds"] = rng.standard_normal(
            (b, cfg.n_frontend, cfg.d_model)).astype(np.float32)
    return batch


def _grads_by_name(params, grads):
    """{leaf name: gradient} for gradients in ``tree_leaves`` order."""
    return pckpt._flatten(tree_unflatten(params, grads))


@pytest.mark.parametrize("arch,repeat0", [
    ("gemma3-1b-reduced", 1), ("gemma3-1b-reduced", 2),
    ("deepseek-moe-16b-reduced", 1), ("qwen1.5-32b-reduced", 1),
    ("stablelm-12b-reduced", 1), ("phi3.5-moe-42b-a6.6b-reduced", 1),
    ("jamba-1.5-large-398b-reduced", 1), ("rwkv6-1.6b-reduced", 1),
    ("rwkv6-1.6b-reduced", 2), ("minicpm3-4b-reduced", 2),
    ("qwen2-vl-2b-reduced", 1), ("musicgen-large-reduced", 1),
    ("musicgen-large-reduced", 2)])
def test_loss_and_grads_match_jax(arch, repeat0, small_rc):
    """The loss, its parts and every gradient leaf against
    ``jax.value_and_grad(loss_fn)``. gemma3-1b with a first stage of
    repeat 2 runs the recomputed (remat) stage, as JAX's checkpointed
    scan; the MoE archs carry the aux loss; Jamba's seven Mamba layers run
    the scan's backward (``ssm_scan_bwd_ref``), where JAX differentiates
    its chunked associative scan. RWKV6 differentiates its wkv chunks
    (with repeat 2, under recompute); minicpm3's stacked MLA layers run
    flash attention's backward with Dv != D under recompute. qwen2-vl and
    musicgen (also with repeat 2, under recompute) take random
    ``frontend_embeds``, whose rows the loss drops; the embeddings get no
    gradient, the parameters get theirs through the front end's rows."""
    jcfg, pcfg = _configs(arch, repeat0)
    jparams = jtf.init_params(jcfg, jax.random.key(0), small_rc)
    batch = _batch(jcfg.vocab_size, cfg=jcfg)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jtf.loss_fn(jcfg, small_rc, p, jax.tree.map(
            jnp.asarray, batch)), has_aux=True))(jparams)
    params = params_from_jax(_np_tree(jparams), CPU)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    pl, pm = ptf.loss_fn(pcfg, PORT_RC, params, {
        k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(pl, leaves)
    for got, exp in ((pl, jl), (pm["xent"], jm["xent"]),
                     (pm["aux"], jm["aux"])):
        np.testing.assert_allclose(got.item(), float(exp), rtol=REL,
                                   atol=1e-7)
    if any(spec.mlp.kind == "moe" for spec in pcfg.layer_specs()):
        assert pm["aux"].item() > 0
    got, exp = _grads_by_name(params, grads), jckpt._flatten(jg)
    assert sorted(got) == sorted(exp)
    for name, e in exp.items():
        assert got[name].shape == e.shape, name
        np.testing.assert_allclose(got[name], e, rtol=0,
                                   atol=REL * np.abs(e).max(), err_msg=name)


def test_remat_gives_the_same_gradients(monkeypatch):
    """Train mode recomputes each repeat of a stacked stage in the backward
    (the JAX package's ``jax.checkpoint`` of its scan body): attention runs
    its forward again once a layer of the 2-repeat stage, and the loss and
    every gradient equal those of the same forward kept whole (prefill mode,
    no cache) bit for bit."""
    _, pcfg = _configs("gemma3-1b-reduced", 2)
    gen = torch.Generator().manual_seed(0)
    params = ptf.init_params(pcfg, gen, PORT_RC, device=CPU)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in
             _batch(pcfg.vocab_size, s=40).items()}
    calls = []
    real = pref.flash_attention_ref
    monkeypatch.setattr(pref, "flash_attention_ref",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    out = []
    for mode in ("train", "prefill"):
        calls.clear()
        hidden, _, aux = ptf.forward(pcfg, params, batch["tokens"],
                                     mode=mode)
        e, m = ptf._chunked_xent(pcfg, PORT_RC, params, hidden,
                                 batch["labels"])
        loss = e / torch.clamp(m, min=1.0) + 0.01 * aux
        out.append((loss, torch.autograd.grad(loss, leaves), len(calls)))
    n_layers = len(list(pcfg.layer_specs()))
    stacked = len(pcfg.stages[0].block) * pcfg.stages[0].repeat
    assert out[1][2] == n_layers and out[0][2] == n_layers + stacked
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
    loss, _ = ptf.loss_fn(pcfg, PORT_RC, params, batch)
    assert torch.equal(loss, out[0][0])


def test_train_step_tracks_jax(tmp_path, monkeypatch):
    """Five steps of the port's train loop from the JAX package's parameters
    (handed to ``Model.init``), on the same ``TokenPipeline`` batches,
    against JAX's ``make_train_step``: losses within 1e-4."""
    arch, steps, b, s = "gemma3-1b-reduced", 5, 2, 64
    jcfg = jax_get_config(arch)
    rc = jtf.RunConfig(chunk_q=32, chunk_kv=32, mamba_chunk=16,
                       rwkv_chunk=16, loss_chunk=64,
                       param_dtype=jnp.float32, cache_dtype=jnp.float32)
    jparams = jtf.init_params(jcfg, jax.random.key(0), rc)
    start = _np_tree(jparams)
    opt = jadamw.adamw_init(jparams)
    step_fn = jtrain.make_train_step(jcfg, rc, jadamw.AdamWConfig(
        lr=1e-3, warmup_steps=5))
    pipe = TokenPipeline(vocab_size=jcfg.vocab_size, seq_len=s,
                         global_batch=b, seed=7, prefetch=0)
    jlosses = []
    for _ in range(steps):
        batch = {k: jnp.asarray(v) for k, v in pipe.next().items()}
        jparams, opt, metrics = step_fn(jparams, opt, batch)
        jlosses.append(float(metrics["loss"]))
    monkeypatch.setattr(ptf.Model, "init",
                        lambda self, seed: params_from_jax(start, CPU))
    losses, stats = ptrain.main(
        ["--device", "cpu", "--arch", arch, "--steps", str(steps),
         "--batch", str(b), "--seq", str(s), "--ckpt-every", "0",
         "--workdir", str(tmp_path)])
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=1e-4)
    assert stats["steps_run"] == steps and stats["saves"] == 0


@pytest.fixture()
def small_blocks(monkeypatch):
    """The delta block of each delta_mask call; with ``--delta-block 256``
    (2 KiB tiles) the reduced model's leaves reach the delta_mask path."""
    calls = []
    real = pckpt.delta_mask

    def spy(*a, **kw):
        calls.append(kw["block"])
        return real(*a, **kw)

    monkeypatch.setattr(pckpt, "delta_mask", spy)
    return calls


def _check_failover_resume(arch, small_blocks, tmp_path):
    """Checkpoints every 3 steps, a kill after step 7, a restore from the
    replica (train state and pipeline cursor): the resumed steps' losses
    and the final parameters equal an uninterrupted run's bit for bit."""
    args = ["--device", "cpu", "--arch", arch, "--steps", "8", "--batch",
            "2", "--seq", "32", "--delta-block", "256"]
    losses, stats = ptrain.main(args + [
        "--ckpt-every", "3", "--inject-failure", "7",
        "--workdir", str(tmp_path / "a")])
    assert small_blocks and set(small_blocks) == {256}
    ref, ref_stats = ptrain.main(args + ["--ckpt-every", "0",
                                         "--workdir", str(tmp_path / "b")])
    # steps 0-6, then 6 and 7 again from the checkpoint after step 5
    assert stats["steps_run"] == 9 and len(losses) == 9
    assert losses[:7] == ref[:7] and losses[7:] == ref[6:]
    assert stats["params_crc"] == ref_stats["params_crc"]
    assert stats["saves"] == 2 and ref_stats["saves"] == 0
    assert stats["failover_s"] > 0 and stats["device"] == "cpu"
    # every parameter and moment changes at every step
    assert 0 < stats["bytes_logged"] <= stats["bytes_full"]
    assert stats["launches"] == {k: 0 for k in stats["launches"]}
    assert stats["peak_bytes"] is None
    return losses


def test_failover_resume_is_bit_exact(small_blocks, tmp_path):
    _check_failover_resume("gemma3-1b-reduced", small_blocks, tmp_path)


def test_jamba_failover_resume_is_bit_exact(small_blocks, tmp_path):
    """The same kill and resume on Jamba's hybrid superblock: seven Mamba
    layers train through the scan's backward, the attention layer through
    flash attention's, and four MoE layers carry the aux loss; A_log, D and
    their AdamW moments go through the checkpoint with every other
    leaf."""
    losses = _check_failover_resume("jamba-1.5-large-398b-reduced",
                                    small_blocks, tmp_path)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_rwkv_failover_resume_is_bit_exact(small_blocks, tmp_path):
    """The same kill and resume on RWKV6: the wkv chunks' gradients, and
    the f32 ``w0`` and ``bonus_u`` with their AdamW moments through the
    checkpoint."""
    losses = _check_failover_resume("rwkv6-1.6b-reduced", small_blocks,
                                    tmp_path)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


@pytest.mark.parametrize("arch", ["qwen2-vl-2b-reduced",
                                  "musicgen-large-reduced"])
def test_frontend_failover_resume_is_bit_exact(arch, small_blocks, tmp_path):
    """The same kill and resume with a front end: each step's
    ``frontend_embeds`` come from the pipeline's Philox stream for that
    step, so the resumed steps see the same embeddings (and musicgen the
    same sinusoidal positions) as the uninterrupted run."""
    losses = _check_failover_resume(arch, small_blocks, tmp_path)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_train_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        ptrain.main(["--arch", "gemma3-1b-reduced", "--steps", "1"])


# -- the train state through the checkpointer ---------------------------------


def _train_states(small_rc):
    """Three JAX train states of gemma3-1b-reduced, as numpy trees: the
    initial one, the one after an AdamW step (every leaf changes), and that
    one with a single embedding row changed (a sparse update)."""
    cfg = jax_get_config("gemma3-1b-reduced")
    params = jtf.init_params(cfg, jax.random.key(1), small_rc)
    opt = jadamw.adamw_init(params)
    grads = jax.tree.map(lambda p: jnp.full_like(p, 1e-3), params)
    params2, opt2, _ = jadamw.adamw_update(jadamw.AdamWConfig(), grads, opt,
                                           params)
    sparse = _np_tree({"params": params2, "opt": opt2})
    sparse["params"]["embed"] = sparse["params"]["embed"].copy()
    sparse["params"]["embed"][3] += 1.0
    return [_np_tree({"params": params, "opt": opt}),
            _np_tree({"params": params2, "opt": opt2}), sparse]


def test_train_state_leaves_match_jax(small_rc):
    """Leaf names and ``.npy`` bytes of the port's train state equal the
    JAX package's, the 0-d int32 ``step`` included."""
    state = _train_states(small_rc)[1]
    jflat = jckpt._flatten(state)
    pflat = pckpt._flatten(tree_to_torch(state, CPU))
    assert sorted(pflat) == sorted(jflat)
    assert pflat["/opt/step"].dtype == np.int32
    assert pflat["/opt/step"].shape == ()
    for name, leaf in jflat.items():
        assert pckpt._encode_leaf(pflat[name]) == jckpt._encode_leaf(leaf)


def test_train_state_checkpoint_matches_jax(small_rc, tmp_path):
    """Delta saves of the train state log the JAX package's bytes (all of
    them after an AdamW step, one block after a sparse change), and the
    restored state, rebuilt into a torch template, equals the saved
    one."""
    states = _train_states(small_rc)
    jc = jcore.AssiseCluster(str(tmp_path / "jax"), n_nodes=3,
                             replication=2, n_reserve=1)
    pc = pcore.AssiseCluster(str(tmp_path / "port"), n_nodes=3,
                             replication=2, n_reserve=1)
    try:
        js, ps = jc.open_process("p"), pc.open_process("p")
        jck = jckpt.AssiseCheckpointer(js, jckpt.CheckpointConfig(
            delta_block=256))
        pck = pckpt.AssiseCheckpointer(ps, pckpt.CheckpointConfig(
            delta_block=256), device="cpu")
        for step, state in enumerate(states):
            jck.save(step, state, extra={"pipe": "1,7,1,0"})
            pck.save(step, tree_to_torch(state, CPU),
                     extra={"pipe": "1,7,1,0"})
            assert pck.stats["bytes_logged"] == jck.stats["bytes_logged"]
            assert pck.stats["bytes_full"] == jck.stats["bytes_full"]
            assert json.loads(ps.get(f"/ckpt/run0/MANIFEST.{step}")) == \
                json.loads(js.get(f"/ckpt/run0/MANIFEST.{step}"))
            if step == 1:
                logged_before_sparse = pck.stats["bytes_logged"]
            logged = pck.stats["bytes_logged"]
        # the last save logged a few 256-byte blocks of one leaf
        assert 0 < logged - logged_before_sparse <= 2 * 256
        pflat, man = pck.restore()
        assert man["step"] == 2
    finally:
        jc.close()
        pc.close()
    template = tree_to_torch(states[0], CPU)
    back = pckpt.unflatten_into(template, pflat)
    assert back["opt"]["step"].dtype == torch.int32
    assert int(back["opt"]["step"]) == 1
    saved = pckpt._flatten(tree_to_torch(states[2], CPU))
    for name, leaf in pckpt._flatten(back).items():
        assert leaf.dtype == saved[name].dtype
        assert leaf.tobytes() == saved[name].tobytes(), name

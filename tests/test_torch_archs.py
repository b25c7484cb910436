"""stablelm-12b, phi3.5-moe-42b-a6.6b and qwen1.5-32b at their published
head and expert shapes, narrowed, against the JAX package; and
``chip_smoke.py``'s list of what runs on the card.

The ``-reduced`` configs make every head 16 wide and cut experts to 4, so
they never reach stablelm's 160-wide heads (5120 / 32), phi3.5-moe's 16
experts or qwen1.5's 128-wide MHA heads. Here each arch keeps those and
is narrowed otherwise: 2 layers (one stacked stage, so training
recomputes it), the reduced vocabulary and MLP widths. Inputs come from a
numpy seed, the weights from JAX's init through
``repro_torch.weights.params_from_jax``; everything runs in float32 on the
CPU, where the port's kernels run their plain versions.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.ckpt.checkpoint as pckpt
from repro.ckpt.checkpoint import _flatten as jax_flatten
from repro.configs import get_config as jax_get_config
from repro.kernels import ref as jref
from repro.models import transformer as jtf
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get_config as port_get_config
from repro_torch.configs.base import Stage
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import ops
from repro_torch.models import transformer as ptf
from repro_torch.weights import (caches_from_jax, params_from_jax,
                                 tree_leaves, tree_unflatten)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
PORT_RC = ptf.RunConfig(param_dtype=torch.float32, cache_dtype=torch.float32,
                        loss_chunk=64, rwkv_chunk=16)  # small_rc's chunks
# prefill, decode and cache leaves within 1e-4 (tests/test_torch_models.py);
# the loss within 1e-5 relative and each gradient leaf within 1e-5 of its
# largest element (tests/test_torch_train.py)
TOL = dict(atol=1e-4, rtol=1e-4)
REL = 1e-5

# arch -> (d_model, the attention's published heads, the MoE's experts)
NARROW = {
    # GQA 32 on 8 as 4 on 1, 160 wide: 5120 / 32
    "stablelm-12b": (640, dict(n_heads=4, n_kv_heads=1, head_dim=160), None),
    # GQA 32 on 8 as 4 on 1, 128 wide; 16 experts top 2, every layer
    "phi3.5-moe-42b-a6.6b": (512, dict(n_heads=4, n_kv_heads=1,
                                       head_dim=128),
                             dict(n_experts=16, top_k=2, d_expert=64)),
    # MHA, 128 wide, qkv bias
    "qwen1.5-32b": (512, dict(n_heads=4, n_kv_heads=4, head_dim=128), None),
}


def _narrow(get_config, arch):
    """``arch``'s reduced config with its published head width and kv
    ratio (and expert count and top k), ``d_model`` as wide as the query
    heads, its one layer stacked twice."""
    d_model, heads, experts = NARROW[arch]
    cfg = get_config(arch + "-reduced")
    (stage,) = cfg.stages
    (layer,) = stage.block
    mlp = layer.mlp
    if experts is not None:
        mlp = dataclasses.replace(mlp, moe=dataclasses.replace(mlp.moe,
                                                               **experts))
    layer = dataclasses.replace(
        layer, attn=dataclasses.replace(layer.attn, **heads), mlp=mlp)
    return dataclasses.replace(cfg, d_model=d_model, stages=(
        dataclasses.replace(stage, block=(layer,), repeat=2),))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(port, jax_out, **tol):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(jax_out, np.float32), **tol)


def _check_serve(jcfg, pcfg, small_rc, rng):
    """Teacher-forced prefill of 40 tokens and 6 decode steps: logits and
    every cache leaf within 1e-4."""
    b, s, n_dec = 2, 40, 6
    model = jtf.Model(jcfg, small_rc)
    jparams = model.init(jax.random.key(0))
    jcaches = model.init_cache(b, s + n_dec)
    params = params_from_jax(_np_tree(jparams), CPU)
    caches = caches_from_jax(_np_tree(jcaches), CPU)
    toks = rng.integers(0, jcfg.vocab_size, (b, s + n_dec), dtype=np.int32)
    jl, jcaches = jax.jit(model.prefill)(jparams, jnp.asarray(toks[:, :s]),
                                         jcaches, None)
    pl, caches = ptf.prefill(pcfg, params, torch.from_numpy(toks[:, :s])
                             .long(), caches, PORT_RC)
    _close(pl, jl, **TOL)
    jdecode = jax.jit(model.decode_step)
    for step in range(n_dec):
        t = toks[:, s + step:s + step + 1]
        jl, jcaches = jdecode(jparams, jnp.asarray(t),
                              jnp.asarray(s + step, jnp.int32), jcaches)
        pl, caches = ptf.decode_step(pcfg, params, torch.from_numpy(t).long(),
                                     s + step, caches, PORT_RC)
        _close(pl, jl, **TOL)
    jflat, pflat = jax_flatten(jcaches), pckpt._flatten(caches)
    assert sorted(jflat) == sorted(pflat)
    for name in jflat:
        np.testing.assert_allclose(pflat[name], jflat[name], **TOL,
                                   err_msg=name)


def _check_train(jcfg, pcfg, small_rc, rng):
    """The loss of one batch (S = 100 in 64-token loss chunks, a few
    labels masked), its parts and every gradient leaf against
    ``jax.value_and_grad``."""
    toks = rng.integers(0, jcfg.vocab_size, (2, 101), dtype=np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    batch["labels"][0, :5] = -1
    jparams = jtf.init_params(jcfg, jax.random.key(1), small_rc)
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
    got = pckpt._flatten(tree_unflatten(params, grads))
    exp = jax_flatten(jg)
    assert sorted(got) == sorted(exp)
    for name, e in exp.items():
        assert got[name].shape == e.shape, name
        np.testing.assert_allclose(got[name], e, rtol=0,
                                   atol=REL * np.abs(e).max(), err_msg=name)


@pytest.mark.parametrize("arch", sorted(NARROW))
def test_published_heads_and_experts_match_jax(arch, small_rc):
    """Serving (prefill, decode, caches) and one train step's loss and
    gradients of the narrowed arch, port against JAX: stablelm's 160-wide
    heads on a GQA group of 4 through layernorm; phi3.5-moe's router over
    16 experts, top 2, in every layer; qwen1.5's MHA with qkv biases."""
    jcfg, pcfg = _narrow(jax_get_config, arch), _narrow(port_get_config,
                                                        arch)
    spec = pcfg.stages[0].block[0]
    assert spec.attn.head_dim == NARROW[arch][1]["head_dim"]
    assert port_get_config(arch).stages[0].block[0].attn.head_dim \
        == spec.attn.head_dim  # the published width
    rng = np.random.default_rng(sorted(NARROW).index(arch))
    _check_serve(jcfg, pcfg, small_rc, rng)
    _check_train(jcfg, pcfg, small_rc, rng)


# -- plain attention at D = 160 ----------------------------------------------


def _qkv160(seed, b=2, h=4, hk=1, s=96, d=160):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in (
        (b, h, s, d), (b, hk, s, d), (b, hk, s, d), (b, h, s, d))]


@pytest.mark.parametrize("window", [None, 40])
def test_flash_attention_d160_matches_jax(window):
    """The port's attention at stablelm's head width (plain on the CPU)
    against the JAX package's ``flash_attention_ref``, GQA 4 on 1."""
    q, k, v, _ = _qkv160(seed=160 + (window or 0))
    out = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              window=window)
    exp = jref.flash_attention_ref(
        jnp.asarray(q), *(jnp.asarray(np.repeat(a, 4, axis=1))
                          for a in (k, v)), window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("window", [None, 40])
def test_flash_attention_d160_grads_match_jax_vjp(window):
    """The gradients of ``ops.flash_attention`` at D = 160 through autograd
    against ``jax.vjp`` of ``flash_attention_ref`` (k and v expanded to the
    query heads, their gradients summed back over each group), within
    1e-5 of each gradient's largest element."""
    q, k, v, dout = _qkv160(seed=320 + (window or 0))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = torch.autograd.grad(ops.flash_attention(tq, tk, tv, window=window),
                              (tq, tk, tv), torch.from_numpy(dout))
    _, vjp = jax.vjp(lambda a, b_, c: jref.flash_attention_ref(
        a, b_, c, window=window), jnp.asarray(q),
        *(jnp.asarray(np.repeat(a, 4, axis=1)) for a in (k, v)))
    jq, jk, jv = (np.asarray(a) for a in vjp(jnp.asarray(dout)))
    exp = [jq, jk.reshape(2, 1, 4, 96, 160).sum(2),
           jv.reshape(2, 1, 4, 96, 160).sum(2)]
    for g, e in zip(got, exp):
        assert g.shape == e.shape
        np.testing.assert_allclose(g.numpy(), e, rtol=0,
                                   atol=REL * np.abs(e).max())


def test_kernel_widths_at_d160():
    """The widths the card's kernels compute D = Dv = 160 at, and so the
    padded work of chip_smoke's bounds: the bf16 forward's own 192-wide
    shared-memory tile (32 zero-filled columns), both products 160 wide
    (ten 16-deep k-steps; P V 128 + 32); the f32 forward D 160 deep and Dv
    in chunks 64 + 64 + 32; the backward runs S and dP 160 deep, dV^T and
    dK^T 192 rows, dQ 160 wide."""
    assert flash.head_tile(160, 160) == 192
    assert flash.product_widths(160, 160, torch.bfloat16) == (160, 160)
    assert flash.product_widths(160, 160, torch.float32) == (160, 160)
    assert flash.bwd_product_widths(160, 160) == (160, 160, 192, 160, 192)
    assert flash.padded_flops(1000, 160, 160, dtype=torch.float32) == 1000
    assert flash.padded_flops(800, 160, 160, backward=True) == 864


# -- what chip_smoke.py runs on the card ---------------------------------------


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _on_card():
    """Every config that chip_smoke.py serves or trains."""
    cs = _chip_smoke()
    return ([run[3] for run in cs.serve_runs(port_get_config, Stage)]
            + list(cs.train_configs(port_get_config, Stage).values()))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_runs_on_the_card_at_its_published_widths(arch):
    """Each arch of ``repro_torch.configs`` is served or trained by
    chip_smoke.py at its published widths: the same name, ``d_model``,
    vocabulary and front end, and every layer of the run one of the
    published layers (heads, kv heads, head width, MLP width, experts);
    only the depth may be cut."""
    published = port_get_config(arch)
    layers = set(published.layer_specs())
    runs = [cfg for cfg in _on_card() if cfg.name == arch]
    assert runs, f"{arch} runs on no card phase"
    for cfg in runs:
        assert dataclasses.replace(cfg, stages=published.stages) == published
        assert set(cfg.layer_specs()) <= layers

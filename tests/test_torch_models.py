"""The port's model (repro_torch.models: dense, hybrid Mamba/attention and
MoE stacks) against the JAX package.

Inputs are made from a seed with numpy and handed to both packages; the
JAX parameters and caches are carried into the port with
``repro_torch.weights``. Everything runs in float32 on the CPU.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import _flatten as jax_flatten
from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro_torch.ckpt.checkpoint import _flatten as port_flatten
from repro_torch.configs import get_config as port_get_config
from repro_torch.models import attention as pattn
from repro_torch.models import layers as players
from repro_torch.models import transformer as ptf
from repro_torch.weights import caches_from_jax, params_from_jax

TOL = dict(atol=1e-5, rtol=1e-5)
CPU = torch.device("cpu")
PORT_RC = ptf.RunConfig(param_dtype=torch.float32, cache_dtype=torch.float32)


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(port, jax_out, **tol):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(jax_out, np.float32),
                               **(tol or TOL))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# -- layers -------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm(kind):
    rng = np.random.default_rng(0)
    x, scale, bias = _rand(rng, (2, 5, 32)), _rand(rng, (32,)), \
        _rand(rng, (32,))
    p = {"scale": scale} if kind == "rmsnorm" else {"scale": scale,
                                                    "bias": bias}
    got = players.apply_norm(kind, {k: torch.from_numpy(v)
                                    for k, v in p.items()},
                             torch.from_numpy(x), 1e-5)
    exp = jlayers.apply_norm(kind, {k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), 1e-5)
    _close(got, exp)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope(theta):
    rng = np.random.default_rng(1)
    x = _rand(rng, (2, 40, 3, 16))
    pos = np.arange(40)[None, :] + 7
    got = players.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             theta)
    exp = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    _close(got, exp)


@pytest.mark.parametrize("act", ["geglu", "swiglu", "gelu"])
def test_apply_mlp(act):
    rng = np.random.default_rng(2)
    x = _rand(rng, (2, 6, 32))
    p = {"w_up": _rand(rng, (32, 64), 0.2), "w_down": _rand(rng, (64, 32),
                                                            0.2)}
    if act != "gelu":
        p["w_gate"] = _rand(rng, (32, 64), 0.2)
    got = players.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), act)
    exp = jlayers.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x), act)
    _close(got, exp)


def test_softcap():
    x = _rand(np.random.default_rng(3), (4, 50), 40.0)
    _close(players.softcap(torch.from_numpy(x), 30.0),
           jlayers.softcap(jnp.asarray(x), 30.0))


def test_expand_kv():
    k = _rand(np.random.default_rng(4), (2, 5, 2, 8))
    got = pattn._expand_kv(torch.from_numpy(k), 6)
    exp = jattn._expand_kv(jnp.asarray(k), 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))


# -- GQA layer ----------------------------------------------------------------


def _gqa_setup(window):
    from repro.configs.base import AttnSpec as JSpec
    from repro_torch.configs.base import AttnSpec as PSpec
    kw = dict(n_heads=4, n_kv_heads=2, head_dim=16, window=window,
              rope_theta=10_000.0)
    rng = np.random.default_rng(5)
    d = 32
    p = {"wq": _rand(rng, (d, 64), 0.2), "wk": _rand(rng, (d, 32), 0.2),
         "wv": _rand(rng, (d, 32), 0.2), "wo": _rand(rng, (64, d), 0.2)}
    return JSpec(**kw), PSpec(**kw), p, rng


@pytest.mark.parametrize("window", [None, 16])
def test_gqa_forward_and_decode(window):
    jspec, pspec, p, rng = _gqa_setup(window)
    b, s, max_len = 2, 40, 44
    x = _rand(rng, (b, s, 32))
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    pp = {k: torch.from_numpy(v) for k, v in p.items()}
    jc = {n: jnp.zeros((b, max_len, 2, 16), jnp.float32) for n in "kv"}
    pc = {n: torch.zeros((b, max_len, 2, 16)) for n in "kv"}
    jout, jc = jattn.gqa_forward(jp, jnp.asarray(x), jspec,
                                 positions=jnp.arange(s), impl="chunked",
                                 chunk_q=16, chunk_kv=16, cache=jc)
    pout, pc = pattn.gqa_forward(pp, torch.from_numpy(x), pspec,
                                 positions=torch.arange(s), cache=pc)
    _close(pout, jout)
    for n in "kv":
        _close(pc[n], jc[n])
    for step in range(3):
        xt = _rand(rng, (b, 1, 32))
        jout, jc = jattn.gqa_decode(jp, jnp.asarray(xt), jspec,
                                    pos=jnp.asarray(s + step, jnp.int32),
                                    cache=jc)
        pout, pc = pattn.gqa_decode(pp, torch.from_numpy(xt), pspec,
                                    pos=s + step, cache=pc)
        _close(pout, jout)
        for n in "kv":
            _close(pc[n], jc[n])


# -- the whole model ----------------------------------------------------------


def _configs(repeat0, arch="gemma3-1b-reduced"):
    def fix(cfg):
        if repeat0 == 1:
            return cfg
        st = list(cfg.stages)
        st[0] = dataclasses.replace(st[0], repeat=repeat0)
        return dataclasses.replace(cfg, stages=tuple(st))
    return fix(jax_get_config(arch)), fix(port_get_config(arch))


@pytest.mark.parametrize("repeat0", [1, 2])
def test_prefill_and_decode_match_jax(repeat0, small_rc):
    _check_prefill_and_decode(*_configs(repeat0), small_rc,
                              np.random.default_rng(repeat0))


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b-reduced",
                                  "deepseek-moe-16b-reduced"])
def test_hybrid_and_moe_prefill_and_decode_match_jax(arch, small_rc):
    """Jamba's superblock (Mamba + attention, dense + MoE) and a MoE stack
    with shared experts; decode runs 2-token MoE groups, capacity 2."""
    _check_prefill_and_decode(*_configs(1, arch), small_rc,
                              np.random.default_rng(7))


def _check_prefill_and_decode(jcfg, pcfg, small_rc, rng):
    b, s, n_dec = 2, 40, 6
    max_len = s + n_dec
    model = jtf.Model(jcfg, small_rc)
    jparams = model.init(jax.random.key(0))
    jcaches = model.init_cache(b, max_len)
    params = params_from_jax(_np_tree(jparams), CPU)
    caches = caches_from_jax(_np_tree(jcaches), CPU)
    toks = rng.integers(0, jcfg.vocab_size, (b, s + n_dec), dtype=np.int32)
    tol = dict(atol=1e-4, rtol=1e-4)

    jprefill, jdecode = jax.jit(model.prefill), jax.jit(model.decode_step)
    jl, jcaches = jprefill(jparams, jnp.asarray(toks[:, :s]), jcaches)
    pl, caches = ptf.prefill(pcfg, params, torch.from_numpy(toks[:, :s])
                             .long(), caches)
    _close(pl, jl, **tol)
    for step in range(n_dec):  # teacher-forced
        t = toks[:, s + step:s + step + 1]
        jl, jcaches = jdecode(jparams, jnp.asarray(t),
                              jnp.asarray(s + step, jnp.int32), jcaches)
        pl, caches = ptf.decode_step(pcfg, params,
                                     torch.from_numpy(t).long(), s + step,
                                     caches)
        _close(pl, jl, **tol)
    jflat, pflat = jax_flatten(jcaches), port_flatten(caches)
    assert sorted(jflat) == sorted(pflat)
    for name in jflat:
        np.testing.assert_allclose(pflat[name], jflat[name], **tol)


def test_padded_vocab_rows_are_masked():
    rng = np.random.default_rng(6)
    pcfg = dataclasses.replace(port_get_config("gemma3-1b-reduced"),
                               vocab_size=500)
    x = torch.from_numpy(_rand(rng, (2, 1, 64)))
    params = {"embed": torch.from_numpy(_rand(rng, (512, 64)))}
    logits = ptf._logits(pcfg, params, x)
    assert torch.all(logits[..., 500:] == -1e30)
    assert torch.isfinite(logits).all()


def _shapes(flat):
    return {k: tuple(v.shape) for k, v in flat.items()}


def test_init_params_leaves_match_jax_reduced(small_rc):
    jcfg, pcfg = _configs(2)
    jflat = jax_flatten(jtf.init_params(jcfg, jax.random.key(0), small_rc))
    gen = torch.Generator().manual_seed(0)
    pparams = ptf.init_params(pcfg, gen, PORT_RC, device=CPU)
    pflat = port_flatten(pparams)
    assert _shapes(pflat) == _shapes(jflat)
    assert all(v.dtype == np.float32 for v in pflat.values())


def _meta_shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_meta_shapes(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_meta_shapes(v, f"{prefix}/{i}"))
        return out
    return {prefix: tuple(tree.shape)}


def test_init_params_leaves_match_jax_full():
    jcfg, pcfg = jax_get_config("gemma3-1b"), port_get_config("gemma3-1b")
    jshapes = jax.eval_shape(lambda k: jtf.init_params(jcfg, k),
                             jax.random.key(0))
    pshapes = _meta_shapes(ptf.init_params(pcfg, torch.Generator(),
                                           device="meta"))
    assert pshapes == _meta_shapes(jshapes)
    assert sum(math.prod(s) for s in pshapes.values()) == 999_812_736


def test_init_leaves_match_jax_full_jamba():
    """Full Jamba-1.5-Large on the meta device: every parameter and cache
    leaf has the JAX package's name and shape (cache dtypes too)."""
    jcfg = jax_get_config("jamba-1.5-large-398b")
    pcfg = port_get_config("jamba-1.5-large-398b")
    jshapes = jax.eval_shape(lambda k: jtf.init_params(jcfg, k),
                             jax.random.key(0))
    pshapes = _meta_shapes(ptf.init_params(pcfg, torch.Generator(),
                                           device="meta"))
    assert pshapes == _meta_shapes(jshapes)
    assert sum(math.prod(s) for s in pshapes.values()) == 398_555_111_424
    jcache = jax.eval_shape(lambda: jtf.init_cache(jcfg, 4, 64))
    pcache = ptf.init_cache(pcfg, 4, 64, device="meta")
    assert _meta_shapes(pcache) == _meta_shapes(jcache)
    assert sorted({str(t.dtype) for t in jax.tree.leaves(jcache)}) == \
        ["bfloat16", "float32"]
    for jleaf, pleaf in zip(jax.tree.leaves(jcache),
                            jax.tree.leaves(pcache)):
        assert str(pleaf.dtype) == f"torch.{jleaf.dtype}"


@pytest.mark.parametrize("arch", ["rwkv6-1.6b-reduced",
                                  "musicgen-large-reduced",
                                  "minicpm3-4b-reduced"])
def test_unported_mixers_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ptf.Model(port_get_config(arch), PORT_RC, device=CPU)

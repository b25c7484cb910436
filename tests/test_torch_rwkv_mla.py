"""The port's RWKV6 time and channel mixes and its MLA attention against
the JAX package, function by function, and both archs' leaves at full
size on the ``meta`` device.

Inputs come from a seed with numpy; the JAX parameters are carried into
the port with ``repro_torch.weights.params_from_jax``. Everything runs on
the CPU, in float32 unless a test says otherwise; the port's MLA prefill
reaches the plain version of ``ops.flash_attention`` with Dv != D.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import AttnSpec as JAttn
from repro.configs.base import MLASpec as JMLA
from repro.configs.base import RWKVSpec as JRWKV
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro_torch.configs import get_config as port_get_config
from repro_torch.configs.base import AttnSpec as PAttn
from repro_torch.configs.base import MLASpec as PMLA
from repro_torch.configs.base import RWKVSpec as PRWKV
from repro_torch.models import attention as pattn
from repro_torch.models import layers as players
from repro_torch.models import ssm as pssm
from repro_torch.models import transformer as ptf
from repro_torch.weights import params_from_jax

TOL = dict(atol=1e-5, rtol=1e-5)
CPU = torch.device("cpu")
D_MODEL = 32
RWKV_KW = dict(head_dim=8, decay_lora=8, mix_lora=4, d_ffn=64)
H = D_MODEL // RWKV_KW["head_dim"]
MLA_KW = dict(n_heads=4, n_kv_heads=4, head_dim=16, rope_theta=10_000.0)
MLA_DIMS = dict(q_lora_rank=24, kv_lora_rank=16, qk_nope_dim=8,
                qk_rope_dim=8, v_head_dim=8)


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(port, jax_out, **tol):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(jax_out, np.float32),
                               **(tol or TOL))


def _both(arr):
    """One numpy array as (a JAX array, a torch tensor)."""
    return jnp.asarray(arr), torch.from_numpy(np.array(arr))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# -- RWKV6 --------------------------------------------------------------------


def _rwkv_params(seed=0, mix="time"):
    """JAX's init, with ``w0`` drawn from U(-5, 3.5) so that the decays
    spread from ~1 to the -20 clip. Returns (jax params, port params)."""
    key = jax.random.key(seed)
    spec = JRWKV(**RWKV_KW)
    if mix == "channel":
        p = _np_tree(jssm.init_rwkv_channel(key, D_MODEL, spec, jnp.float32))
    else:
        p = _np_tree(jssm.init_rwkv(key, D_MODEL, spec, jnp.float32))
        p["w0"] = np.random.default_rng(seed).uniform(
            -5.0, 3.5, D_MODEL).astype(np.float32)
    return {k: jnp.asarray(v) for k, v in p.items()}, params_from_jax(p, CPU)


def _rwkv_cache(rng, b):
    """A cache with non-zero shifts and state: prefill must start from the
    state and ignore the shifts."""
    return {"shift_tm": _rand(rng, (b, D_MODEL)),
            "shift_cm": _rand(rng, (b, D_MODEL)),
            "wkv": _rand(rng, (b, H, 8, 8), 0.5)}


@pytest.mark.parametrize("s", [1, 5])
@pytest.mark.parametrize("with_prev", [False, True])
def test_token_shift(s, with_prev):
    rng = np.random.default_rng(s)
    jx, px = _both(_rand(rng, (2, s, D_MODEL)))
    jp, pp = _both(_rand(rng, (2, D_MODEL))) if with_prev else (None, None)
    got = pssm._token_shift(px, pp)
    assert got.shape == (2, s, D_MODEL)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jssm._token_shift(jx, jp)))


def test_ddlerp():
    rng = np.random.default_rng(1)
    jp, pp = _rwkv_params(1)
    jx, px = _both(_rand(rng, (2, 9, D_MODEL)))
    jxx, pxx = _both(_rand(rng, (2, 9, D_MODEL)))
    for got, exp in zip(pssm._ddlerp(pp, px, pxx),
                        jssm._ddlerp(jp, jx, jxx), strict=True):
        _close(got, exp)


def test_rwkv_proj():
    rng = np.random.default_rng(2)
    jp, pp = _rwkv_params(2)
    arrs = [_both(_rand(rng, (2, 9, D_MODEL))) for _ in range(5)]
    got = pssm._rwkv_proj(pp, [a[1] for a in arrs], H, 8)
    exp = jssm._rwkv_proj(jp, [a[0] for a in arrs], H, 8)
    for g, e in zip(got, exp, strict=True):
        _close(g, e)
    assert got[4].min() >= -20.0 and got[4].max() <= -1e-5
    assert got[4].min() == -20.0  # the clip is reached


@pytest.mark.parametrize("n", [1, 7, 16])
def test_rwkv_chunk(n):
    rng = np.random.default_rng(n)
    r, k, v = (_both(_rand(rng, (2, n, H, 8))) for _ in range(3))
    logw = _both(-np.exp(rng.uniform(-4, 3, (2, n, H, 8))).clip(
        1e-5, 20).astype(np.float32))
    u = _both(_rand(rng, (H, 8), 0.5))
    s0 = _both(_rand(rng, (2, H, 8, 8)))
    y, st = pssm._rwkv_chunk(*(a[1] for a in (r, k, v, logw, u, s0)))
    jy, jst = jssm._rwkv_chunk(*(a[0] for a in (r, k, v, logw, u, s0)))
    assert y.dtype == st.dtype == torch.float32
    _close(y, jy)
    _close(st, jst)


@pytest.mark.parametrize("s,mode", [(40, "train"), (40, "prefill"),
                                    (32, "prefill"), (1, "prefill"),
                                    (1, "decode")])
def test_rwkv_time_mix(s, mode):
    """Chunks of 16: S = 40 pads its last chunk, S = 1 is a one-token
    prefill (its shift is the zero row alone). Prefill starts from the
    cached state and ignores the cached shift; decode reads both."""
    rng = np.random.default_rng(s)
    jp, pp = _rwkv_params(3)
    jx, px = _both(_rand(rng, (2, s, D_MODEL), 0.5))
    cache = None if mode == "train" else _rwkv_cache(rng, 2)
    jc = None if cache is None else {k: jnp.asarray(v)
                                     for k, v in cache.items()}
    pc = None if cache is None else params_from_jax(cache, CPU)
    spec_j, spec_p = JRWKV(**RWKV_KW), PRWKV(**RWKV_KW)
    jout, jnew = jssm.rwkv_time_mix(jp, jx, spec_j, chunk=16, cache=jc,
                                    mode=mode)
    pout, pnew = pssm.rwkv_time_mix(pp, px, spec_p, chunk=16, cache=pc,
                                    mode=mode)
    _close(pout, jout)
    if cache is None:
        assert pnew is None and jnew is None
        return
    for name in ("shift_tm", "wkv"):
        _close(pc[name], jnew[name])
    assert pc["wkv"].dtype == torch.float32
    # the channel mix's shift is not the time mix's to touch
    np.testing.assert_array_equal(pc["shift_cm"].numpy(), cache["shift_cm"])


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_rwkv_channel_mix(mode):
    rng = np.random.default_rng(4)
    jp, pp = _rwkv_params(4, mix="channel")
    s = 1 if mode == "decode" else 23
    jx, px = _both(_rand(rng, (2, s, D_MODEL), 0.5))
    cache = _rwkv_cache(rng, 2)
    pc = params_from_jax(cache, CPU)
    jout, jnew = jssm.rwkv_channel_mix(
        jp, jx, cache={k: jnp.asarray(v) for k, v in cache.items()},
        mode=mode)
    pout, _ = pssm.rwkv_channel_mix(pp, px, cache=pc, mode=mode)
    _close(pout, jout)
    _close(pc["shift_cm"], jnew["shift_cm"])


def test_rwkv_prefill_ignores_the_cached_shift():
    """Only decode reads the cached shifts: a prefill from a cache with
    non-zero shifts equals one from zero shifts, as in the reference."""
    rng = np.random.default_rng(5)
    _, pp = _rwkv_params(5)
    x = torch.from_numpy(_rand(rng, (2, 7, D_MODEL)))
    cache = _rwkv_cache(rng, 2)
    outs = []
    for shift in (cache["shift_tm"], np.zeros_like(cache["shift_tm"])):
        c = params_from_jax(dict(cache, shift_tm=shift), CPU)
        outs.append(pssm.rwkv_time_mix(pp, x, PRWKV(**RWKV_KW), chunk=4,
                                       cache=c, mode="prefill")[0])
    assert torch.equal(outs[0], outs[1])


def test_rwkv_decode_matches_forward():
    """Twin of ``test_models_units.py::test_rwkv_decode_matches_forward``:
    a prefill of S tokens, then a decode of token S, equals the train-mode
    forward over S + 1 tokens at position S."""
    rng = np.random.default_rng(0)
    spec = PRWKV(head_dim=8, decay_lora=8, mix_lora=4, d_ffn=32)
    d_model, s = 16, 16
    params = params_from_jax(_np_tree(jssm.init_rwkv(
        jax.random.key(4), d_model, JRWKV(**spec.__dict__), jnp.float32)),
        CPU)
    x = torch.from_numpy(_rand(rng, (2, s + 1, d_model), 0.3))
    full, _ = pssm.rwkv_time_mix(params, x, spec, chunk=4, mode="train")
    cache = {"shift_tm": torch.zeros((2, d_model)),
             "wkv": torch.zeros((2, 2, 8, 8)),
             "shift_cm": torch.zeros((2, d_model))}
    pssm.rwkv_time_mix(params, x[:, :s], spec, chunk=4, cache=cache,
                       mode="prefill")
    step, _ = pssm.rwkv_time_mix(params, x[:, s:s + 1], spec, cache=cache,
                                 mode="decode")
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, s].numpy(),
                               atol=1e-3, rtol=1e-3)


def test_rwkv_bf16_prefill_matches_eager_jax():
    """rwkv6-1.6b-reduced's prefill in bf16 against the JAX model run op
    by op (``jax.disable_jit``, so that every bf16 op rounds as the port's
    does; XLA's fusions under ``jit`` move roundings): the last-position
    logits within 1e-2 (the measured gap is 0.0)."""
    arch = "rwkv6-1.6b-reduced"
    jcfg, pcfg = jax_get_config(arch), port_get_config(arch)
    jrc = jtf.RunConfig(rwkv_chunk=16)  # bf16 params and caches
    prc = ptf.RunConfig(rwkv_chunk=16)
    model = jtf.Model(jcfg, jrc)
    jparams = model.init(jax.random.key(0))
    toks = np.random.default_rng(8).integers(0, jcfg.vocab_size, (2, 20),
                                             dtype=np.int32)
    with jax.disable_jit():
        jl, jcaches = model.prefill(jparams, jnp.asarray(toks),
                                    model.init_cache(2, 24))
    params = params_from_jax(_np_tree(jparams), CPU)
    assert params["stages"][0]["L0"]["mixer"]["w0"].dtype == torch.float32
    assert params["stages"][0]["L0"]["mixer"]["wr"].dtype == torch.bfloat16
    caches = ptf.init_cache(pcfg, 2, 24, prc, device=CPU)
    pl, caches = ptf.prefill(pcfg, params, torch.from_numpy(toks).long(),
                             caches, prc)
    assert pl.dtype == torch.bfloat16
    layer = caches[0]["L0"]  # the activation dtype's shifts, an f32 state
    assert layer["shift_tm"].dtype == layer["shift_cm"].dtype == \
        torch.bfloat16 and layer["wkv"].dtype == torch.float32
    _close(pl, jl, atol=1e-2, rtol=0)
    _close(caches[0]["L0"]["wkv"], jcaches[0]["L0"]["wkv"], atol=1e-2,
           rtol=0)


# -- MLA ----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_normalize(dtype):
    x = _rand(np.random.default_rng(6), (2, 5, 24), 3.0)
    jx = jnp.asarray(x).astype(dtype)
    px = torch.from_numpy(x).to(getattr(torch, dtype))
    got = players.rms_normalize(px)
    assert got.dtype == px.dtype
    _close(got, jlayers.rms_normalize(jx).astype(jnp.float32),
           **({} if dtype == "float32" else dict(atol=0, rtol=0)))


def _mla_setup(seed=0):
    """Returns (jax spec, port spec, jax params, port params)."""
    jspec = JAttn(**MLA_KW, mla=JMLA(**MLA_DIMS))
    pspec = PAttn(**MLA_KW, mla=PMLA(**MLA_DIMS))
    p = _np_tree(jattn.init_attn(jax.random.key(seed), D_MODEL, jspec,
                                 jnp.float32))
    # unit norm weights would hide a misplaced product: draw them too
    rng = np.random.default_rng(seed)
    for name in ("q_a_norm", "kv_a_norm"):
        p[name] = (1.0 + _rand(rng, p[name].shape, 0.3))
    p = {k: v * (1.0 if "norm" in k else 5.0) for k, v in p.items()}
    return jspec, pspec, {k: jnp.asarray(v) for k, v in p.items()}, \
        params_from_jax(p, CPU)


def test_mla_projections():
    """``_mla_q`` ([nope | rope] a head), ``_mla_kv_compress`` ([c_kv |
    k_rope], the rope key roped with halves) and ``_mla_expand`` ([k_nope
    | v] a head)."""
    jspec, pspec, jp, pp = _mla_setup(1)
    jx, px = _both(_rand(np.random.default_rng(1), (2, 9, D_MODEL)))
    pos = np.arange(9)[None, :] + 3
    for got, exp in zip(pattn._mla_q(pp, px, pspec),
                        jattn._mla_q(jp, jx, jspec), strict=True):
        assert got.shape == (2, 9, 4, 8)
        _close(got, exp)
    c_kv, k_rope = pattn._mla_kv_compress(pp, px, pspec,
                                          torch.from_numpy(pos))
    jc_kv, jk_rope = jattn._mla_kv_compress(jp, jx, jspec, jnp.asarray(pos))
    assert c_kv.shape == (2, 9, 16) and k_rope.shape == (2, 9, 1, 8)
    _close(c_kv, jc_kv)
    _close(k_rope, jk_rope)
    for got, exp in zip(pattn._mla_expand(pp, c_kv, pspec),
                        jattn._mla_expand(jp, jc_kv, jspec), strict=True):
        assert got.shape == (2, 9, 4, 8)
        _close(got, exp)


def _mla_prefill(jspec, pspec, jp, pp, x, max_len):
    b, s, _ = x.shape
    jc = {"c_kv": jnp.zeros((b, max_len, 16)),
          "k_rope": jnp.zeros((b, max_len, 8))}
    pc = {"c_kv": torch.zeros((b, max_len, 16)),
          "k_rope": torch.zeros((b, max_len, 8))}
    jout, jc = jattn.mla_forward(jp, jnp.asarray(x), jspec,
                                 positions=jnp.arange(s), impl="chunked",
                                 chunk_q=16, chunk_kv=16, cache=jc)
    pout, pc = pattn.mla_forward(pp, torch.from_numpy(x), pspec,
                                 positions=torch.arange(s), cache=pc)
    return jout, jc, pout, pc


def test_mla_forward_writes_the_compressed_cache(monkeypatch):
    """Prefill through ``ops.flash_attention``'s plain version with D = 16
    (nope + rope) and Dv = 8, the scale 1/sqrt(16); the cache holds the
    latent and the rope key at [0, S) and zeros after."""
    from repro_torch.kernels import ref
    shapes = []
    real = ref.flash_attention_ref
    monkeypatch.setattr(ref, "flash_attention_ref", lambda q, k, v, **kw: (
        shapes.append((q.shape, k.shape, v.shape, kw["scale"]))
        or real(q, k, v, **kw)))
    jspec, pspec, jp, pp = _mla_setup(2)
    x = _rand(np.random.default_rng(2), (2, 40, D_MODEL))
    jout, jc, pout, pc = _mla_prefill(jspec, pspec, jp, pp, x, 44)
    assert shapes == [((2, 4, 40, 16), (2, 4, 40, 16), (2, 4, 40, 8),
                       0.25)]
    _close(pout, jout)
    for name in ("c_kv", "k_rope"):
        _close(pc[name], jc[name])
        assert not pc[name][:, 40:].any()


def test_mla_forward_without_cache():
    jspec, pspec, jp, pp = _mla_setup(3)
    x = _rand(np.random.default_rng(3), (2, 23, D_MODEL))
    jout, jc = jattn.mla_forward(jp, jnp.asarray(x), jspec,
                                 positions=jnp.arange(23), impl="naive",
                                 chunk_q=8, chunk_kv=8)
    pout, pc = pattn.mla_forward(pp, torch.from_numpy(x), pspec,
                                 positions=torch.arange(23))
    assert pc is None and jc is None
    _close(pout, jout)


@pytest.mark.parametrize("absorb", [True, False])
def test_mla_decode(absorb):
    """Three decode steps after a prefill, absorbed (scores in the latent
    space) or expanded, against JAX's same path."""
    jspec, pspec, jp, pp = _mla_setup(4)
    rng = np.random.default_rng(4)
    s = 20
    _, jc, _, pc = _mla_prefill(jspec, pspec, jp, pp,
                                _rand(rng, (2, s, D_MODEL)), s + 3)
    for step in range(3):
        xt = _rand(rng, (2, 1, D_MODEL))
        jout, jc = jattn.mla_decode(jp, jnp.asarray(xt), jspec,
                                    pos=jnp.asarray(s + step, jnp.int32),
                                    cache=jc, absorb=absorb)
        pout, pc = pattn.mla_decode(pp, torch.from_numpy(xt), pspec,
                                    pos=s + step, cache=pc, absorb=absorb)
        _close(pout, jout)
        for name in ("c_kv", "k_rope"):
            _close(pc[name], jc[name])


def test_mla_absorb_equals_expand():
    """Twin of ``test_models_units.py::test_mla_absorb_equals_expand``."""
    _, pspec, _, _ = _mla_setup()
    params = params_from_jax(_np_tree(jattn.init_attn(
        jax.random.key(1), D_MODEL, JAttn(**MLA_KW, mla=JMLA(**MLA_DIMS)),
        jnp.float32)), CPU)
    rng = np.random.default_rng(0)
    s = 16
    cache = {"c_kv": torch.zeros((2, s + 4, 16)),
             "k_rope": torch.zeros((2, s + 4, 8))}
    pattn.mla_forward(params, torch.from_numpy(_rand(rng, (2, s, D_MODEL))),
                      pspec, positions=torch.arange(s), cache=cache)
    xt = torch.from_numpy(_rand(rng, (2, 1, D_MODEL)))
    o1, _ = pattn.mla_decode(params, xt, pspec, pos=s,
                             cache={k: v.clone() for k, v in cache.items()},
                             absorb=True)
    o2, _ = pattn.mla_decode(params, xt, pspec, pos=s, cache=cache,
                             absorb=False)
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), atol=1e-4, rtol=1e-4)


def test_model_decode_absorb_equals_expand():
    """minicpm3-4b-reduced decoded through ``RunConfig.mla_absorb`` True
    and False from one prefill: the same logits."""
    pcfg = port_get_config("minicpm3-4b-reduced")
    out = []
    for absorb in (True, False):
        rc = ptf.RunConfig(param_dtype=torch.float32,
                           cache_dtype=torch.float32, mla_absorb=absorb)
        model = ptf.Model(pcfg, rc, device=CPU)
        params = model.init(0)
        caches = model.init_cache(2, 24)
        toks = torch.from_numpy(np.random.default_rng(9).integers(
            0, pcfg.vocab_size, (2, 21))).long()
        model.prefill(params, toks[:, :20], caches)
        out.append(model.decode_step(params, toks[:, 20:], 20, caches)[0])
    np.testing.assert_allclose(out[0].numpy(), out[1].numpy(), atol=1e-4,
                               rtol=1e-4)


# -- both archs at full size, on the meta device -----------------------------


def _meta_shapes(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _meta_shapes(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _meta_shapes(sub, f"{prefix}/{i}").items()}
    return {prefix: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


@pytest.mark.parametrize("arch,billions", [("rwkv6-1.6b", 1.6),
                                           ("minicpm3-4b", 4.1)])
def test_param_counts_match_published(arch, billions):
    """Twin of ``test_archs_smoke.py::test_param_counts_match_published``
    for the port's init on the meta device: every parameter and cache leaf
    has the JAX package's name, shape and dtype (bf16 weights with RWKV's
    f32 ``w0`` and ``bonus_u``; bf16 shifts, latents and rope keys beside
    the f32 wkv state), and the count is within 5 % of the published
    one."""
    jcfg, pcfg = jax_get_config(arch), port_get_config(arch)
    jshapes = jax.eval_shape(lambda k: jtf.init_params(jcfg, k),
                             jax.random.key(0))
    pshapes = _meta_shapes(ptf.init_params(pcfg, torch.Generator(),
                                           device="meta"))
    assert pshapes == _meta_shapes(jshapes)
    n = sum(math.prod(shape) for shape, _ in pshapes.values())
    assert abs(n / 1e9 - billions) / billions < 0.05, n
    jcache = jax.eval_shape(lambda: jtf.init_cache(jcfg, 4, 64))
    pcache = ptf.init_cache(pcfg, 4, 64, device="meta")
    assert _meta_shapes(pcache) == _meta_shapes(jcache)

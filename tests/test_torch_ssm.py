"""The port's selective scan and Mamba mixer against the JAX package.

Inputs and weights are made from a seed with numpy and handed to both
packages; everything runs in float32 on the CPU, where the port's
``ops.ssm_scan`` runs its plain sequential version. The JAX Mamba prefill
runs a chunked associative scan, the port one sequential scan: the sums
are taken in another order, so the tolerances are a few float32 ulps of
the outputs' scale, not zero.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MambaSpec as JSpec
from repro.kernels import ref as jref
from repro.models import ssm as jssm
from repro_torch.configs.base import MambaSpec as PSpec
from repro_torch.kernels import ops, ref
from repro_torch.models import ssm as pssm

TOL = dict(atol=1e-5, rtol=1e-5)
D_MODEL = 32
SPEC_KW = dict(d_state=4, d_conv=4, expand=2, dt_rank=8)


def _close(port, jax_out, **tol):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(jax_out, np.float32),
                               **(tol or TOL))


def _scan_inputs(b, s, d, n, seed):
    rng = np.random.default_rng(seed)
    decay = np.exp(-rng.uniform(0.0, 2.0, (b, s, d, n))).astype(np.float32)
    u = rng.standard_normal((b, s, d, n)).astype(np.float32)
    c = rng.standard_normal((b, s, n)).astype(np.float32)
    s0 = rng.standard_normal((b, d, n)).astype(np.float32)
    return decay, u, c, s0


@pytest.mark.parametrize("b,s,d,n", [(1, 16, 8, 4), (2, 37, 5, 16),
                                     (3, 64, 12, 1), (2, 100, 20, 32)])
def test_ssm_scan_ref_matches_jax(b, s, d, n):
    arrs = _scan_inputs(b, s, d, n, seed=s)
    y, fin = ops.ssm_scan(*(torch.from_numpy(a) for a in arrs))
    jy, jfin = jref.ssm_scan_ref(*(jnp.asarray(a) for a in arrs))
    assert y.shape == (b, s, d) and fin.shape == (b, d, n)
    assert y.dtype == fin.dtype == torch.float32
    _close(y, jy)
    _close(fin, jfin)


def test_ssm_scan_carries_state0():
    """A scan split anywhere and carried on through ``state0`` equals the
    whole scan: ``state0`` is the state before the first position."""
    decay, u, c, s0 = (torch.from_numpy(a)
                       for a in _scan_inputs(2, 50, 6, 8, seed=1))
    y, fin = ref.ssm_scan_ref(decay, u, c, s0)
    y1, mid = ref.ssm_scan_ref(decay[:, :17], u[:, :17], c[:, :17], s0)
    y2, fin2 = ref.ssm_scan_ref(decay[:, 17:], u[:, 17:], c[:, 17:], mid)
    assert torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(fin2, fin)


@pytest.mark.parametrize("shapes", [
    ((2, 8, 4, 4), (2, 8, 4, 4), (2, 8, 3), (2, 4, 4)),  # c's N
    ((2, 8, 4, 4), (2, 8, 4, 4), (2, 8, 4), (2, 5, 4)),  # state0's D
    ((2, 8, 4, 4), (2, 9, 4, 4), (2, 8, 4), (2, 4, 4)),  # u's S
    ((2, 8, 4), (2, 8, 4), (2, 8, 4), (2, 4, 4)),  # not 4-D
])
def test_ssm_scan_contract(shapes):
    with pytest.raises(ValueError):
        ops.ssm_scan(*(torch.zeros(sh) for sh in shapes))


# -- the Mamba mixer ---------------------------------------------------------


def _mamba_params(seed):
    """Random weights of the JAX layout, with dt_bias and A_log spread so
    that the decays are far from 0 and 1."""
    spec = PSpec(**SPEC_KW)
    di, r, n = spec.d_inner(D_MODEL), spec.resolved_dt_rank(D_MODEL), 4
    rng = np.random.default_rng(seed)

    def rand(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {
        "in_proj": rand((D_MODEL, 2 * di), 0.2),
        "conv_w": rand((4, di), 0.3),
        "conv_b": rand((di,), 0.1),
        "x_proj": rand((di, r + 2 * n), 0.2),
        "dt_proj": rand((r, di), 0.3),
        "dt_bias": rand((di,), 0.5) - 1.0,
        "A_log": np.log(np.arange(1, n + 1, dtype=np.float32))[None, :]
        + rand((di, n), 0.2),
        "D": rand((di,), 1.0),
        "out_proj": rand((di, D_MODEL), 0.2),
    }


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def _zero_caches(b, di):
    return ({"conv": jnp.zeros((b, 3, di), jnp.float32),
             "ssm": jnp.zeros((b, di, 4), jnp.float32)},
            {"conv": torch.zeros((b, 3, di)), "ssm": torch.zeros((b, di, 4))})


@pytest.mark.parametrize("s", [40, 23, 64, 5])
def test_mamba_forward_matches_jax(s):
    """The JAX package scans in chunks of 16 (padding a ragged last one),
    the port once over the whole sequence."""
    jp, pp = _both(_mamba_params(0))
    di = 2 * D_MODEL
    x = np.random.default_rng(s).standard_normal((2, s, D_MODEL)).astype(
        np.float32)
    jc, pc = _zero_caches(2, di)
    jout, jc = jssm.mamba_forward(jp, jnp.asarray(x), JSpec(**SPEC_KW),
                                  D_MODEL, chunk=16, cache=jc)
    pout, pc = pssm.mamba_forward(pp, torch.from_numpy(x), PSpec(**SPEC_KW),
                                  D_MODEL, cache=pc)
    _close(pout, jout, atol=2e-5, rtol=2e-5)
    _close(pc["conv"], jc["conv"])
    _close(pc["ssm"], jc["ssm"], atol=2e-5, rtol=2e-5)


def test_mamba_forward_without_cache():
    jp, pp = _both(_mamba_params(1))
    x = np.random.default_rng(2).standard_normal((1, 20, D_MODEL)).astype(
        np.float32)
    jout, jc = jssm.mamba_forward(jp, jnp.asarray(x), JSpec(**SPEC_KW),
                                  D_MODEL, chunk=8)
    pout, pc = pssm.mamba_forward(pp, torch.from_numpy(x), PSpec(**SPEC_KW),
                                  D_MODEL)
    assert jc is None and pc is None
    _close(pout, jout, atol=2e-5, rtol=2e-5)


def test_mamba_decode_matches_jax():
    jp, pp = _both(_mamba_params(3))
    rng = np.random.default_rng(4)
    di = 2 * D_MODEL
    jc = {"conv": jnp.asarray(rng.standard_normal((2, 3, di)), jnp.float32),
          "ssm": jnp.asarray(rng.standard_normal((2, di, 4)), jnp.float32)}
    pc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
    for _ in range(3):
        x = rng.standard_normal((2, 1, D_MODEL)).astype(np.float32)
        jout, jc = jssm.mamba_decode(jp, jnp.asarray(x), JSpec(**SPEC_KW),
                                     D_MODEL, cache=jc)
        pout, pc = pssm.mamba_decode(pp, torch.from_numpy(x),
                                     PSpec(**SPEC_KW), D_MODEL, cache=pc)
        _close(pout, jout)
        _close(pc["conv"], jc["conv"])
        _close(pc["ssm"], jc["ssm"])


def test_mamba_decode_after_prefill_matches_jax():
    """Prefill 30 positions, then decode 5 more, teacher-forced; and the
    port's decode continues its own prefill exactly as a longer prefill
    would end."""
    jp, pp = _both(_mamba_params(5))
    di = 2 * D_MODEL
    x = np.random.default_rng(6).standard_normal((2, 35, D_MODEL)).astype(
        np.float32)
    jc, pc = _zero_caches(2, di)
    _, jc = jssm.mamba_forward(jp, jnp.asarray(x[:, :30]), JSpec(**SPEC_KW),
                               D_MODEL, chunk=16, cache=jc)
    _, pc = pssm.mamba_forward(pp, torch.from_numpy(x[:, :30]),
                               PSpec(**SPEC_KW), D_MODEL, cache=pc)
    outs = []
    for t in range(30, 35):
        jout, jc = jssm.mamba_decode(jp, jnp.asarray(x[:, t:t + 1]),
                                     JSpec(**SPEC_KW), D_MODEL, cache=jc)
        pout, pc = pssm.mamba_decode(pp, torch.from_numpy(x[:, t:t + 1]),
                                     PSpec(**SPEC_KW), D_MODEL, cache=pc)
        _close(pout, jout, atol=2e-5, rtol=2e-5)
        outs.append(pout)
    _close(pc["ssm"], jc["ssm"], atol=2e-5, rtol=2e-5)
    full, _ = pssm.mamba_forward(pp, torch.from_numpy(x), PSpec(**SPEC_KW),
                                 D_MODEL)
    torch.testing.assert_close(torch.cat(outs, 1), full[:, 30:], **TOL)


def test_causal_depthwise_conv_matches_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 19, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal((12,)).astype(np.float32)
    got = pssm._causal_depthwise_conv(*(torch.from_numpy(a)
                                        for a in (x, w, b)))
    exp = jssm._causal_depthwise_conv(*(jnp.asarray(a) for a in (x, w, b)))
    _close(got, exp)


def test_init_mamba_full_matches_jax_leaves():
    import jax
    spec = JSpec(**SPEC_KW)
    jp = jssm.init_mamba_full(jax.random.key(0), D_MODEL, spec, jnp.float32)
    pp = pssm.init_mamba_full(torch.Generator().manual_seed(0), D_MODEL,
                              PSpec(**SPEC_KW), torch.bfloat16, "cpu",
                              lead=(3,))
    assert {k: (3,) + tuple(v.shape) for k, v in jp.items()} == \
        {k: tuple(v.shape) for k, v in pp.items()}
    # A_log and D stay f32 whatever the param dtype; A_log, D, dt_bias and
    # conv_b are the JAX package's constants
    assert pp["A_log"].dtype == pp["D"].dtype == torch.float32
    assert pp["in_proj"].dtype == torch.bfloat16
    for name in ("A_log", "D", "conv_b"):
        _close(pp[name][1], jp[name])
    _close(pp["dt_bias"][2], jp["dt_bias"], atol=1e-2, rtol=1e-2)

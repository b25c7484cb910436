"""The port's selective scan, its gradient and the Mamba mixer against
the JAX package.

Inputs and weights are made from a seed with numpy and handed to both
packages; everything runs in float32 on the CPU, where the port's
``ops.ssm_scan`` runs its plain sequential version and, under autograd,
its plain backward (``ssm_scan_bwd_ref``). The JAX Mamba prefill runs a
chunked associative scan, the port one sequential scan: the sums are taken
in another order, so the tolerances are a few float32 ulps of the outputs'
scale, not zero. The JAX package has no scan backward of its own: its
gradients here are ``jax.vjp``'s and ``jax.grad``'s.
"""
import jax
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


def _scan_grad_inputs(b, s, d, n, seed):
    """_scan_inputs with a few exact-zero decays (exp(dt*A) underflows to 0
    in f32 where dt*A < -104), and the output cotangents."""
    decay, u, c, s0 = _scan_inputs(b, s, d, n, seed)
    rng = np.random.default_rng(seed + 1)
    decay[rng.random(decay.shape) < 0.05] = 0.0
    dy = rng.standard_normal((b, s, d)).astype(np.float32)
    dfinal = rng.standard_normal((b, d, n)).astype(np.float32)
    return decay, u, c, s0, dy, dfinal


def _assert_grads_close(got, exp, rel=1e-5):
    """Each gradient within ``rel`` of its largest element."""
    for g, e in zip(got, exp):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        e = np.asarray(e, np.float32)
        assert g.shape == e.shape
        np.testing.assert_allclose(g, e, rtol=0, atol=rel * np.abs(e).max())


_GRAD_SHAPES = pytest.mark.parametrize("b,s,d,n", [
    (1, 16, 8, 4), (2, 37, 5, 16), (2, 70, 19, 4), (1, 33, 3, 16)])


@_GRAD_SHAPES
@pytest.mark.parametrize("with_dfinal", [False, True])
def test_ssm_scan_bwd_ref_matches_jax_vjp(b, s, d, n, with_dfinal):
    """The plain backward against ``jax.vjp`` of the JAX package's
    ``ssm_scan_ref``, with the final state's cotangent zero (training) or
    not, ragged S and D, and exact-zero decays."""
    decay, u, c, s0, dy, dfinal = _scan_grad_inputs(b, s, d, n, seed=s + n)
    if not with_dfinal:
        dfinal = np.zeros_like(dfinal)
    _, vjp = jax.vjp(jref.ssm_scan_ref,
                     *(jnp.asarray(a) for a in (decay, u, c, s0)))
    exp = vjp((jnp.asarray(dy), jnp.asarray(dfinal)))
    got = ref.ssm_scan_bwd_ref(
        *(torch.from_numpy(a) for a in (decay, u, c, s0, dy)),
        torch.from_numpy(dfinal) if with_dfinal else None)
    assert all(g.dtype == torch.float32 for g in got)
    _assert_grads_close(got, exp)


@_GRAD_SHAPES
def test_ssm_scan_autograd_matches_plain_autograd(b, s, d, n):
    """``ops.ssm_scan`` under autograd (its backward is ``ssm_scan_bwd_ref``
    on the CPU) gives the gradients that autograd takes through
    ``ssm_scan_ref``, from y alone (training: the final state's gradient
    is absent), from the final state alone, or from both."""
    arrs = _scan_grad_inputs(b, s, d, n, seed=s)
    ins = [torch.from_numpy(a).requires_grad_() for a in arrs[:4]]
    dy, dfinal = (torch.from_numpy(a) for a in arrs[4:])
    for used in ((0,), (1,), (0, 1)):
        outs, ref_outs = ops.ssm_scan(*ins), ref.ssm_scan_ref(*ins)
        assert outs[0].grad_fn is not None
        cots = [(dy, dfinal)[i] for i in used]
        got = torch.autograd.grad([outs[i] for i in used], ins, cots)
        # the final state alone does not depend on c: a zero gradient
        exp = torch.autograd.grad([ref_outs[i] for i in used], ins, cots,
                                  materialize_grads=True)
        _assert_grads_close(got, exp)


def _emulated_ssm_bwd(decay, u, c, s0, dy, chunk=32, d_per_block=None):
    """ssm_scan_bwd.cu's schedule in plain PyTorch: the forward's boundary
    states every ``chunk`` steps (s_{k*chunk-1}, s_{-1} = state0), then
    chunks from last to first, each recomputed forward from its boundary
    state and walked in reverse with the adjoint g carried across chunks;
    d_c as per-block partials over ``d_per_block`` d's (256 / N, the
    kernel's block), added in block order. A ragged last chunk."""
    b, s, d, n = decay.shape
    d_per_block = d_per_block or 256 // n
    n_blocks = -(-d // d_per_block)
    bounds, st = [], s0
    for t in range(s):  # the forward kernel: the state entering each chunk
        if t % chunk == 0:
            bounds.append(st)
        st = decay[:, t] * st + u[:, t]
    d_decay, d_u = torch.empty_like(decay), torch.empty_like(u)
    parts = torch.zeros(b, s, n_blocks, n)
    g = torch.zeros_like(s0)
    for k in reversed(range(len(bounds))):
        t0, t1 = k * chunk, min(k * chunk + chunk, s)
        states = [bounds[k]]
        for t in range(t0, t1):
            states.append(decay[:, t] * states[-1] + u[:, t])
        for j in reversed(range(t1 - t0)):
            t = t0 + j
            g = g + dy[:, t, :, None] * c[:, t, None, :]
            d_u[:, t] = g
            d_decay[:, t] = g * states[j]
            p = dy[:, t, :, None] * states[j + 1]  # (b, d, n)
            for blk in range(n_blocks):
                sl = slice(blk * d_per_block, (blk + 1) * d_per_block)
                parts[:, t, blk] = p[:, sl].sum(dim=1)
            g = decay[:, t] * g
    d_c = parts[:, :, 0]
    for blk in range(1, n_blocks):
        d_c = d_c + parts[:, :, blk]
    return d_decay, d_u, d_c, g


@pytest.mark.parametrize("b,s,d,n,d_per_block", [
    (2, 70, 19, 4, 8),  # three chunks, the last ragged; a ragged block
    (1, 64, 40, 16, 16),  # whole chunks; Jamba's N and block of 16 d's
    (2, 5, 9, 2, 4)])  # one short chunk
def test_chunked_schedule_matches_plain(b, s, d, n, d_per_block):
    """The backward kernel's arithmetic, emulated on the CPU, against the
    plain reverse scan: states recomputed from boundary states are the
    forward's (exact-zero decays included), and the per-block d_c partials
    add up to the plain sum."""
    decay, u, c, s0, dy, _ = (torch.from_numpy(a) for a in
                              _scan_grad_inputs(b, s, d, n, seed=3 * s))
    got = _emulated_ssm_bwd(decay, u, c, s0, dy, d_per_block=d_per_block)
    exp = ref.ssm_scan_bwd_ref(decay, u, c, s0, dy)
    _assert_grads_close(got, exp)
    # the adjoint and d_u/d_decay never divide by a decay
    assert (decay == 0).any() and all(torch.isfinite(t).all() for t in got)


def test_ssm_scan_without_grad_saves_nothing():
    """Serving (no gradient) runs the forward alone: no autograd node."""
    ins = [torch.from_numpy(a).requires_grad_() for a in
           _scan_inputs(1, 8, 4, 4, seed=0)]
    with torch.no_grad():
        y, fin = ops.ssm_scan(*ins)
    assert y.grad_fn is None and fin.grad_fn is None
    y, fin = ops.ssm_scan(*ins)
    assert y.grad_fn is not None and y.grad_fn is fin.grad_fn


def test_mamba_exponentiates_in_place(monkeypatch):
    """``mamba_forward`` turns decay_log into the decay in place, serving
    and training alike (no second (B, S, di, ds) f32 tensor): the decay the
    scan gets was written once after it was made. Under autograd that
    in-place exp gives the gradients of an out-of-place one, bit for
    bit."""
    pp = {k: torch.from_numpy(v) for k, v in _mamba_params(8).items()}
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 20, D_MODEL)).astype(np.float32))
    seen = []
    real = ops.ssm_scan
    monkeypatch.setattr(ops, "ssm_scan",
                        lambda decay, *a: seen.append(decay._version)
                        or real(decay, *a))
    with torch.no_grad():
        pssm.mamba_forward(pp, x, PSpec(**SPEC_KW), D_MODEL)
    for v in pp.values():
        v.requires_grad_(True)
    leaves = list(pp.values())
    out, _ = pssm.mamba_forward(pp, x, PSpec(**SPEC_KW), D_MODEL)
    in_place = torch.autograd.grad(out.sum(), leaves)
    assert seen == [1, 1]
    monkeypatch.setattr(torch.Tensor, "exp_", torch.Tensor.exp)
    out, _ = pssm.mamba_forward(pp, x, PSpec(**SPEC_KW), D_MODEL)
    out_of_place = torch.autograd.grad(out.sum(), leaves)
    assert seen[-1] == 0
    assert all(torch.equal(a, b) for a, b in zip(in_place, out_of_place))


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


@pytest.mark.parametrize("s", [40, 23])
def test_mamba_forward_grads_match_jax(s):
    """The Mamba layer's gradients (every weight and the input) against
    ``jax.grad`` of the JAX package's ``mamba_forward`` (a chunked
    associative scan, chunks of 16) on the same weights and cotangent: the
    port's run through the scan's backward."""
    p = _mamba_params(10)
    jp, pp = _both(p)
    rng = np.random.default_rng(s + 1)
    x = rng.standard_normal((2, s, D_MODEL)).astype(np.float32)
    dout = rng.standard_normal((2, s, D_MODEL)).astype(np.float32)

    def jloss(params, xx):
        out, _ = jssm.mamba_forward(params, xx, JSpec(**SPEC_KW), D_MODEL,
                                    chunk=16)
        return jnp.sum(out * dout)
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    names = sorted(pp)
    for k in names:
        pp[k].requires_grad_(True)
    out, _ = pssm.mamba_forward(pp, xt, PSpec(**SPEC_KW), D_MODEL)
    got = torch.autograd.grad(out, [pp[k] for k in names] + [xt],
                              torch.from_numpy(dout))
    _assert_grads_close(got, [jg[k] for k in names] + [jgx])


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


def test_jamba_bf16_prefill_and_decode_match_eager_jax():
    """jamba-1.5-large-398b-reduced (Mamba, attention, MoE) in bf16, as the
    card serves Jamba: a prefill of 20 tokens and 4 decode steps against
    the JAX model run op by op (``jax.disable_jit``, so that every bf16 op
    rounds as the port's does). Each step's logits within 2^-8, one bf16
    ulp at the logits' scale (< 1); the measured gap is 4.8e-07. The last
    layer's SSM state (f32) within 1e-3."""
    from repro.configs import get_config as jax_get_config
    from repro.models import transformer as jtf
    from repro_torch.configs import get_config as port_get_config
    from repro_torch.models import transformer as ptf
    from repro_torch.weights import params_from_jax

    arch = "jamba-1.5-large-398b-reduced"
    jcfg, pcfg = jax_get_config(arch), port_get_config(arch)
    model, prc = jtf.Model(jcfg, jtf.RunConfig()), ptf.RunConfig()
    jparams = model.init(jax.random.key(0))
    toks = np.random.default_rng(9).integers(0, jcfg.vocab_size, (2, 24),
                                             dtype=np.int32)
    with jax.disable_jit():
        jl, jcaches = model.prefill(jparams, jnp.asarray(toks[:, :20]),
                                    model.init_cache(2, 24))
        want = [jl]
        for i in range(20, 24):
            jl, jcaches = model.decode_step(
                jparams, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i),
                jcaches)
            want.append(jl)
    params = params_from_jax(jax.tree.map(np.asarray, jparams),
                             torch.device("cpu"))
    caches = ptf.init_cache(pcfg, 2, 24, prc, device="cpu")
    pl, caches = ptf.prefill(pcfg, params, torch.from_numpy(toks[:, :20])
                             .long(), caches, prc)
    got = [pl]
    for i in range(20, 24):
        pl, caches = ptf.decode_step(pcfg, params, torch.from_numpy(
            toks[:, i:i + 1]).long(), i, caches, prc)
        got.append(pl)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        _close(g, w, atol=2.0 ** -8, rtol=0)
    last = f"L{len(pcfg.stages[0].block) - 1}"
    _close(caches[0][last]["ssm"], jcaches[0][last]["ssm"], atol=1e-3,
           rtol=0)

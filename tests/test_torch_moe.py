"""The port's MoE (capacity dispatch, grouped routing) against the JAX
package.

Inputs and weights are made from a seed with numpy and handed to both
packages, in float32 on the CPU. Routing is compared exactly (the same
experts, slots and dropped assignments); the outputs to float32 rounding
of the expert products (1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoESpec as JSpec
from repro.models import moe as jmoe
from repro_torch.configs.base import MoESpec as PSpec
from repro_torch.models import moe as pmoe

TOL = dict(atol=1e-5, rtol=1e-5)
D = 16


def _params(spec_kw, act, seed, skew):
    """Random weights; ``skew`` > 0 makes expert 0 everyone's first choice
    (with inputs that share a positive mean), so that it overflows."""
    rng = np.random.default_rng(seed)
    e, f = spec_kw["n_experts"], spec_kw["d_expert"]

    def rand(shape, scale=0.3):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    p = {"router": rand((D, e)), "w_gate": rand((e, D, f)),
         "w_up": rand((e, D, f)), "w_down": rand((e, f, D))}
    p["router"][:, 0] += skew
    if spec_kw.get("n_shared"):
        n = spec_kw["n_shared"] * f
        p["shared"] = {"w_gate": rand((D, n)), "w_up": rand((D, n)),
                       "w_down": rand((n, D))}
    return p


def _tree(p, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in p.items()}


def _run(spec_kw, act, b, s, n_groups, seed, skew=0.0, factor=1.25):
    p = _params(spec_kw, act, seed, skew)
    rng = np.random.default_rng(seed + 100)
    x = (rng.standard_normal((b, s, D)) + (1.0 if skew else 0.0)).astype(
        np.float32)
    jy, jaux = jmoe.apply_moe(_tree(p, jnp.asarray), jnp.asarray(x),
                              JSpec(**spec_kw), act, n_groups=n_groups,
                              capacity_factor=factor)
    py, paux = pmoe.apply_moe(_tree(p, torch.from_numpy),
                              torch.from_numpy(x), PSpec(**spec_kw), act,
                              n_groups=n_groups, capacity_factor=factor)
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(paux.item(), float(jaux), **TOL)

    # routing: the same slots, so the same dropped assignments
    sg = b * s // n_groups
    cap = jmoe._capacity(sg, JSpec(**spec_kw), factor)
    xg = x.reshape(n_groups, sg, D)
    logits = xg @ p["router"]
    _, jslot, jgates, _ = jax.vmap(lambda xx, ll: jmoe._route_group(
        xx, ll, JSpec(**spec_kw), cap))(jnp.asarray(xg), jnp.asarray(logits))
    pslot, pgates, _ = pmoe._route(torch.from_numpy(logits),
                                   PSpec(**spec_kw), cap)
    np.testing.assert_array_equal(pslot.numpy(), np.asarray(jslot))
    np.testing.assert_allclose(pgates.numpy(), np.asarray(jgates), **TOL)
    return int((pslot == spec_kw["n_experts"] * cap).sum())


JAMBA_LIKE = dict(n_experts=16, top_k=2, d_expert=24)


@pytest.mark.parametrize("spec_kw,act", [
    (JAMBA_LIKE, "swiglu"),
    (dict(n_experts=4, top_k=2, d_expert=32), "swiglu"),
    (dict(n_experts=8, top_k=3, d_expert=8, n_shared=1), "geglu"),
])
def test_apply_moe_prefill_matches_jax(spec_kw, act):
    b, s = 2, 24
    _run(spec_kw, act, b, s, pmoe.default_groups(b, s, "prefill"), seed=0)


@pytest.mark.parametrize("spec_kw", [
    JAMBA_LIKE, dict(n_experts=4, top_k=2, d_expert=32)])
def test_apply_moe_prefill_drops_like_jax(spec_kw):
    """Expert 0 is every token's first choice and overflows its capacity:
    the port drops the same assignments."""
    assert _run(spec_kw, "swiglu", 2, 24, 2, seed=1, skew=0.5) > 0


@pytest.mark.parametrize("b", [4, 32])
def test_apply_moe_decode_groups_match_jax(b):
    """Decode groups: max(1, B//16) groups of B tokens (capacity 1 at
    B=4 with 16 experts), so decode drops tokens by design."""
    n_groups = pmoe.default_groups(b, 1, "decode")
    assert n_groups == max(1, b // 16)
    dropped = _run(JAMBA_LIKE, "swiglu", b, 1, n_groups, seed=2 + b)
    assert dropped > 0


def test_route_breaks_ties_like_lax_top_k():
    """Equal probabilities: the lower expert index comes first."""
    logits = torch.zeros((1, 3, 4))
    logits[0, 1, 2] = logits[0, 1, 3] = 1.0
    slot, gates, _ = pmoe._route(logits, PSpec(n_experts=4, top_k=2,
                                               d_expert=8), capacity=6)
    experts = (slot // 6).reshape(3, 2).tolist()
    assert experts == [[0, 1], [2, 3], [0, 1]]
    assert torch.allclose(gates, torch.full((1, 6), 0.5))


def test_apply_moe_is_bit_identical_across_runs():
    p = _tree(_params(JAMBA_LIKE, "swiglu", 3, 0.5), torch.from_numpy)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (4, 8, D)).astype(np.float32) + 1.0)
    y1, _ = pmoe.apply_moe(p, x, PSpec(**JAMBA_LIKE), "swiglu", n_groups=1)
    y2, _ = pmoe.apply_moe(p, x, PSpec(**JAMBA_LIKE), "swiglu", n_groups=1)
    assert torch.equal(y1, y2)


def test_apply_moe_rejects_uneven_groups():
    p = _tree(_params(JAMBA_LIKE, "swiglu", 5, 0.0), torch.from_numpy)
    with pytest.raises(ValueError):
        pmoe.apply_moe(p, torch.zeros((3, 1, D)), PSpec(**JAMBA_LIKE),
                       "swiglu", n_groups=2)


def test_init_moe_matches_jax_leaves():
    spec_kw = dict(n_experts=4, top_k=2, d_expert=8, n_shared=2)
    jp = jmoe.init_moe(jax.random.key(0), D, JSpec(**spec_kw), "swiglu",
                       jnp.float32)
    pp = pmoe.init_moe(torch.Generator().manual_seed(0), D,
                       PSpec(**spec_kw), "swiglu", torch.float32, "cpu")
    assert _tree(pp, lambda t: tuple(t.shape)) == \
        _tree(jp, lambda a: tuple(a.shape))

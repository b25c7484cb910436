"""The port's AdamW (repro_torch.optim) against the JAX package's.

The same parameters, gradients and moments, made from a seed with numpy,
go through ``repro.optim.adamw`` and its port on the CPU, in float32. The
tolerance is 1e-6 relative: the update's own arithmetic in f32, with
``b ** step`` and the square root taken by two libraries.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import _flatten as jflatten
from repro.optim import adamw as jadamw
from repro_torch.ckpt.checkpoint import _flatten as pflatten
from repro_torch.optim import adamw as padamw
from repro_torch.weights import tree_leaves, tree_map

REL = 1e-6


def _tree(rng, scale=1.0):
    """A nested dict/list tree of f32 leaves, with a 0-d leaf among them."""
    def r(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"embed": r(16, 8), "stages": [{"w": r(3, 8, 8), "b": r(8)},
                                          {"w": r(8, 4)}],
            "scalar": r()}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _assert_trees_close(port, ref):
    """Leaf by leaf, paired by name (``_flatten`` of each package)."""
    got, exp = pflatten(port), jflatten(ref)
    assert sorted(got) == sorted(exp)
    for name, e in exp.items():
        g = got[name]
        assert g.shape == e.shape and g.dtype == e.dtype, name
        np.testing.assert_allclose(g, e, rtol=REL, atol=REL * np.abs(e).max(),
                                   err_msg=name)


def test_adamw_init_matches_jax():
    params = _tree(np.random.default_rng(1))
    jst = jadamw.adamw_init(_jax(params))
    pst = padamw.adamw_init(_torch(params))
    assert pst["step"].dtype == torch.int32 and pst["step"].shape == ()
    assert np.asarray(jst["step"]).dtype == np.int32
    for part in ("m", "v"):
        for leaf in tree_leaves(pst[part]):
            assert leaf.dtype == torch.float32 and not leaf.any()
        _assert_trees_close(pst[part], jst[part])


@pytest.mark.parametrize("step", [0, 3, 4, 10])
@pytest.mark.parametrize("warmup", [1, 5])
def test_schedule_matches_jax(step, warmup):
    cfg = dict(lr=1e-3, warmup_steps=warmup)
    exp = jadamw._schedule(jadamw.AdamWConfig(**cfg),
                           jnp.asarray(step, jnp.int32))
    got = padamw._schedule(padamw.AdamWConfig(**cfg),
                           torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=REL)


@pytest.mark.parametrize("scale,max_norm", [(0.01, 1.0), (10.0, 1.0)])
def test_clip_by_global_norm_matches_jax(scale, max_norm):
    grads = _tree(np.random.default_rng(2), scale)
    jg, jn = jadamw.clip_by_global_norm(_jax(grads), max_norm)
    pg, pn = padamw.clip_by_global_norm(_torch(grads), max_norm)
    np.testing.assert_allclose(pn.numpy(), np.asarray(jn), rtol=REL)
    _assert_trees_close(pg, jg)


# clip inactive (small grads) and active (large); a first step from zero
# moments and a later one from nonzero moments
@pytest.mark.parametrize("grad_scale", [0.01, 10.0])
@pytest.mark.parametrize("start_step", [0, 6])
def test_adamw_update_matches_jax(grad_scale, start_step):
    rng = np.random.default_rng(int(grad_scale * 100) + start_step)
    params, grads = _tree(rng), _tree(rng, grad_scale)
    m, v = _tree(rng, 0.1), tree_map(np.abs, _tree(rng, 0.01))
    if start_step == 0:
        m = tree_map(np.zeros_like, m)
        v = tree_map(np.zeros_like, v)
    kw = dict(lr=1e-3, warmup_steps=5)
    jst = {"m": _jax(m), "v": _jax(v),
           "step": jnp.asarray(start_step, jnp.int32)}
    pst = {"m": _torch(m), "v": _torch(v),
           "step": torch.tensor(start_step, dtype=torch.int32)}
    jp, jst, jn = jadamw.adamw_update(jadamw.AdamWConfig(**kw),
                                      _jax(grads), jst, _jax(params))
    p_in, m_in = _torch(params), pst["m"]
    pp, pst, pn = padamw.adamw_update(padamw.AdamWConfig(**kw),
                                      _torch(grads), pst, p_in)
    # written in place, as the JAX train step's donated buffers
    assert pp is p_in and pst["m"] is m_in
    assert pst["step"].dtype == torch.int32
    assert int(pst["step"]) == int(jst["step"]) == start_step + 1
    np.testing.assert_allclose(pn.numpy(), np.asarray(jn), rtol=REL)
    _assert_trees_close(pp, jp)
    _assert_trees_close(pst["m"], jst["m"])
    _assert_trees_close(pst["v"], jst["v"])

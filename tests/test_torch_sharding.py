"""The port's sharding surface (``repro_torch.launch.sharding`` and
``mesh``, ``head_pad``) against the JAX package's on the same inputs.

The rules are compared spec for spec with ``repro.launch.sharding`` on
every arch; each leaf's local shard, as a DTensor on a ``fake`` process
group of 256 or 512 ranks (meta shards, no device), against
``NamedSharding(AbstractMesh(...), P(*spec)).shard_shape``, which needs
no devices either. ``head_pad`` is held to ``init_attn``'s padding in
JAX: the real heads bit-equal to the unpadded model's, the outputs of the
padded model within float32 rounding (1e-5, as the JAX package's own
test), and whole reduced models padded on both sides within 1e-4 (the
tolerance of the unpadded whole-model parity). Every test that starts a
process group destroys it.
"""
import dataclasses
from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding
from torch.distributed.tensor import Shard, distribute_tensor
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jax_get_config
from repro.configs.base import AttnSpec as JAttnSpec
from repro.configs.base import MLASpec as JMLASpec
from repro.launch import sharding as jsh
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro_torch.configs import ARCH_IDS, SHAPES
from repro_torch.configs import get_config as port_get_config
from repro_torch.configs.base import AttnSpec as PAttnSpec
from repro_torch.configs.base import MLASpec as PMLASpec
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import sharding as psh
from repro_torch.models import attention as pattn
from repro_torch.models import transformer as ptf
from repro_torch.optim.adamw import adamw_init
from repro_torch.weights import caches_from_jax, params_from_jax

CPU = torch.device("cpu")
META = torch.device("meta")
AXIS_SIZES = {"pod": 2, "data": 16, "model": 16}
MESHES = {"pod1": ((16, 16), ("data", "model")),
          "pod2": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture
def fake_world():
    """A fake group of 512 ranks for the test, destroyed after it."""
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    yield
    dist.destroy_process_group()


def _jax_leaves(tree) -> dict:
    """{path names tuple: shape} of a JAX tree (eval_shape leaves)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(jsh._path_names(p)): tuple(leaf.shape) for p, leaf in flat}


def _port_leaves(tree) -> dict:
    out = {}
    psh.tree_map_with_path(
        lambda path, leaf: out.__setitem__(tuple(map(str, path)),
                                           leaf), tree)
    return out


def _intrinsic_ndim(cfg, names, shape) -> int:
    ndim = len(shape)
    if names and names[0] == "stages" and \
            cfg.stages[int(names[1])].repeat > 1:
        ndim -= 1
    return ndim


def _norm(spec) -> tuple:
    """A spec as ``PartitionSpec`` keeps it: a one-axis tuple entry is the
    axis name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _spec_sizes(entry) -> int:
    if entry is None:
        return 1
    axes = (entry,) if isinstance(entry, str) else entry
    return int(np.prod([AXIS_SIZES[a] for a in axes]))


# -- the rules ----------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("fsdp_axes", [None, ("data",), ("pod", "data")])
def test_param_partition_matches_jax(arch, fsdp_axes):
    """Every leaf of the port's full-size model at head_pad=16 (on meta)
    has JAX's name and shape and JAX's partition spec, and every sharded
    dim divides by its axes (JAX's test_param_divisibility)."""
    jcfg, pcfg = jax_get_config(arch), port_get_config(arch)
    jshapes = _jax_leaves(jax.eval_shape(
        partial(jtf.init_params, jcfg, rc=jtf.RunConfig(head_pad=16)),
        jax.random.key(0)))
    pleaves = _port_leaves(ptf.init_params(
        pcfg, torch.Generator(), ptf.RunConfig(head_pad=16), device=META))
    assert {k: tuple(v.shape) for k, v in pleaves.items()} == jshapes
    bad = []
    for names, leaf in pleaves.items():
        ndim = _intrinsic_ndim(pcfg, names, leaf.shape)
        spec = psh._param_partition(list(names), ndim, fsdp_axes)
        assert spec == tuple(jsh._param_partition(list(names), ndim,
                                                  fsdp_axes)), names
        for size, entry in zip(leaf.shape[-len(spec):] if spec else (),
                               spec):
            if size % _spec_sizes(entry):
                bad.append(("/".join(names), tuple(leaf.shape), spec))
    assert not bad, bad[:5]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_choose_policy_matches_jax(arch):
    jcfg, pcfg = jax_get_config(arch), port_get_config(arch)
    for name in SHAPES:
        got = psh.choose_policy(pcfg, SHAPES[name], model_axis=16)
        want = jsh.choose_policy(jcfg, JSHAPES[name], None, model_axis=16)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name


class _JaxFakeMesh:
    """JAX's ``test_batch_axes_fallback`` mesh, for both packages."""

    def __init__(self, shape, axes):
        self.axis_names = axes
        self.mesh_dim_names = axes
        self.shape = dict(zip(axes, shape))


def _port_mesh(shape, axes):
    """A stand-in with DeviceMesh's attributes, for the pure rules."""
    return SimpleNamespace(mesh_dim_names=axes, shape=shape)


@pytest.mark.parametrize("mesh_kind", ["pod1", "pod2"])
@pytest.mark.parametrize("mode", ["dp_zero1", "tp_fsdp"])
def test_batch_axes_matches_jax(mesh_kind, mode):
    shape, axes = MESHES[mesh_kind]
    jm, pm = _JaxFakeMesh(shape, axes), _port_mesh(shape, axes)
    jpol, ppol = jsh.ShardingPolicy(mode=mode), psh.ShardingPolicy(mode=mode)
    for bsz in (1, 2, 8, 16, 32, 64, 128, 256, 384, 512, 1024):
        assert psh.batch_axes(pm, ppol, bsz) == \
            jsh.batch_axes(jm, jpol, bsz), bsz
        assert {k: _norm(v) for k, v in psh.batch_shardings(
            pm, True, bsz, ppol).items()} == {
            k: tuple(v.spec) for k, v in jsh.batch_shardings(
                AbstractMesh(shape, axes), True, bsz, jpol).items()}


def test_batch_axes_fallback():
    """JAX's own cases: the largest divisible combo."""
    m = _port_mesh((2, 16, 16), ("pod", "data", "model"))
    z1 = psh.ShardingPolicy(mode="dp_zero1")
    tp = psh.ShardingPolicy(mode="tp_fsdp")
    assert psh.batch_axes(m, z1, 512) == ("pod", "data", "model")
    assert psh.batch_axes(m, z1, 256) == ("data", "model")
    assert psh.batch_axes(m, tp, 256) == ("pod", "data")
    assert psh.batch_axes(m, tp, 1) is None


@pytest.mark.parametrize("mesh_kind", ["pod1", "pod2"])
@pytest.mark.parametrize("mode", ["dp_zero1", "tp_fsdp"])
@pytest.mark.parametrize("bsz", [1, 8, 256])
def test_make_shard_fn_spec_matches_jax(mesh_kind, mode, bsz, monkeypatch):
    """The spec ``make_shard_fn`` chooses for each token, shape and policy
    equals the one JAX's hands to ``with_sharding_constraint`` (patched
    here to capture it)."""
    shape, axes = MESHES[mesh_kind]
    amesh = AbstractMesh(shape, axes)
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: seen.append(tuple(s.spec)) or x)
    jshard = jsh.make_shard_fn(amesh, jsh.ShardingPolicy(mode=mode), bsz)
    pshard = psh.make_shard_fn(_port_mesh(shape, axes),
                               psh.ShardingPolicy(mode=mode), bsz)
    cases = [((bsz, 64, 512), ("data", None, None)),
             ((bsz, 64, 48, 128), ("data", None, "model", None)),
             ((bsz, 64, 40, 128), ("data", None, "model", None)),
             ((bsz, 1, 262144), ("data", None, "model")),
             ((bsz * 48, 64, 128), ("bh", None, None)),
             ((bsz, 64, 16, 10, 512), ("data", "model", None, None)),
             ((bsz, 3, 5), ("data", None, "model"))]
    for xshape, spec in cases:
        seen.clear()
        jshard(jax.ShapeDtypeStruct(xshape, jnp.float32), spec)
        x = torch.empty(xshape, device=META)
        assert _norm(pshard.spec(x, spec)) == seen[0], (xshape, spec)


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("mesh_kind", ["pod1", "pod2"])
def test_local_shards_match_jax_shard_shape(arch, mesh_kind, fake_world):
    """Every parameter, Adam moment and cache leaf of the full-size model,
    laid out as a DTensor by the port's rules on the production mesh of
    the fake group, has the local shard JAX's ``NamedSharding`` gives the
    same spec on an ``AbstractMesh``; under tp_fsdp (FSDP on, head_pad 16)
    and dp_zero1, caches at decode_32k's batch and long_500k's."""
    shape, axes = MESHES[mesh_kind]
    amesh = AbstractMesh(shape, axes)
    mesh = pmesh.make_production_mesh(multi_pod=mesh_kind == "pod2")
    jcfg, pcfg = jax_get_config(arch), port_get_config(arch)
    for mode in ("tp_fsdp", "dp_zero1"):
        ppol = psh.ShardingPolicy(mode=mode, fsdp=mode == "tp_fsdp")
        jpol = jsh.ShardingPolicy(mode=mode, fsdp=mode == "tp_fsdp")
        rc = ptf.RunConfig(head_pad=16 if mode == "tp_fsdp" else 1)
        params = ptf.init_params(pcfg, torch.Generator(), rc, device=META)
        jparams = jax.eval_shape(partial(
            jtf.init_params, jcfg, rc=jtf.RunConfig(head_pad=rc.head_pad)),
            jax.random.key(0))
        p_sh = psh.param_shardings(pcfg, params, mesh, ppol)
        jp_sh = jsh.param_shardings(jcfg, jparams, amesh, jpol)
        opt = adamw_init(params)
        trees = [(params, p_sh, jp_sh),
                 (opt, psh.opt_shardings(pcfg, opt, p_sh, mesh, ppol),
                  jsh.opt_shardings(jcfg, {"m": jparams}, jp_sh, amesh,
                                    jpol))]
        for bsz, jshape in ((128, "decode_32k"), (1, "long_500k")):
            caches = ptf.init_cache(pcfg, bsz, 64, rc, device=META)
            jcaches = jax.eval_shape(lambda: jtf.init_cache(
                jcfg, bsz, 64, jtf.RunConfig(head_pad=rc.head_pad)))
            pol = dataclasses.replace(
                ppol, shard_cache_seq=jshape == "long_500k")
            jp = dataclasses.replace(
                jpol, shard_cache_seq=jshape == "long_500k")
            trees.append((caches, psh.cache_shardings(caches, mesh, pol,
                                                      bsz),
                          jsh.cache_shardings(jcaches, amesh, jp, bsz)))
        for tree, specs, jspecs in trees:
            leaves = _port_leaves(tree)
            pspecs = _port_leaves(specs)
            jflat = {tuple(jsh._path_names(p)): s for p, s in
                     jax.tree_util.tree_flatten_with_path(
                         jspecs, is_leaf=lambda s: isinstance(
                             s, NamedSharding))[0]}
            for names, leaf in leaves.items():
                want = jflat[names].shard_shape(tuple(leaf.shape))
                assert _norm(pspecs[names]) == tuple(jflat[names].spec) \
                    or not any(pspecs[names]) and not any(jflat[names].spec)
                got = distribute_tensor(leaf, mesh, psh.placements(
                    mesh, pspecs[names], leaf.shape)).to_local().shape
                assert tuple(got) == tuple(want), (mode, names)


def test_placements_raise_where_jax_would(fake_world):
    mesh = pmesh.make_production_mesh(multi_pod=True)
    # 40 heads of 128 do not split 16 ways; JAX raises, DTensor would not
    with pytest.raises(ValueError, match="not divisible"):
        psh.placements(mesh, (None, "model"), (64, 40))
    with pytest.raises(ValueError, match="not divisible"):
        psh.placements(mesh, (("pod", "data"), None), (16, 8))
    # a DTensor splits one dim over its mesh dims in mesh order
    with pytest.raises(ValueError, match="mesh's order"):
        psh.placements(mesh, (("data", "pod"), None), (64, 8))
    assert psh.placements(mesh, (("pod", "data"), "model"), (64, 32)) == \
        (Shard(0), Shard(0), Shard(1))


def test_production_mesh_sizes(fake_world):
    m1 = pmesh.make_production_mesh()
    m2 = pmesh.make_production_mesh(multi_pod=True)
    assert pmesh.axis_sizes(m1) == {"data": 16, "model": 16}
    assert pmesh.axis_sizes(m2) == AXIS_SIZES
    assert (pmesh.mesh_chips(m1), pmesh.mesh_chips(m2)) == (256, 512)
    assert pmesh.dp_axes(m1) == ("data",)
    assert pmesh.dp_axes(m2) == ("pod", "data")


# -- head_pad -----------------------------------------------------------------


def test_padded_heads():
    for n, pad in ((3, 4), (4, 4), (40, 16), (32, 16), (1, 8), (12, 1)):
        assert pattn.padded_heads(n, pad) == jattn.padded_heads(n, pad)


@pytest.mark.parametrize("mla", [False, True])
def test_head_padding_keeps_the_real_heads(mla):
    """The padded leaves hold the unpadded draws bit for bit (the
    generator's stream does not move), zeros in the padding; their shapes
    are JAX's."""
    kw = dict(n_heads=3, n_kv_heads=3, head_dim=8)
    mla_kw = dict(q_lora_rank=12, kv_lora_rank=8, qk_nope_dim=4,
                  qk_rope_dim=4, v_head_dim=4)
    spec = PAttnSpec(**kw, mla=PMLASpec(**mla_kw) if mla else None)
    p1 = pattn.init_attn(torch.Generator().manual_seed(3), 24, spec,
                         torch.float32, CPU, head_pad=1)
    p4 = pattn.init_attn(torch.Generator().manual_seed(3), 24, spec,
                         torch.float32, CPU, head_pad=4)
    jspec = JAttnSpec(**kw, mla=JMLASpec(**mla_kw) if mla else None)
    j4 = jattn.init_attn(jax.random.key(0), 24, jspec, jnp.float32,
                         head_pad=4)
    assert {k: tuple(v.shape) for k, v in p4.items()} == \
        {k: tuple(v.shape) for k, v in j4.items()}
    for name, w in p1.items():
        w4 = p4[name]
        if w4.shape == w.shape:
            assert torch.equal(w4, w)
            continue
        rows = w4.shape[0] != w.shape[0]
        real = w4[:w.shape[0]] if rows else w4[..., :w.shape[-1]]
        pad = w4[w.shape[0]:] if rows else w4[..., w.shape[-1]:]
        assert torch.equal(real, w) and not pad.any(), name


def test_head_padding_exactness():
    """Twin of the JAX package's test: 3 heads padded to 4 compute the
    unpadded layer's output (1e-5, as there)."""
    spec = PAttnSpec(n_heads=3, n_kv_heads=3, head_dim=8)
    p1 = pattn.init_attn(torch.Generator().manual_seed(2), 24, spec,
                         torch.float32, CPU, head_pad=1)
    p4 = pattn.init_attn(torch.Generator().manual_seed(2), 24, spec,
                         torch.float32, CPU, head_pad=4)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 16, 24)).astype(np.float32))
    pos = torch.arange(16)
    o1, _ = pattn.gqa_forward(p1, x, spec, positions=pos)
    o4, _ = pattn.gqa_forward(p4, x, spec, positions=pos)
    np.testing.assert_allclose(o4.numpy(), o1.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("head_pad", [4, 8])
@pytest.mark.parametrize("arch", ["gemma3-1b-reduced", "qwen1.5-32b-reduced",
                                  "minicpm3-4b-reduced"])
def test_padded_model_matches_padded_jax(arch, head_pad, small_rc):
    """JAX's parameters at ``head_pad`` load into the port's model at the
    same ``head_pad`` unchanged (their shapes equal the port's own init),
    and prefill + 4 teacher-forced decode steps give JAX's logits and
    caches within 1e-4. The reduced archs have 4 heads, so head_pad=4 pads
    nothing and 8 pads 4 zero heads (GQA's 1 kv head stays; MHA's kv pads
    in lockstep; MLA pads q_b, kv_b and wo)."""
    jcfg, pcfg = jax_get_config(arch), port_get_config(arch)
    jrc = dataclasses.replace(small_rc, head_pad=head_pad)
    prc = ptf.RunConfig(param_dtype=torch.float32, cache_dtype=torch.float32,
                        rwkv_chunk=16, head_pad=head_pad)
    b, s, n_dec = 2, 24, 4
    model = jtf.Model(jcfg, jrc)
    jparams = model.init(jax.random.key(0))
    jcaches = model.init_cache(b, s + n_dec)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), CPU)
    caches = caches_from_jax(jax.tree.map(np.asarray, jcaches), CPU)
    own = ptf.init_params(pcfg, torch.Generator(), prc, device=META)
    assert {k: tuple(v.shape) for k, v in _port_leaves(own).items()} == \
        {k: tuple(v.shape) for k, v in _port_leaves(params).items()}
    toks = np.random.default_rng(head_pad).integers(
        0, jcfg.vocab_size, (b, s + n_dec), dtype=np.int32)
    tol = dict(atol=1e-4, rtol=1e-4)
    jl, jcaches = jax.jit(model.prefill)(jparams, jnp.asarray(toks[:, :s]),
                                         jcaches)
    pl, caches = ptf.prefill(pcfg, params, torch.from_numpy(toks[:, :s])
                             .long(), caches, prc)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **tol)
    for step in range(n_dec):
        t = toks[:, s + step:s + step + 1]
        jl, jcaches = jax.jit(model.decode_step)(
            jparams, jnp.asarray(t), jnp.asarray(s + step, jnp.int32),
            jcaches)
        pl, caches = ptf.decode_step(pcfg, params, torch.from_numpy(t)
                                     .long(), s + step, caches, prc)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **tol)
    jflat = {tuple(jsh._path_names(p)): np.asarray(leaf) for p, leaf in
             jax.tree_util.tree_flatten_with_path(jcaches)[0]}
    pflat = _port_leaves(caches)
    assert sorted(pflat) == sorted(jflat)
    for names, leaf in pflat.items():
        np.testing.assert_allclose(leaf.numpy(), jflat[names], **tol)

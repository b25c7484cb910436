"""The port's per-chip counting over a mesh (``repro_torch.roofline`` on
DTensors), its kernels' DTensor branch, and the dry run
(``repro_torch.launch.dryrun``) against the JAX package's sharding.

Meshes are built over ``fake`` process groups (meta shards: nothing is
allocated and no collective moves data) or, for values, over a gloo group
of one rank on the CPU. Every test that starts a process group destroys
it.
"""
import dataclasses
import os
import subprocess
import sys
from functools import partial

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.configs import get_config as jax_get_config
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.launch import dryrun as jdryrun
from repro.launch import sharding as jsh
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro_torch import roofline
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.kernels import flash_attention as pflash
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssm_scan as pssm
from repro_torch.launch import dryrun, mesh as pmesh
from repro_torch.launch import sharding as psh

META = torch.device("meta")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def fake_group():
    """Starts a fake group of the given size; destroys it after the
    test."""
    def start(world):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


def _fake_mesh(start, shape, names=("data", "model")):
    start(int(np.prod(shape)))
    return init_device_mesh("cuda", shape, mesh_dim_names=names)


def _meta(*shape):
    return torch.empty(shape, device=META)


# -- counting per chip --------------------------------------------------------


def test_megatron_mlp_counts_one_chip(fake_group):
    """(X @ W1) @ W2 + 1 with W1 column- and W2 row-sharded over 4 ranks:
    each chip computes a quarter of the products' FLOPs, and the add needs
    the one all-reduce of the (B, d) f32 partial sums, whose modeled wire
    bytes are 2 (n-1)/n of its operand."""
    mesh = _fake_mesh(fake_group, (1, 4))
    b, d, f = 8, 4096, 4096
    x = distribute_tensor(_meta(b, d), mesh, [Replicate(), Replicate()])
    w1 = distribute_tensor(_meta(d, f), mesh, [Replicate(), Shard(1)])
    w2 = distribute_tensor(_meta(f, d), mesh, [Replicate(), Shard(0)])
    y, cost = roofline.count(lambda: (x @ w1) @ w2 + 1.0)
    global_mm = 2 * (2 * b * d * f)
    assert cost.rows["aten.mm"][1] == global_mm / 4 == cost.flops
    assert cost.coll_counts == {"all-reduce": 1}
    assert cost.coll_operand_bytes == b * d * 4
    assert cost.coll_wire == 2 * 3 / 4 * b * d * 4
    assert cost.coll_wire_inter == 0.0  # 4 ranks in one node
    assert y.placements == (Replicate(), Replicate())
    terms = roofline.roofline_terms(cost, dtype=torch.float32)
    assert terms["collective_s"] == cost.coll_wire / roofline.NVLINK_BW


def test_a_group_across_nodes_moves_at_the_inter_node_rate(fake_group):
    """The all-reduce over 16 ranks of a (16, 16) mesh's model axis spans
    two 8-GPU nodes."""
    mesh = _fake_mesh(fake_group, (16, 16))
    x = distribute_tensor(_meta(16, 64), mesh, [Replicate(), Partial()])
    _, cost = roofline.count(lambda: x.redistribute(
        mesh, [Replicate(), Replicate()]))
    wire = 2 * 15 / 16 * 16 * 64 * 4
    assert cost.coll_wire == cost.coll_wire_inter == wire
    terms = roofline.roofline_terms(cost, dtype=torch.float32)
    assert terms["collective_s"] == wire / roofline.INTER_NODE_BW


@pytest.mark.parametrize("placement", ["batch", "heads"])
def test_flash_on_meta_dtensors_records_local_work(placement, fake_group):
    mesh = _fake_mesh(fake_group, (2, 4))
    b, h, s, d = 4, 8, 64, 32
    pl = [Shard(0), Replicate()] if placement == "batch" \
        else [Replicate(), Shard(1)]
    q, k, v = (distribute_tensor(_meta(b, h, s, d), mesh, pl)
               for _ in range(3))
    launches = dict(ops.LAUNCHES)
    with ops.record_work() as rows:
        out = ops.flash_attention(q, k, v, window=16)
    assert ops.LAUNCHES == launches  # a meta call is no launch
    lb, lh = (b // 2, h) if placement == "batch" else (b, h // 4)
    assert rows == [("flash_attention",
                     *pflash.work(lb, lh, lh, s, d, d, 16, 4, True))]
    assert isinstance(out, DTensor) and out.placements == tuple(pl)
    assert out.shape == (b, h, s, d)


def test_ssm_scan_on_meta_dtensors_records_local_work(fake_group):
    mesh = _fake_mesh(fake_group, (2, 4))
    b, s, d, n = 4, 32, 64, 8
    pl = (Shard(0), Shard(2))
    decay, u = (distribute_tensor(_meta(b, s, d, n), mesh, pl)
                for _ in range(2))
    c = distribute_tensor(_meta(b, s, n), mesh, [Shard(0), Replicate()])
    s0 = distribute_tensor(_meta(b, d, n), mesh, [Shard(0), Shard(1)])
    with ops.record_work() as rows:
        y, final = ops.ssm_scan(decay, u, c, s0)
    assert rows == [("ssm_scan", *pssm.work(b // 2, s, d // 4, n))]
    assert y.shape == (b, s, d) and y.placements == pl
    assert final.shape == (b, d, n) and final.placements == (Shard(0),
                                                             Shard(1))


def test_kernels_refuse_placements_they_cannot_compute(fake_group):
    mesh = _fake_mesh(fake_group, (2, 4))
    for pl in ([Replicate(), Shard(2)], [Replicate(), Shard(3)],
               [Replicate(), Partial()]):
        q = distribute_tensor(_meta(4, 8, 64, 32), mesh, pl) \
            if not isinstance(pl[1], Partial) else DTensor.from_local(
                _meta(4, 8, 64, 32), mesh, pl, run_check=False)
        with pytest.raises(ValueError, match="shard by shard"):
            ops.flash_attention(q, q, q)
    # heads sharded with fewer kv heads: a rank would read others' kv
    q = distribute_tensor(_meta(4, 8, 64, 32), mesh, [Replicate(), Shard(1)])
    kv = distribute_tensor(_meta(4, 4, 64, 32), mesh,
                           [Replicate(), Shard(1)])
    with pytest.raises(ValueError, match="H != Hk"):
        ops.flash_attention(q, kv, kv)
    # the scan over a sharded S
    t = distribute_tensor(_meta(4, 32, 64, 8), mesh, [Replicate(), Shard(1)])
    with pytest.raises(ValueError, match="shard by shard"):
        ops.ssm_scan(t, t, _meta(4, 32, 8), _meta(4, 64, 8))
    new = distribute_tensor(torch.empty(1 << 16, dtype=torch.uint8,
                                        device=META), mesh,
                            [Shard(0), Replicate()])
    with pytest.raises(ValueError, match="shard by shard"):
        ops.delta_mask(new, new, block=2048)


def test_one_rank_gloo_mesh_is_bit_equal_to_the_plain_version():
    """On a one-rank gloo mesh the kernels' DTensor branch gives the plain
    versions' results bit for bit (CPU values), sharded or not."""
    mesh = pmesh.make_debug_mesh(1, 1, device="cpu")
    try:
        rng = np.random.default_rng(0)
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (2, 4, 48, 16)).astype(np.float32)) for _ in range(3))
        want = ref.flash_attention_ref(q, k, v, window=20)
        for pl in ([Replicate(), Replicate()], [Shard(0), Shard(1)]):
            dq, dk, dv = (distribute_tensor(t, mesh, pl) for t in (q, k, v))
            got = ops.flash_attention(dq, dk, dv, window=20)
            assert torch.equal(got.full_tensor(), want)
        decay = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 24, 8, 4))
                                 .astype(np.float32))
        u, c, s0 = (torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)) for shape in ((2, 24, 8, 4), (2, 24, 4), (2, 8, 4)))
        y, fin = ref.ssm_scan_ref(decay, u, c, s0)
        pl = (Shard(0), Shard(2))
        dy, dfin = ops.ssm_scan(
            distribute_tensor(decay, mesh, pl), distribute_tensor(u, mesh, pl),
            distribute_tensor(c, mesh, [Shard(0), Replicate()]),
            distribute_tensor(s0, mesh, [Shard(0), Shard(1)]))
        assert torch.equal(dy.full_tensor(), y)
        assert torch.equal(dfin.full_tensor(), fin)
    finally:
        dist.destroy_process_group()


# -- meshes -------------------------------------------------------------------


@pytest.mark.parametrize("world", [256, 512])
def test_production_mesh_builds_on_fake_ranks(world, fake_group):
    fake_group(world)
    m1 = pmesh.make_production_mesh()
    assert m1.shape == (16, 16) and m1.mesh_dim_names == ("data", "model")
    if world == 512:
        m2 = pmesh.make_production_mesh(multi_pod=True)
        assert m2.shape == (2, 16, 16)
    else:
        with pytest.raises(RuntimeError, match="dryrun.py"):
            pmesh.make_production_mesh(multi_pod=True)


def test_production_mesh_raises_below_its_size(fake_group):
    fake_group(64)
    with pytest.raises(RuntimeError, match="need 256 devices"):
        pmesh.make_production_mesh()


def test_production_mesh_raises_without_a_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="have 0"):
        pmesh.make_production_mesh()


# -- the dry run --------------------------------------------------------------


def _jax_bytes(tree_of_sds, tree_of_shardings) -> int:
    """Per-device bytes of a JAX tree under its NamedShardings."""
    leaves = jax.tree.leaves(tree_of_sds)
    shs = jax.tree.leaves(tree_of_shardings,
                          is_leaf=lambda s: hasattr(s, "shard_shape"))
    return sum(int(np.prod(s.shard_shape(l.shape))) * l.dtype.itemsize
               for l, s in zip(leaves, shs))


CELLS = [("gemma3-1b-reduced", "train", "dp_zero1"),
         ("deepseek-moe-16b-reduced", "prefill", "tp_fsdp"),
         ("rwkv6-1.6b-reduced", "decode", None)]


@pytest.mark.parametrize("arch,kind,mode", CELLS)
def test_plan_cell_matches_jax_records(arch, kind, mode, fake_group):
    """plan_cell on a fake (2, 4) mesh: the JAX dry run's record keys (the
    XLA-step keys in their documented places) and argument bytes equal to
    the sum of JAX's shard shapes over the same specs (the decode position
    is a Python int here, an int32 scalar there: left out)."""
    mesh = _fake_mesh(fake_group, (2, 4))
    amesh = AbstractMesh((2, 4), ("data", "model"))
    b, s = 8, 64
    shape = ShapeSpec(f"{kind}_test", kind, s, b)
    jshape = JShapeSpec(f"{kind}_test", kind, s, b)
    pcfg, jcfg = get_config(arch), jax_get_config(arch)
    policy = psh.ShardingPolicy(mode=mode) if mode else None
    rec = dryrun.plan_cell(pcfg, shape, mesh, policy=policy)
    jkeys = {"arch", "shape", "mesh", "chips", "policy", "rc",
             "params_total", "params_active", "tokens_per_step", "lower_s",
             "compile_s", "memory", "xla_cost_analysis", "roofline"}
    assert set(rec) == (jkeys - {"lower_s", "compile_s",
                                 "xla_cost_analysis"}) | {
        "plan_s", "count_s", "counted"}
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "alias_bytes",
                                  "peak_estimate_bytes", "temp_bytes_reason"}
    assert rec["chips"] == 8 and rec["mesh"] == {"data": 2, "model": 4}
    jpol = jsh.choose_policy(jcfg, jshape, amesh, model_axis=4) \
        if mode is None else jsh.ShardingPolicy(mode=mode)
    assert rec["policy"] == dataclasses.asdict(jpol)
    jrc = jtf.RunConfig(head_pad=4 if jpol.mode == "tp_fsdp" else 1)
    assert rec["rc"]["head_pad"] == str(jrc.head_pad)
    jparams = jax.eval_shape(partial(jtf.init_params, jcfg, rc=jrc),
                             jax.random.key(0))
    p_sh = jsh.param_shardings(jcfg, jparams, amesh, jpol)
    specs = jdryrun.input_specs(jcfg, jshape)
    want = _jax_bytes(jparams, p_sh)
    if kind == "train":
        opt = jax.eval_shape(jadamw.adamw_init, jparams)
        want += _jax_bytes(opt, jsh.opt_shardings(jcfg, opt, p_sh, amesh,
                                                  jpol))
        b_sh = jsh.batch_shardings(amesh, False, b, jpol)
        want += _jax_bytes(specs["batch"], {k: b_sh[k]
                                            for k in specs["batch"]})
    else:
        caches = jax.eval_shape(lambda: jtf.init_cache(jcfg, b, s, jrc))
        want += _jax_bytes(caches, jsh.cache_shardings(caches, amesh, jpol,
                                                       b))
        want += _jax_bytes(specs["tokens"], jsh.batch_shardings(
            amesh, False, b, jpol)["tokens"])
    assert rec["memory"]["argument_bytes"] == want
    assert rec["memory"]["temp_bytes"] is None
    r = rec["roofline"]
    assert r["counted_flops_per_chip"] > 0 and r["memory_s"] > 0
    assert rec["counted"]["flops"] == r["counted_flops_per_chip"]
    if kind == "train":  # ZeRO-1: grads reduced, the update all-gathered
        assert r["coll_counts"].get("all-gather", 0) > 0
        assert r["collective_s"] > 0


def test_dryrun_cli_runs_one_cell(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "gemma3-1b-reduced", "--shape", "decode_32k", "--mesh", "pod1",
         "--out-dir", str(tmp_path)], env=env, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "OK   gemma3-1b-reduced x decode_32k x pod1" in proc.stdout
    assert "ok=1 skip=0 fail=0" in proc.stdout
    files = list(tmp_path.glob("*.json"))
    assert [f.name for f in files] == [
        "gemma3-1b-reduced_decode_32k_pod1.json"]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "gemma3-1b-reduced", "--attn-impl", "naive"], env=env,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0 and "JAX-only" in proc.stderr


def _greedy(cfg, rc, params, caches, toks, n_dec):
    """Prefill ``toks`` and decode ``n_dec`` greedy tokens: (tokens, every
    step's logits), as plain tensors."""
    from repro_torch.models import transformer as ptf

    def full(t):
        return t.full_tensor() if isinstance(t, DTensor) else t
    logits, caches = ptf.prefill(cfg, params, toks, caches, rc)
    out, steps = [], [full(logits)]
    s = toks.shape[1]
    for i in range(n_dec):
        tok = full(logits)[:, :cfg.vocab_size].argmax(-1)[:, None]
        out.append(tok)
        if isinstance(toks, DTensor):
            tok = distribute_tensor(tok, toks.device_mesh, toks.placements)
        logits, caches = ptf.decode_step(cfg, params, tok, s + i, caches, rc)
        steps.append(full(logits))
    return torch.cat(out, 1), steps


def test_one_rank_mesh_serves_and_trains_bit_equal():
    """Reduced gemma3-1b over a one-rank gloo mesh, laid out by the rules
    (``distribute_state``) and run with ``run_config_for``'s hook under
    ``implicit_replication``: greedy tokens and every step's logits, and a
    train step's loss and parameters, bit-equal to the plain run's (the
    same ops on the same local values; what ``chip_smoke.py``'s mesh phase
    holds on the card at full width)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch import train
    from repro_torch.models import transformer as ptf
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.weights import tree_leaves

    cfg = get_config("gemma3-1b-reduced")
    rc = ptf.RunConfig(param_dtype=torch.float32, cache_dtype=torch.float32,
                       loss_chunk=16)
    cpu = torch.device("cpu")
    b, s = 2, 24

    def fresh():
        return ptf.init_params(cfg, torch.Generator().manual_seed(0), rc,
                               device=cpu)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (b, s + 1)))
    plain_tok, plain_logits = _greedy(
        cfg, rc, fresh(), ptf.init_cache(cfg, b, s + 4, rc, device=cpu),
        toks[:, :s], 4)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=5)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    p_plain = fresh()
    _, _, m_plain = train.make_train_step(cfg, rc, opt_cfg)(
        p_plain, adamw_init(p_plain), batch)
    mesh = pmesh.make_debug_mesh(1, 1, device="cpu")
    try:
        shape = ShapeSpec("test", "prefill", s, b)
        policy = psh.choose_policy(cfg, shape)
        mrc = psh.run_config_for(cfg, shape, mesh, base=rc, policy=policy)
        st = psh.distribute_state(
            cfg, mesh, policy, b, params=fresh(),
            caches=ptf.init_cache(cfg, b, s + 4, rc, device=cpu),
            inputs={"tokens": toks[:, :s]})
        with implicit_replication():
            tok, logits = _greedy(cfg, mrc, st["params"], st["caches"],
                                  st["inputs"]["tokens"], 4)
        assert torch.equal(tok, plain_tok)
        assert all(torch.equal(x, y) for x, y in zip(logits, plain_logits))
        params = fresh()
        st = psh.distribute_state(cfg, mesh, policy, b, params=params,
                                  opt=adamw_init(params), inputs=batch)
        with implicit_replication():
            p_mesh, _, m_mesh = train.make_train_step(cfg, mrc, opt_cfg)(
                st["params"], st["opt"], st["inputs"])
        assert m_mesh["loss"].full_tensor().item() == \
            m_plain["loss"].item()
        for x, y in zip(tree_leaves(p_mesh), tree_leaves(p_plain)):
            assert torch.equal(x.full_tensor(), y)
    finally:
        dist.destroy_process_group()

"""Multi-pod dry run: one (arch x shape x mesh) cell's step laid out over
the production mesh and counted per chip, without a device.

Port of ``repro/launch/dryrun.py``. The JAX dry run forces 512 host
devices, lowers and compiles each cell's jitted step with the sharding
rules, and reads XLA's memory and cost analyses. This one starts a
``fake`` process group of 512 ranks (``torch.distributed``'s test
backend: collectives complete without moving data) and builds the
production mesh over it; ``plan_cell`` lays the parameters, optimizer
state, batch and caches out as DTensors whose shards live on the ``meta``
device (nothing is allocated, no device is touched: this is no CPU
fallback of a run, it runs nothing), and runs the port's own step on them
under ``implicit_replication`` inside ``repro_torch.roofline.count``,
which counts one chip's FLOPs, bytes and collectives.

A cell's record has the JAX dry run's keys, except where those name XLA
steps:
  - ``lower_s`` and ``compile_s`` give way to ``plan_s`` (building the
    DTensors) and ``count_s`` (running the step on them);
  - ``xla_cost_analysis`` gives way to ``counted`` (the counted FLOPs and
    bytes of one chip);
  - ``memory``: ``argument_bytes`` and ``output_bytes`` are the exact sums
    of one chip's shard bytes of the step's inputs and outputs (tokens
    int32, as JAX's); ``alias_bytes`` those of the outputs that are
    inputs updated in place (JAX's donated buffers); ``temp_bytes`` and
    ``peak_estimate_bytes`` are null, with ``temp_bytes_reason``: meta
    tensors have no allocator whose peak could be read.
``roofline`` is ``repro_torch.roofline.roofline_terms`` of the counted
cost, at H100 constants (its docstring), with the model FLOPs a chip.

``--capacity-factor``, ``--moe-groups`` and ``--no-remat`` set the
``RunConfig`` knobs of the same names, as in the JAX dry run. Flags that
name the JAX package's strategies (``--attn-impl``,
``--chunk-q``/``--chunk-kv``, ``--mamba-chunk``, ``--dump-hlo``) raise:
the port runs one flash kernel and one scan launch where JAX chooses among
jnp strategies, and has no HLO.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b \\
        --shape train_4k --mesh pod1
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import roofline
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import (axis_sizes, make_production_mesh,
                                     mesh_chips)
from repro_torch.launch.sharding import (ShardingPolicy, choose_policy,
                                         distribute_state, run_config_for)
from repro_torch.models.transformer import (RunConfig, count_active_params,
                                            count_params, decode_step,
                                            init_cache, init_params, prefill)
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.weights import tree_leaves

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")
WORLD = 512  # the JAX dry run's forced host devices
META = torch.device("meta")
_JAX_ONLY = {
    "attn_impl": "the port runs one flash-attention kernel, not JAX's "
                 "chunked/tri/naive/window strategies",
    "chunk_q": "the flash kernel tiles queries itself",
    "chunk_kv": "the flash kernel tiles keys itself",
    "mamba_chunk": "the port's scan is one kernel launch over the sequence",
    "dump_hlo": "the port has no HLO",
}


def start_fake_world(world: int = WORLD) -> None:
    """The default group as ``world`` fake ranks (this process is rank 0),
    unless a group exists."""
    if dist.is_initialized():
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _local_bytes(*trees) -> int:
    return sum(roofline._nbytes(t) for tree in trees
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def plan_cell(cfg, shape, mesh, rc_base=None, policy=None,
              opt_cfg=AdamWConfig()) -> dict:
    """Lay one cell's step out over ``mesh`` on the meta device, run it
    under the per-chip counter and return the record."""
    sizes = axis_sizes(mesh)
    policy = policy or choose_policy(cfg, shape, mesh,
                                     model_axis=sizes["model"])
    rc = run_config_for(cfg, shape, mesh, base=rc_base, policy=policy)
    if policy.mode == "tp_fsdp" and rc.head_pad == 1:
        # head-TP: pad head counts to the model-axis multiple (zero-padded
        # heads are numerically inert, see models/attention.init_attn)
        rc = dataclasses.replace(rc, head_pad=sizes["model"])
    b, s, nf = shape.global_batch, shape.seq_len, cfg.n_frontend
    t0 = time.time()
    params0 = init_params(cfg, torch.Generator(), rc, device=META)
    inputs = {}
    if nf:
        inputs["frontend_embeds"] = _meta((b, nf, cfg.d_model),
                                          rc.param_dtype)
    if shape.kind == "train":
        inputs.update(tokens=_meta((b, s), torch.int32),
                      labels=_meta((b, s), torch.int32))
        st = distribute_state(cfg, mesh, policy, b, params=params0,
                              opt=adamw_init(params0), inputs=inputs)
        step = train_mod.make_train_step(cfg, rc, opt_cfg)
        args = (st["params"], st["opt"], st["inputs"])
    else:
        inputs["tokens"] = _meta((b, s if shape.kind == "prefill" else 1),
                                 torch.int32)
        st = distribute_state(cfg, mesh, policy, b, params=params0,
                              caches=init_cache(cfg, b, s + nf, rc,
                                                device=META),
                              inputs=inputs)
        front = st["inputs"].get("frontend_embeds")
        if shape.kind == "prefill":
            def step(params, tokens, caches):
                return prefill(cfg, params, tokens, caches, rc,
                               frontend=front)
        else:  # decode the last position against the full cache
            def step(params, tokens, caches):
                return decode_step(cfg, params, tokens, s + nf - 1, caches,
                                   rc)
        args = (st["params"], st["inputs"]["tokens"], st["caches"])
    inputs = list(st.values())
    plan_s = time.time() - t0
    t0 = time.time()
    with implicit_replication():
        out, cost = roofline.count(step, *args)
    count_s = time.time() - t0
    # the outputs that are inputs updated in place (JAX's donated buffers)
    in_ids = {id(t) for t in tree_leaves(list(inputs))}
    alias = sum(roofline._nbytes(t) for t in tree_leaves(list(out))
                if isinstance(t, torch.Tensor) and id(t) in in_ids)
    arg_b, out_b = _local_bytes(*inputs), _local_bytes(out)
    cost.min_bytes = arg_b + out_b - alias
    chips = mesh_chips(mesh)
    n_active = count_active_params(cfg)
    tokens_per_step = b * (s if shape.kind != "decode" else 1)
    mf = roofline.model_flops(n_active, shape.kind, tokens_per_step) / chips
    return {
        "arch": cfg.name,
        "shape": shape.name,
        "mesh": sizes,
        "chips": chips,
        "policy": dataclasses.asdict(policy),
        "rc": {k: str(v) for k, v in dataclasses.asdict(rc).items()
               if k != "shard"},
        "params_total": count_params(cfg),
        "params_active": n_active,
        "tokens_per_step": tokens_per_step,
        "plan_s": round(plan_s, 2),
        "count_s": round(count_s, 2),
        "memory": {
            "argument_bytes": arg_b,
            "output_bytes": out_b,
            "temp_bytes": None,
            "temp_bytes_reason": "meta tensors have no allocator: no peak "
                                 "of live temporaries to read",
            "alias_bytes": alias,
            "peak_estimate_bytes": None,
        },
        "counted": {"flops": cost.flops, "bytes": cost.bytes},
        "roofline": roofline.roofline_terms(cost, dtype=rc.param_dtype,
                                            model_flops_per_chip=mf),
    }


def run_cell(arch: str, shape_name: str, mesh_kind: str, rc_overrides=None,
             tag: str = "", fsdp=None, out_dir: str = RESULTS_DIR):
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if not shape_applicable(cfg, shape):
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "skipped": "full-attention arch: long_500k not applicable "
                           "(see DESIGN.md)"}
    start_fake_world()
    mesh = make_production_mesh(multi_pod=(mesh_kind == "pod2"))
    rc_base = RunConfig(**(rc_overrides or {}))
    policy = None
    if fsdp is not None:
        policy = ShardingPolicy(mode="tp_fsdp", fsdp=fsdp,
                                shard_cache_seq=(shape_name == "long_500k"))
    rec = plan_cell(cfg, shape, mesh, rc_base=rc_base, policy=policy)
    rec["mesh_kind"] = mesh_kind
    rec["tag"] = tag
    os.makedirs(out_dir, exist_ok=True)
    stem = f"{arch}_{shape_name}_{mesh_kind}{('_' + tag) if tag else ''}"
    with open(os.path.join(out_dir, stem + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-pod dry run (fake "
                                             "process group, meta device)")
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="both", choices=["pod1", "pod2",
                                                       "both"])
    ap.add_argument("--tag", default="")
    ap.add_argument("--rwkv-chunk", type=int, default=None)
    ap.add_argument("--no-mla-absorb", action="store_true")
    ap.add_argument("--fsdp", default=None, choices=[None, "on", "off"])
    ap.add_argument("--out-dir", default=RESULTS_DIR)
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--moe-groups", type=int, default=None)
    ap.add_argument("--no-remat", action="store_true")
    for name in ("attn-impl", "chunk-kv", "chunk-q", "mamba-chunk"):
        ap.add_argument(f"--{name}", default=None)
    ap.add_argument("--dump-hlo", action="store_true")
    args = ap.parse_args(argv)
    for key, why in _JAX_ONLY.items():
        if getattr(args, key) not in (None, False):
            raise SystemExit(f"--{key.replace('_', '-')}: a JAX-only "
                             f"strategy; {why}")

    rc_over = {}
    for k in ("rwkv_chunk", "capacity_factor", "moe_groups"):
        if getattr(args, k) is not None:
            rc_over[k] = getattr(args, k)
    if args.no_remat:
        rc_over["remat"] = False
    if args.no_mla_absorb:
        rc_over["mla_absorb"] = False
    fsdp = None if args.fsdp is None else (args.fsdp == "on")

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = ["pod1", "pod2"] if args.mesh == "both" else [args.mesh]
    n_ok = n_skip = n_fail = 0
    for arch in archs:
        for sh in shapes:
            for mk in meshes:
                label = f"{arch} x {sh} x {mk}"
                try:
                    t0 = time.time()
                    rec = run_cell(arch, sh, mk, rc_over, args.tag, fsdp,
                                   args.out_dir)
                    dt = time.time() - t0
                    if "skipped" in rec:
                        n_skip += 1
                        print(f"SKIP {label}: {rec['skipped']}", flush=True)
                    else:
                        n_ok += 1
                        r = rec["roofline"]
                        print(f"OK   {label}: {dt:6.1f}s "
                              f"compute={r['compute_s']:.3e}s "
                              f"memory={r['memory_s']:.3e}s "
                              f"coll={r['collective_s']:.3e}s "
                              f"dom={r['dominant']} "
                              f"frac={r.get('roofline_fraction', 0):.3f}",
                              flush=True)
                except Exception as e:  # noqa: BLE001 - one line a cell
                    n_fail += 1
                    print(f"FAIL {label}: {e}", flush=True)
                    traceback.print_exc()
    print(f"\ndry-run done: ok={n_ok} skip={n_skip} fail={n_fail}",
          flush=True)
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()

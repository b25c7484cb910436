"""Roofline of one step of the port, counted on the ``meta`` device.

Port of ``repro/roofline.py``. The JAX module parses compiled HLO and
models a TPU; the port has no HLO. It runs its own program instead, the
model's ``prefill``, ``decode_step`` or train step (loss, backward and the
in-place AdamW update of ``launch/train.py``), on meta tensors, where
nothing is allocated or computed, and counts what each op would do:

  - FLOPs: the formulas of ``torch.utils.flop_counter`` (products and
    convolutions, 2 per multiply-add; elementwise ops count 0, as in the
    JAX module's HLO walk);
  - bytes: each aten op's operands read once and results written once.
    Views and metadata ops move nothing (the JAX module's ``_SKIP_BYTES``);
    an in-place op writes its destination once beside its reads, and
    ``copy_`` does not read it, so a cache write counts twice the written
    slice (the JAX module's in-place ``dynamic-update-slice``); a gather
    (``index``, ``embedding``) counts twice its result, not its whole
    table, and an indexed write in place (``index_copy_``) twice its
    update;
  - the six CUDA kernels run through ``ctypes``, which no mode sees: on a
    meta tensor ``kernels.ops`` hands back empty outputs and records each
    kernel's analytic ``(flops, bytes)`` (``work`` in its kernel module),
    which are added here;
  - ``min_bytes``: every parameter, optimizer leaf, cache leaf, input and
    output once, what any program computing the step must move, whatever
    it fuses.

Python loops (stacked stages, loss chunks, RWKV chunks) run as they run on
the card, so each iteration is counted: the analogue of the JAX module's
while-loop trip counts.

Over a mesh (DTensors, ``launch/dryrun.py``) the counts are one chip's:
the counting mode passes every op on DTensors to DTensor, which runs it as
ops on the local shards and the collectives its redistributions need, and
counts those. FLOPs are the registry's of ``torch.utils.flop_counter``
(``FlopCounterMode`` above the DTensors would count the global ops), and
the ops that DTensor's sharding propagation runs on fake tensors of the
global shapes are not counted. Each collective (``_c10d_functional``)
adds the JAX module's modeled wire bytes a device: all-gather (n-1)/n of
its output, reduce-scatter (n-1) times its output, all-reduce 2(n-1)/n of
its operand, all-to-all (n-1)/n of it; a group within one 8-GPU node
moves them at the NVLink rate, a group that spans nodes at the
inter-node rate.

Hardware model: one NVIDIA H100 SXM at its 700 W limit (data sheet), HBM
3.35e12 B/s, dense bf16 989e12 FLOP/s; float32 products at the 3xTF32 rate
(three TF32 products, 494.7e12 FLOP/s, for each f32 one). The port's f32
``torch.matmul`` runs without TF32 (nothing in ``src/repro_torch`` enables
it), so the f32 bound is the card's with 3xTF32 kernels, not the rate
the library reaches.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import ops
from repro_torch.launch import train as train_mod
from repro_torch.models import transformer as tf
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.weights import tree_leaves

HBM_BW = 3.35e12  # bytes/s, H100 SXM data sheet
# dense tensor-core rates, H100 SXM data sheet; f32 as 3xTF32
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 494.7e12 / 3}
NVLINK_BW = 450e9  # bytes/s each way, H100 SXM NVLink 4 (900 GB/s both)
# bytes/s each way a GPU between nodes: one 400 Gb/s ConnectX-7 NIC a GPU
# (DGX H100 data sheet: 8 of them for 8 GPUs)
INTER_NODE_BW = 50e9
GPUS_PER_NODE = 8  # one DGX / HGX H100 node

_aten = torch.ops.aten
# ops that allocate or reshape without moving data (``func.is_view`` covers
# the rest: transpose, slice, expand, ...)
_SKIP = {_aten.empty, _aten.empty_like, _aten.empty_strided,
         _aten._unsafe_view}
# reads a slice of a table: twice its result, as the JAX module's gather
_GATHER = {_aten.index, _aten.index_select, _aten.gather, _aten.embedding}
# writes rows in place: twice its update (the last tensor argument), as the
# JAX module's in-place scatter
_SCATTER = {_aten.index_copy_, _aten.index_put_, _aten.index_add_,
            _aten.scatter_, _aten.scatter_add_}


def _nbytes(t: torch.Tensor) -> int:
    """Bytes a tensor addresses: a broadcast (stride-0) dim counts once; a
    DTensor's are its local shard's."""
    if isinstance(t, DTensor):
        t = t.to_local()
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _op_bytes(func, args, kwargs, out):
    """Bytes an aten op moves, or None for a view or metadata op."""
    packet = func.overloadpacket
    if packet in _SKIP or func.is_view:
        return None
    if packet in _GATHER:
        return 2 * sum(_nbytes(t) for t in _tensors(out))
    if packet in _SCATTER:
        return 2 * _nbytes(_tensors(args)[-1])
    reads = _tensors(args) + _tensors(kwargs)
    written = _tensors([v for a, v in zip(func._schema.arguments, args)
                        if a.alias_info is not None
                        and a.alias_info.is_write])
    if not written:  # out of place: operands read, results written
        return sum(map(_nbytes, reads + _tensors(out)))
    # in place: operands read, the destination written once; copy_ does
    # not read its destination (its first operand)
    if packet == _aten.copy_:
        reads = reads[1:]
    return sum(map(_nbytes, reads + written))


_COLLECTIVES = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
                "all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all"}
# functional-collective bookkeeping: no data moves
_COLL_SKIP = {"wait_tensor", "_wrap_tensor_autograd"}


def _group_ranks(args) -> list:
    """The global ranks of a functional collective's group (its last
    string argument names it)."""
    name = [a for a in args if isinstance(a, str)][-1]
    pg = dist.distributed_c10d._resolve_process_group(name)
    return dist.get_process_group_ranks(pg)


def _collective(kind: str, args, out) -> tuple:
    """(group size, whether the group spans nodes, operand bytes, modeled
    wire bytes a device) of one functional collective."""
    ranks = _group_ranks(args)
    n = len(ranks)
    in_b = _nbytes(args[0])
    out_b = sum(map(_nbytes, _tensors(out)))
    wire = {"all-gather": out_b * (n - 1) / n,
            "reduce-scatter": out_b * (n - 1),
            "all-reduce": 2.0 * in_b * (n - 1) / n,
            "all-to-all": in_b * (n - 1) / n}[kind]
    spans = len({r // GPUS_PER_NODE for r in ranks}) > 1
    return n, spans, in_b, wire


class _Counter(TorchDispatchMode):
    """Calls, FLOPs and bytes of every aten op, by op name, and every
    collective. An op on DTensors is handed back to DTensor, which runs it
    as ops on the local shards and collectives, and those come here: the
    counts are one chip's."""

    def __init__(self):
        super().__init__()
        self.rows: dict = {}  # name -> [calls, flops, bytes]
        self.colls: list = []  # (kind, group size, spans nodes, in, wire)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat = _tensors((args, kwargs))
        if any(isinstance(t, DTensor) for t in flat):
            return NotImplemented
        out = func(*args, **kwargs)
        if any(isinstance(t, FakeTensor) for t in flat):
            return out  # sharding propagation on global shapes: no chip's
        if func.namespace == "_c10d_functional":
            name = func.overloadpacket.__name__
            if name not in _COLL_SKIP:
                kind = _COLLECTIVES[name]
                self.colls.append((kind, *_collective(kind, args, out)))
                self._add(f"collective:{kind}", 0, sum(
                    map(_nbytes, _tensors(args) + _tensors(out))))
            return out
        nbytes = _op_bytes(func, args, kwargs, out)
        packet = func.overloadpacket
        flops = flop_registry[packet](*args, **kwargs, out_val=out) \
            if packet in flop_registry else 0
        if nbytes is not None or flops:
            self._add(str(packet), flops, nbytes or 0)
        return out

    def _add(self, name: str, flops, nbytes) -> None:
        row = self.rows.setdefault(name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += float(flops)
        row[2] += float(nbytes)


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll_wire: float = 0.0  # modeled per-device wire bytes
    coll_wire_inter: float = 0.0  # of ``coll_wire``, in groups across nodes
    coll_operand_bytes: float = 0.0  # spec metric: sum of operand sizes
    coll_counts: dict = field(default_factory=dict)
    min_bytes: float = 0.0  # each leaf, input and output once
    kernel_flops: float = 0.0  # of ``flops``, the CUDA kernels' share
    rows: dict = field(default_factory=dict)  # name -> [calls, flops, bytes]

    def add(self, other: "Cost", mult: float = 1.0):
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        self.coll_wire += other.coll_wire * mult
        self.coll_wire_inter += other.coll_wire_inter * mult
        self.coll_operand_bytes += other.coll_operand_bytes * mult
        for k, v in other.coll_counts.items():
            self.coll_counts[k] = self.coll_counts.get(k, 0) + v * mult
        self.min_bytes += other.min_bytes * mult
        self.kernel_flops += other.kernel_flops * mult
        for k, v in other.rows.items():
            row = self.rows.setdefault(k, [0, 0.0, 0.0])
            for i in range(3):
                row[i] += v[i] * mult


def count(fn, *args, **kwargs):
    """Runs ``fn(*args, **kwargs)`` (on meta tensors, or DTensors of meta
    shards) and returns (its result, the ``Cost`` of what it ran, one
    chip's; ``min_bytes`` is left 0)."""
    counter = _Counter()
    with ops.record_work() as kernels, counter:
        result = fn(*args, **kwargs)
    cost = Cost()
    cost.rows = counter.rows
    for name, kflops, kbytes in kernels:
        row = cost.rows.setdefault(f"kernel:{name}", [0, 0.0, 0.0])
        row[0] += 1
        row[1] += kflops
        row[2] += kbytes
        cost.kernel_flops += kflops
    for kind, _, spans, in_b, wire in counter.colls:
        cost.coll_counts[kind] = cost.coll_counts.get(kind, 0) + 1
        cost.coll_operand_bytes += in_b
        cost.coll_wire += wire
        cost.coll_wire_inter += wire if spans else 0.0
    cost.flops = sum(r[1] for r in cost.rows.values())
    cost.bytes = sum(r[2] for r in cost.rows.values())
    return result, cost


def _tree_bytes(*trees) -> int:
    return sum(_nbytes(t) for tree in trees for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def step_cost(cfg, rc, kind: str, batch: int, seq: int, *, pos=None,
              frontend_rows: int = 0) -> Cost:
    """The counted work of one step of ``cfg`` under ``rc``:
    ``kind="prefill"``: ``frontend_rows`` + ``seq`` rows into a cache of
    that length; ``"decode"``: one token at ``pos`` (default ``seq - 1``)
    against a cache of ``seq`` positions; ``"train"``: a batch of ``seq``
    tokens after ``frontend_rows`` front-end embeddings, loss, backward
    and AdamW. Runs below the launchers, which read results on the host."""
    if kind not in ("train", "prefill", "decode"):
        raise ValueError(f"kind {kind!r}: train, prefill or decode")
    meta = torch.device("meta")
    params = tf.init_params(cfg, torch.Generator(), rc, device=meta)
    front = (torch.empty((batch, frontend_rows, cfg.d_model),
                         dtype=rc.param_dtype, device=meta)
             if frontend_rows else None)
    if kind == "train":
        opt = adamw_init(params)
        data = {"tokens": torch.empty((batch, seq), dtype=torch.int64,
                                      device=meta),
                "labels": torch.empty((batch, seq), dtype=torch.int64,
                                      device=meta)}
        if front is not None:
            data["frontend_embeds"] = front
        step = train_mod.make_train_step(cfg, rc, AdamWConfig())
        (_, _, metrics), cost = count(step, params, opt, data)
        cost.min_bytes = _tree_bytes(params, opt, data, metrics)
        return cost
    tokens = torch.empty((batch, seq if kind == "prefill" else 1),
                         dtype=torch.int64, device=meta)
    if kind == "prefill":
        caches = tf.init_cache(cfg, batch, frontend_rows + seq, rc, meta)
        (logits, _), cost = count(tf.prefill, cfg, params, tokens, caches,
                                  rc, frontend=front)
    else:
        caches = tf.init_cache(cfg, batch, seq, rc, meta)
        (logits, _), cost = count(tf.decode_step, cfg, params, tokens,
                                  seq - 1 if pos is None else pos, caches,
                                  rc)
    cost.min_bytes = _tree_bytes(params, caches, tokens, front, logits)
    return cost


def _dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


def roofline_terms(cost: Cost, *, dtype, model_flops_per_chip: float = 0.0):
    """Returns the three-term roofline dict (seconds, per chip): compute at
    the peak of the step's compute ``dtype``, memory at the HBM rate."""
    compute_s = cost.flops / PEAK_FLOPS[_dtype_name(dtype)]
    memory_s = cost.bytes / HBM_BW
    coll_s = (cost.coll_wire - cost.coll_wire_inter) / NVLINK_BW \
        + cost.coll_wire_inter / INTER_NODE_BW
    dominant = max(
        (("compute", compute_s), ("memory", memory_s),
         ("collective", coll_s)), key=lambda kv: kv[1])[0]
    out = {
        "counted_flops_per_chip": cost.flops,
        "counted_bytes_per_chip": cost.bytes,
        "min_bytes_per_chip": cost.min_bytes,
        "kernel_flops_share": (cost.kernel_flops / cost.flops
                               if cost.flops else 0.0),
        "coll_wire_bytes_per_chip": cost.coll_wire,
        "coll_wire_inter_node_bytes_per_chip": cost.coll_wire_inter,
        "coll_operand_bytes_per_chip": cost.coll_operand_bytes,
        "coll_counts": {k: float(v) for k, v in cost.coll_counts.items()},
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": coll_s,
        "dominant": dominant,
        "step_s_lower_bound": max(compute_s, memory_s, coll_s),
    }
    if model_flops_per_chip:
        peak = PEAK_FLOPS[_dtype_name(dtype)]
        out["model_flops_per_chip"] = model_flops_per_chip
        out["useful_flops_ratio"] = (
            model_flops_per_chip / cost.flops if cost.flops else 0.0)
        out["roofline_fraction"] = (
            (model_flops_per_chip / peak)
            / out["step_s_lower_bound"] if out["step_s_lower_bound"] else 0.0)
    return out


def model_flops(n_params_active: int, shape_kind: str, tokens: int) -> float:
    """MODEL_FLOPS: 6·N·D for training, 2·N·D for inference forward."""
    if shape_kind == "train":
        return 6.0 * n_params_active * tokens
    return 2.0 * n_params_active * tokens


def cost_breakdown(cost: Cost, top_k: int = 25):
    """The ``top_k`` rows of ``cost`` by bytes: (aten op or
    ``kernel:<name>``, {"count", "flops", "bytes"})."""
    rows = sorted(cost.rows.items(), key=lambda kv: -kv[1][2])
    return [(name, {"count": calls, "flops": flops, "bytes": nbytes})
            for name, (calls, flops, nbytes) in rows[:top_k]]

"""Roofline of one step of the port, counted on the ``meta`` device.

Port of ``repro/roofline.py``. The JAX module parses compiled HLO and
models a TPU; the port has no HLO. It runs its own program instead, the
model's ``prefill``, ``decode_step`` or train step (loss, backward and the
in-place AdamW update of ``launch/train.py``), on meta tensors, where
nothing is allocated or computed, and counts what each op would do:

  - FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (products and
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
  - the five CUDA kernels run through ``ctypes``, which no mode sees: on a
    meta tensor ``kernels.ops`` hands back empty outputs and records each
    kernel's analytic ``(flops, bytes)`` (``work`` in its kernel module),
    which are added here;
  - ``min_bytes``: every parameter, optimizer leaf, cache leaf, input and
    output once, what any program computing the step must move, whatever
    it fuses.

Python loops (stacked stages, loss chunks, RWKV chunks) run as they run on
the card, so each iteration is counted: the analogue of the JAX module's
while-loop trip counts. Collectives: none on one card (``collective_s`` is
0 until the sharding slice models them).

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
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import ops
from repro_torch.launch import train as train_mod
from repro_torch.models import transformer as tf
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.weights import tree_leaves

HBM_BW = 3.35e12  # bytes/s, H100 SXM data sheet
# dense tensor-core rates, H100 SXM data sheet; f32 as 3xTF32
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 494.7e12 / 3}
NVLINK_BW = 450e9  # bytes/s each way, H100 SXM NVLink 4 (900 GB/s both)

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
    """Bytes a tensor addresses: a broadcast (stride-0) dim counts once."""
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


class _ByteCounter(TorchDispatchMode):
    """Bytes and calls of every aten op, by op name."""

    def __init__(self):
        super().__init__()
        self.rows: dict = {}  # name -> [calls, bytes]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        nbytes = _op_bytes(func, args, kwargs, out)
        if nbytes is not None:
            row = self.rows.setdefault(str(func.overloadpacket), [0, 0])
            row[0] += 1
            row[1] += nbytes
        return out


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll_wire: float = 0.0  # modeled per-device wire bytes
    coll_operand_bytes: float = 0.0  # spec metric: sum of operand sizes
    coll_counts: dict = field(default_factory=dict)
    min_bytes: float = 0.0  # each leaf, input and output once
    kernel_flops: float = 0.0  # of ``flops``, the CUDA kernels' share
    rows: dict = field(default_factory=dict)  # name -> [calls, flops, bytes]

    def add(self, other: "Cost", mult: float = 1.0):
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        self.coll_wire += other.coll_wire * mult
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
    """Runs ``fn(*args, **kwargs)`` (on meta tensors) and returns (its
    result, the ``Cost`` of what it ran; ``min_bytes`` is left 0)."""
    counter = _ByteCounter()
    flops = FlopCounterMode(display=False)
    with ops.record_work() as kernels, flops, counter:
        result = fn(*args, **kwargs)
    cost = Cost()
    op_flops = {str(k): v for k, v in flops.get_flop_counts()
                .get("Global", {}).items()}
    for name, (calls, nbytes) in counter.rows.items():
        cost.rows[name] = [calls, float(op_flops.get(name, 0)),
                           float(nbytes)]
    for name, kflops, kbytes in kernels:
        row = cost.rows.setdefault(f"kernel:{name}", [0, 0.0, 0.0])
        row[0] += 1
        row[1] += kflops
        row[2] += kbytes
        cost.kernel_flops += kflops
    cost.flops = float(flops.get_total_flops()) + cost.kernel_flops
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
    coll_s = cost.coll_wire / NVLINK_BW
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

"""Sharding rules: parameter path -> partition spec (FSDP x TP x EP), and
the spec as DTensor placements.

Port of ``repro/launch/sharding.py``. The rule functions return the JAX
package's spec tuples unchanged: one entry a tensor dim, each None, a mesh
axis name or a tuple of them (``PartitionSpec``'s contents). The model
axis carries tensor parallelism (heads / ffn / experts / vocab); the
(pod, data) axes carry data parallelism and, when the policy enables it,
FSDP. Rules are keyed by the trailing parameter name; a stacked stage's
leading repeat dim is padded with None.

``placements`` turns a spec into DTensor placements, one a mesh dim, and
raises where JAX would: a dim that its axes' product does not divide (a
DTensor shards unevenly without complaint), and several axes on one dim
in another order than the mesh's (a DTensor splits a dim over its mesh
dims in mesh order). ``distribute`` lays a tree of tensors out by a tree
of specs. Where the JAX package returns ``NamedSharding`` trees, the
functions here return spec trees, and ``distribute`` applies them.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.launch.mesh import axis_sizes, dp_axes
from repro_torch.models.transformer import RunConfig


@dataclass(frozen=True)
class ShardingPolicy:
    mode: str = "tp_fsdp"  # tp_fsdp | dp_zero1
    fsdp: bool = True  # (tp_fsdp) shard the non-TP weight dim over (pod,data)
    shard_cache_seq: bool = False  # long-context: shard KV cache over seq
    compress_grads: bool = False


def choose_policy(cfg: ArchConfig, shape: ShapeSpec, mesh=None,
                  model_axis: int = 16) -> ShardingPolicy:
    """Memory-driven default, as the JAX package's: archs under 2.6B
    parameters run pure data-parallel over the whole mesh with ZeRO-1
    (parameters replicated, Adam moments TP-sharded, batch over data x
    model); larger ones TP over ``model``, plus FSDP over (pod, data) when
    the TP-sharded state would still pass ~4 GB a chip (12 bytes a
    parameter to train, 2 to serve)."""
    from repro_torch.models.transformer import count_params
    n = count_params(cfg)
    seq_shard = (shape.name == "long_500k")
    if n < 2.6e9:
        return ShardingPolicy(mode="dp_zero1", fsdp=False,
                              shard_cache_seq=seq_shard)
    if shape.kind == "train":
        need = n * 12 / model_axis
    else:
        need = n * 2 / model_axis
    return ShardingPolicy(mode="tp_fsdp", fsdp=need > 4e9,
                          shard_cache_seq=seq_shard)


# ---------------------------------------------------------------------------
# Parameter rules
# ---------------------------------------------------------------------------

# trailing-dims partition templates; "F" = fsdp axes, "M" = model axis
_RULES_2D_IN_OUT = {  # (d_in, d_out_tp): F, M
    "wq", "wk", "wv", "q_a", "q_b", "kv_a", "kv_b", "in_proj", "w_gate",
    "w_up", "ck", "cr", "wr", "wg", "mix_w1", "dw1", "dt_proj",
}
_RULES_2D_OUT_IN = {  # (d_tp, d_out): M, F
    "wo", "w_down", "out_proj", "cv", "x_proj",
}
_RULES_VEC_TP = {"bq", "bk", "bv", "conv_b", "dt_bias", "D"}
_REPLICATED = {
    "scale", "bias", "mix_mu", "mix_x", "mix_w2", "dw2", "w0", "bonus_u",
    "ln_x_scale", "ln_x_bias", "cmu_k", "cmu_r", "q_a_norm", "kv_a_norm",
}


def _param_partition(path_keys, leaf_ndim: int, fsdp_axes) -> tuple:
    name = path_keys[-1]
    f = fsdp_axes if fsdp_axes else None
    if name == "embed":
        spec = ("model", f)
    elif name == "lm_head":
        spec = (f, "model")
    elif name == "router":
        spec = (f, None)
    elif name in ("w_gate", "w_up") and leaf_ndim >= 3:
        spec = ("model", f, None)  # MoE experts: EP over model
    elif name == "w_down" and leaf_ndim >= 3:
        spec = ("model", None, f)
    elif name in _RULES_2D_IN_OUT:
        spec = (f, "model")
    elif name in _RULES_2D_OUT_IN:
        spec = ("model", f)
    elif name == "conv_w":
        spec = (None, "model")
    elif name == "A_log":
        spec = ("model", None)
    elif name in _RULES_VEC_TP:
        spec = ("model",)
    elif name in _REPLICATED or name == "step":
        spec = ()
    else:
        spec = ()  # unknown: replicate (safe)
    spec = spec[:leaf_ndim]
    pad = leaf_ndim - len(spec)
    return tuple([None] * pad) + tuple(spec)


def _path_names(path) -> list:
    """The names of a path of dict keys and list indices, as strings."""
    return [str(p) for p in path]


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a nested dict/list tree; ``path`` is the
    tuple of keys and indices down to the leaf. A tuple is a leaf (a spec
    tree's leaves are spec tuples)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, path + (i,))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def param_shardings(cfg: ArchConfig, params_shape, mesh,
                    policy: ShardingPolicy, *, force_tp: bool = False):
    """A spec for every leaf of ``params_shape`` (any tree of tensors; meta
    tensors suffice). Rules apply at the parameter's intrinsic rank: a
    stacked stage's leading repeat dim is padded with None. dp_zero1
    replicates parameters (``force_tp`` still applies the TP rules: the
    ZeRO-1 optimizer moments)."""
    if policy.mode == "dp_zero1" and not force_tp:
        return tree_map_with_path(lambda _p, _l: (), params_shape)
    fsdp_axes = dp_axes(mesh) if (policy.fsdp and policy.mode == "tp_fsdp"
                                  and not force_tp) else None

    def rule(path, leaf):
        names = _path_names(path)
        ndim = len(leaf.shape)
        if names and names[0] == "stages":
            if cfg.stages[int(names[1])].repeat > 1:
                ndim -= 1  # leading repeat dim
        spec = _param_partition(names, ndim, fsdp_axes)
        return (None,) * (len(leaf.shape) - len(spec)) + spec

    return tree_map_with_path(rule, params_shape)


def opt_shardings(cfg, opt_shape, params_sharding_tree, mesh,
                  policy: ShardingPolicy):
    """Adam moments follow the parameter specs (tp_fsdp) or get the TP
    rules (dp_zero1 = ZeRO-1: moments sharded though the parameters are
    replicated); step is replicated."""
    if policy.mode == "dp_zero1":
        mt = param_shardings(cfg, opt_shape["m"], mesh, policy,
                             force_tp=True)
        return {"m": mt, "v": mt, "step": ()}
    return {"m": params_sharding_tree, "v": params_sharding_tree,
            "step": ()}


# ---------------------------------------------------------------------------
# Activation / batch / cache rules
# ---------------------------------------------------------------------------


def batch_axes(mesh, policy: ShardingPolicy, batch_size: int):
    """Axes the batch dim is sharded over: the whole mesh for dp_zero1
    (falling back by divisibility), dp axes otherwise."""
    sizes = axis_sizes(mesh)
    cands = []
    if policy.mode == "dp_zero1":
        cands = [dp_axes(mesh) + ("model",), ("data", "model")]
    cands += [dp_axes(mesh), ("data",)]
    for cand in cands:
        cand = tuple(a for a in cand if a in sizes)
        n = math.prod(sizes[a] for a in cand)
        if cand and batch_size % n == 0 and batch_size >= n:
            return cand
    return None


def batch_shardings(mesh, has_frontend: bool, batch_size: int,
                    policy: ShardingPolicy = ShardingPolicy()):
    bspec = batch_axes(mesh, policy, batch_size)
    out = {"tokens": (bspec, None), "labels": (bspec, None)}
    if has_frontend:
        out["frontend_embeds"] = (bspec, None, None)
    return out


def cache_partition(path_keys, leaf_ndim: int, *, dp, seq_shard: bool,
                    heads_ok: bool = False) -> tuple:
    """KV caches: batch over dp (or seq over dp for long context) and, when
    the (padded) kv-head count divides the model axis, heads over
    ``model``, matching the head-TP attention layout; recurrent states:
    feature dims over model."""
    name = path_keys[-1]
    h = "model" if heads_ok else None
    if name in ("k", "v"):  # (B, S, Hk, dh)
        spec = (None, dp, h, None) if seq_shard else (dp, None, h, None)
    elif name == "c_kv" or name == "k_rope":  # (B, S, r)
        spec = (None, dp, None) if seq_shard else (dp, None, None)
    elif name == "conv":  # (B, K-1, di)
        spec = (None, None, "model") if seq_shard else (dp, None, "model")
    elif name == "ssm":  # (B, di, ds)
        spec = (None, "model", None) if seq_shard else (dp, "model", None)
    elif name == "wkv":  # (B, H, dk, dv)
        spec = (None, "model", None, None) if seq_shard \
            else (dp, "model", None, None)
    elif name.startswith("shift"):  # (B, d)
        spec = (None, None) if seq_shard else (dp, None)
    else:
        spec = ()
    pad = leaf_ndim - len(spec)
    return (None,) * pad + spec


def cache_shardings(cache_shape, mesh, policy: ShardingPolicy,
                    batch_size: int):
    dp = dp_axes(mesh)
    sizes = axis_sizes(mesh)
    ndp = math.prod(sizes[a] for a in dp)
    seq_shard = policy.shard_cache_seq or batch_size % ndp != 0 \
        or batch_size < ndp
    model = sizes.get("model", 1)

    def rule(path, leaf):
        names = _path_names(path)
        heads_ok = bool(policy.mode == "tp_fsdp" and names
                        and names[-1] in ("k", "v") and len(leaf.shape) >= 2
                        and leaf.shape[-2] % model == 0)
        return cache_partition(names, len(leaf.shape), dp=dp,
                               seq_shard=seq_shard, heads_ok=heads_ok)

    return tree_map_with_path(rule, cache_shape)


# ---------------------------------------------------------------------------
# Specs as DTensor placements
# ---------------------------------------------------------------------------


def placements(mesh, spec_tuple, shape) -> tuple:
    """The DTensor placements (one a mesh dim) of a tensor of ``shape``
    laid out by ``spec_tuple``. Raises on a dim that its axes' product
    does not divide, and on several axes of one dim in another order than
    the mesh's."""
    sizes = axis_sizes(mesh)
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    if len(spec_tuple) > len(shape):
        raise ValueError(f"spec {spec_tuple} has more entries than shape "
                         f"{tuple(shape)}")
    for dim, entry in enumerate(spec_tuple):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        if not axes:
            continue
        n = math.prod(sizes[a] for a in axes)
        if shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} is not divisible "
                             f"by {axes} (size {n}) in spec {spec_tuple}")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} of dim {dim} are not in the "
                             f"mesh's order {tuple(names)}: a DTensor "
                             "splits a dim over its mesh dims in mesh order")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]} used twice in "
                                 f"{spec_tuple}")
            out[i] = Shard(dim)
    return tuple(out)


def distribute(tree, spec_tree, mesh):
    """Every tensor of ``tree`` as a DTensor laid out by its spec in
    ``spec_tree`` (a meta tensor gives meta shards)."""
    def one(t, spec):
        return distribute_tensor(t, mesh, placements(mesh, spec, t.shape))
    return _map2(one, tree, spec_tree)


def distribute_state(cfg: ArchConfig, mesh, policy: ShardingPolicy,
                     batch_size: int, *, params, opt=None, caches=None,
                     inputs=None) -> dict:
    """A step's state laid out over ``mesh`` by the rules, as DTensors:
    ``params`` by ``param_shardings``, ``opt`` by ``opt_shardings``,
    ``caches`` by ``cache_shardings`` and ``inputs`` (tokens, labels,
    frontend_embeds) by ``batch_shardings``. Returns a dict of the given
    ones under the same names."""
    p_sh = param_shardings(cfg, params, mesh, policy)
    out = {"params": distribute(params, p_sh, mesh)}
    if opt is not None:
        out["opt"] = distribute(opt, opt_shardings(cfg, opt, p_sh, mesh,
                                                   policy), mesh)
    if caches is not None:
        out["caches"] = distribute(caches, cache_shardings(
            caches, mesh, policy, batch_size), mesh)
    if inputs is not None:
        b_sh = batch_shardings(mesh, "frontend_embeds" in inputs,
                               batch_size, policy)
        out["inputs"] = {k: distribute_tensor(v, mesh, placements(
            mesh, b_sh[k], v.shape)) for k, v in inputs.items()}
    return out


def _map2(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map2(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map2(fn, v, s) for v, s in zip(tree, specs)]
    return fn(tree, specs)


def make_shard_fn(mesh, policy: ShardingPolicy = ShardingPolicy(),
                  bsz: int = 0):
    """Builds ``RunConfig.shard``: translates logical axis tokens to this
    mesh and redistributes a DTensor to them.

    Tokens: 'data' -> the policy's batch axes; 'model' -> model (dropped
    under dp_zero1 where the model axis carries batch); 'bh' -> the
    maximal axis combo whose product divides the dim (attention (B*H)
    super-batch). Non-divisible entries are dropped (replicated). A plain
    tensor passes unchanged on a one-rank mesh and raises on a larger one.
    ``shard.spec(x, spec_tuple)`` gives the chosen spec alone."""
    sizes = axis_sizes(mesh)
    dp = batch_axes(mesh, policy, bsz) or dp_axes(mesh)
    model = sizes.get("model", 1)
    model_token = None if (policy.mode == "dp_zero1"
                           and "model" in dp) else "model"

    def _axes_size(axes) -> int:
        return math.prod(sizes[a] for a in axes)

    def spec_for(x, spec_tuple) -> tuple:
        spec = []
        for i, s in enumerate(spec_tuple[: x.ndim]):
            dim = x.shape[i]
            if s == "data":
                spec.append(dp if dp and dim % _axes_size(dp) == 0 else None)
            elif s == "model":
                spec.append(model_token if model_token
                            and dim % model == 0 else None)
            elif s == "bh":
                chosen = None
                cands = [dp] if "model" in dp else [dp + ("model",), dp]
                cands += [("data",)]
                for cand in cands:
                    cand = tuple(a for a in cand if a in sizes)
                    if cand and dim % _axes_size(cand) == 0:
                        chosen = cand
                        break
                spec.append(chosen)
            else:
                spec.append(s)
        spec += [None] * (x.ndim - len(spec))
        return tuple(spec)

    def shard(x, spec_tuple):
        spec = spec_for(x, spec_tuple)
        if not isinstance(x, DTensor):
            if math.prod(mesh.shape) > 1:
                raise TypeError(f"shard: a plain {type(x).__name__} of shape "
                                f"{tuple(x.shape)} on a mesh of "
                                f"{math.prod(mesh.shape)} ranks; lay it out "
                                "as a DTensor first")
            return x
        return x.redistribute(mesh, placements(mesh, spec, x.shape))

    def gather_fsdp(tree):
        """Every DTensor of ``tree`` with its shards over the data axes
        (FSDP) all-gathered: the parameters as a layer computes with them,
        ZeRO-3's all-gather, whose backward reduce-scatters the
        gradients."""
        dp_dims = {i for i, a in enumerate(mesh.mesh_dim_names)
                   if a in ("pod", "data")}

        def one(t):
            if not isinstance(t, DTensor):
                return t
            pl = tuple(Replicate() if i in dp_dims and isinstance(p, Shard)
                       else p for i, p in enumerate(t.placements))
            return t if pl == t.placements else t.redistribute(mesh, pl)
        return _map1(one, tree)

    shard.spec = spec_for
    shard.gather_fsdp = gather_fsdp
    return shard


def _map1(fn, tree):
    if isinstance(tree, dict):
        return {k: _map1(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map1(fn, v) for v in tree]
    return fn(tree)


def run_config_for(cfg: ArchConfig, shape: ShapeSpec, mesh,
                   base: Optional[RunConfig] = None,
                   policy: ShardingPolicy = ShardingPolicy()) -> RunConfig:
    rc = base or RunConfig()
    return dataclasses.replace(
        rc, shard=make_shard_fn(mesh, policy, shape.global_batch))


__all__ = ["ShardingPolicy", "batch_axes", "batch_shardings",
           "cache_partition", "cache_shardings", "choose_policy",
           "distribute", "distribute_state", "make_shard_fn", "opt_shardings",
           "param_shardings", "placements", "run_config_for",
           "tree_map_with_path"]

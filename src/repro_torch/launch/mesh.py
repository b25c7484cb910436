"""Device meshes over ``torch.distributed``.

Port of ``repro/launch/mesh.py``. Functions (never module-level
constants), so importing this module starts no process group. The
production meshes are the JAX package's: single-pod 16x16 = 256 ranks
``("data", "model")``, multi-pod 2x16x16 = 512 ranks ``("pod", "data",
"model")``. They are built over the default process group, which
``launch/dryrun.py`` starts as a ``fake`` group of 512 ranks (the JAX dry
run forces 512 host devices); a real cluster would start NCCL over its
nodes. ``make_debug_mesh`` runs over the real world, one rank on one card.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch import device as device_mod


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The (16, 16) or (2, 16, 16) mesh of GPUs over the first 256 or 512
    ranks of the default group. The mesh's device type picks DTensor's
    collectives (a "cpu" mesh gathers where a "cuda" one exchanges all to
    all); the dry run's tensors live on ``meta``, and its fake group
    touches no device."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world < n:
        raise RuntimeError(
            f"need {n} devices for mesh {shape}, have {world} — "
            "run under launch/dryrun.py (it starts a fake group of 512 "
            "ranks)")
    if world == n:
        return init_device_mesh("cuda", shape, mesh_dim_names=axes)
    # e.g. the single-pod mesh in a 512-rank dry run
    return DeviceMesh("cuda", torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_debug_mesh(data: int = 1, model: int = 1,
                    device="cuda") -> DeviceMesh:
    """A (data, model) mesh over the real world (tests, ``chip_smoke.py``):
    starts a group of one rank (NCCL on the card, gloo on the CPU) if none
    exists. ``device`` is resolved as every entry point's: ``"cuda"``
    unless the caller asks for the CPU, and raising where there is no
    card."""
    dev = device_mod.resolve(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    return init_device_mesh(dev.type, (data, model),
                            mesh_dim_names=("data", "model"))


def axis_sizes(mesh) -> dict:
    """{axis name: size}, in mesh order (JAX's ``mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def dp_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def mesh_chips(mesh) -> int:
    return math.prod(mesh.shape)

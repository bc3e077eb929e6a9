"""Production meshes (port of `repro/launch/mesh.py`): named-axis views
(`runtime.meshctx.Mesh`) and DPC block layouts (`core.distributed.DPCMesh`)
over the ranks of `torch.distributed`.  Functions, not module constants,
so importing touches no process group.  `device` is where the tensors of
the ranks live, ``"cuda"`` unless given."""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

from repro_torch.runtime.meshctx import Mesh


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """16x16 = 256 ranks per pod; 2 pods = 512 ranks multi-pod.  Raises
    ValueError naming the rank count when the world has another size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, device)


def make_flat_mesh(mesh=None, name: str = "shards"):
    """1-D view over the same ranks — the DPC slab axis (a `DPCMesh` with
    the one axis `name`)."""
    from repro_torch.core.distributed import DPCMesh
    if mesh is None:
        mesh = make_production_mesh()
    return DPCMesh((mesh.size,), (name,), None, mesh.device)


def make_block_mesh(layout, mesh=None):
    """N-D view over the same ranks — the DPC block lattice.

    layout: per-axis block counts, e.g. (4, 2) or (2, 2, 2); mesh axis a
    decomposes grid axis a (axis names bx/by/bz).  Reuses the ranks of
    `mesh` (default: the production mesh) so the DPC workload can share a
    pod with training jobs; total layout size must match the rank count.
    """
    from repro_torch.core.distributed import make_dpc_mesh
    if mesh is None:
        mesh = make_production_mesh()
    layout = tuple(int(p) for p in layout)
    if math.prod(layout) != mesh.size:
        raise ValueError(f"layout {layout} needs {math.prod(layout)} devices"
                         f" but mesh has {mesh.size}")
    return make_dpc_mesh(layout, device=mesh.device)


def make_smoke_mesh(n: int | None = None, device=None) -> Mesh:
    """Whatever this job has (tests / examples): (1, n) over ("data",
    "model"), n the world size by default."""
    n = n or _world()
    shape = (1, n) if n > 1 else (1, 1)
    return Mesh(shape, ("data", "model"), device)


def join_torchrun(device):
    """Initialise the default process group from `torchrun`'s environment
    when it names more than one rank and none is initialised yet: NCCL with
    card LOCAL_RANK when each rank has a card, gloo otherwise (ranks
    sharing one card, or the CPU).  Returns the device this rank runs on."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1 or dist.is_initialized():
        return device
    local = int(os.environ.get("LOCAL_RANK", "0"))
    backend = "gloo"
    if device.type == "cuda" and torch.cuda.device_count() >= world:
        backend, device = "nccl", torch.device("cuda", local)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method="env://")
    return device

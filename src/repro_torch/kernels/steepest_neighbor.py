"""Wrapper of the CUDA steepest-neighbor stencil (`csrc/steepest_neighbor.cu`;
replaces the Pallas TPU kernel
`repro/kernels/steepest_neighbor.py::steepest_neighbor`).

For each voxel of an (X, Y, Z) int32 order field: the global flat id of the
largest-order vertex among the voxel and its 6/14/18/26 neighbours, self
first, strict ``>`` (the first maximum wins).  The kernel is a 2.5-D
streaming stencil: CTAs march along x through tiles of 16 y-rows by 128 z
held in a ring of planes in shared memory; it takes any extents and any
base alignment.  The plain version is `ref.steepest_neighbor_ref`;
`ops.steepest_neighbor` dispatches between the two by the tensor's device.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.steepest import neighbor_offsets
from . import _build
from .fused_local_phase import KERNEL_CONNECTIVITIES

# launches of the kernel, by connectivity; only `steepest_neighbor` adds
launches = {c: 0 for c in KERNEL_CONNECTIVITIES}

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3 + [
    ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p]


def steepest_neighbor(order: torch.Tensor, connectivity: int = 6):
    """Launch the CUDA kernel on `order`'s device and current stream.

    order: contiguous (X, Y, Z) int32 CUDA tensor.  Returns (X, Y, Z) int32
    flat ids.  Raises ValueError on a 2-D field or a connectivity without a
    3-D offset table (`ops.steepest_neighbor` sends those to `grid_steepest`,
    as the JAX dispatch does), and on grids of 2**31 voxels or more, whose
    ids the reference's int32 output cannot hold.
    """
    if order.ndim != 3:
        raise ValueError(
            f"steepest_neighbor is a 3-D kernel; got a {order.ndim}-D field "
            f"of shape {tuple(order.shape)} - repro_torch.kernels.ops "
            "dispatches such inputs to the grid_steepest fallback")
    if connectivity not in KERNEL_CONNECTIVITIES:
        raise ValueError(
            f"steepest_neighbor: connectivity {connectivity} has no 3-D "
            "offset table; repro_torch.kernels.ops dispatches it to the "
            "grid_steepest fallback")
    _build.check_tensor(order, "order", (torch.int32,))
    if order.numel() >= 2**31:
        raise ValueError("steepest_neighbor returns int32 ids and cannot "
                         "address 2**31 or more voxels")
    out = torch.empty_like(order)
    x, y, z = order.shape
    # the kernel's offsets are compile-time constants; it refuses a table
    # other than this one, whose order decides ties
    offs = [c for off in neighbor_offsets(3, connectivity) for c in off]
    fn = _build.entry("steepest_neighbor", "steepest_neighbor", _ARGTYPES)
    with torch.cuda.device(order.device):
        err = fn(order.data_ptr(), out.data_ptr(), x, y, z,
                 (ctypes.c_int * len(offs))(*offs), connectivity,
                 _build.stream(order))
    _build.raise_on_error("steepest_neighbor", err)
    launches[connectivity] += 1
    return out

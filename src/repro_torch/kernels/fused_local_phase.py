"""Wrapper of the CUDA kernel for the fused block-local phase
(`csrc/fused_local_phase.cu`; replaces the Pallas TPU kernel
`repro/kernels/fused_local_phase.py::fused_local_phase`).

Per `block_x`-plane x-slab of an (X, Y, Z) field the kernel computes the
pointer init (steepest argmax, ``mode="manifold"``, or largest masked
neighbor id, ``mode="cc"``), applies the optional `self_mask` override, and
resolves every chain confined to the slab in one pass, counting its hops.
It returns the pointers of the TPU kernel's in-slab pointer doubling, bit for
bit, and its round count, 1 + ceil(log2(longest chain's hops)).  The plain
version is `ref.fused_local_phase_ref`; `ops.fused_local_phase` dispatches
between the two by the tensor's device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core.steepest import id_dtype_for, neighbor_offsets
from . import _build

KERNEL_CONNECTIVITIES = (6, 14, 18, 26)
_MODES = {"manifold": 0, "cc": 1}
# voxels of one slab, exclusive (int32 local indices); checked here only,
# before the scratch size is asked for
MAX_SLAB = 2**31

# launches of the kernel, by mode; only `fused_local_phase` below adds to it
launches = {"manifold": 0, "cc": 0}

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
    ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p,
    ctypes.POINTER(ctypes.c_int)]


@functools.cache
def _entry(id_dtype):
    return _build.entry("fused_local_phase",
                        "fused_local_phase_i32" if id_dtype == torch.int32
                        else "fused_local_phase_i64", _ARGTYPES)


@functools.cache
def _scratch_entry():
    fn = _build.load("fused_local_phase").fused_local_phase_scratch_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_int64
    return fn


def _scratch_bytes(x, y, z, block_x) -> int:
    """Bytes of scratch a launch takes: the 8-byte words, the bitmap of
    voxels whose chains leave their brick, and the device int for max H."""
    return _scratch_entry()(x, y, z, block_x)


def fused_local_phase(field: torch.Tensor, connectivity: int = 6,
                      mode: str = "manifold", self_mask=None,
                      block_x: int = 8, id_dtype=None):
    """Launch the CUDA kernel on `field`'s device and current stream.

    field: contiguous (X, Y, Z) CUDA tensor, int32 order (manifold) or bool
    mask (cc).  self_mask: None or a bool tensor of the same shape.  Returns
    ((X, Y, Z) pointers of `id_dtype`, default int32 unless n >= 2**31;
    rounds as an int).  Raises on anything the kernel does not take and on
    any CUDA error the launch reports.
    """
    if mode not in _MODES:
        raise ValueError(f"mode must be 'manifold' or 'cc', got {mode!r}")
    if field.ndim != 3:
        raise ValueError(f"fused_local_phase is a 3-D x-slab kernel; got a "
                         f"{field.ndim}-D field of shape {tuple(field.shape)}")
    if connectivity not in KERNEL_CONNECTIVITIES:
        raise ValueError(f"fused_local_phase supports 3-D connectivities "
                         f"{KERNEL_CONNECTIVITIES}, got {connectivity}")
    if block_x < 1:
        raise ValueError(f"block_x must be >= 1, got {block_x}")
    x, y, z = field.shape
    if min(block_x, x) * y * z >= MAX_SLAB:
        raise ValueError(f"a slab of min(block_x, X) * Y * Z = "
                         f"{min(block_x, x) * y * z} voxels: the kernel's "
                         f"slab-local indices need fewer than 2**31")
    _build.check_tensor(field, "field", (torch.int32,) if mode == "manifold"
                        else (torch.bool,))
    if self_mask is not None:
        _build.check_tensor(self_mask, "self_mask", (torch.bool,), field.shape)
        if self_mask.device != field.device:
            raise ValueError("self_mask must be on the field's device")
    if id_dtype is None:
        id_dtype = id_dtype_for(field.numel())
    if id_dtype not in (torch.int32, torch.int64):
        raise ValueError(f"id_dtype must be int32 or int64, got {id_dtype}")
    if id_dtype == torch.int32 and field.numel() >= 2**31:
        raise ValueError("int32 ids cannot address 2**31 or more vertices")

    out = torch.empty(field.shape, dtype=id_dtype, device=field.device)
    scratch = torch.empty(_scratch_bytes(x, y, z, block_x) // 8,
                          dtype=torch.int64, device=field.device)
    offs = [c for off in neighbor_offsets(3, connectivity) for c in off]
    offsets = (ctypes.c_int * len(offs))(*offs)
    rounds = ctypes.c_int(0)
    fn = _entry(id_dtype)
    with torch.cuda.device(field.device):
        err = fn(field.data_ptr(),
                 None if self_mask is None else self_mask.data_ptr(),
                 out.data_ptr(), scratch.data_ptr(),
                 _MODES[mode], x, y, z, block_x, offsets,
                 len(offs) // 3, _build.stream(field), ctypes.byref(rounds))
    _build.raise_on_error("fused_local_phase", err)
    launches[mode] += 1
    return out, rounds.value

"""Wrapper of the CUDA sum EmbeddingBag (`csrc/segment_bag.cu`; replaces the
Pallas TPU kernel `repro/kernels/segment_bag.py::segment_bag`).

For each bag of a (B, L) id array, the sum of the table rows of its ids in
[0, V) (-1 pads and other ids outside the table add nothing), accumulated
in fp32 and cast to the table's dtype.  The plain version is
`ref.segment_bag_ref`; `ops.embedding_bag` dispatches between the two by the
tensor's device.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

TABLE_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
ID_DTYPES = {torch.int32: "i32", torch.int64: "i64"}

# launches of the kernel, by table dtype; only `segment_bag` adds to it
launches = {"float32": 0, "bfloat16": 0}

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int,
                                     ctypes.c_int64, ctypes.c_int,
                                     ctypes.c_void_p]


def segment_bag(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the table's device and current stream.

    table: contiguous (V, D) float32 or bfloat16 CUDA tensor; ids:
    contiguous (B, L) int32 or int64 tensor on the same device.  Returns
    the (B, D) bag sums in the table's dtype.
    """
    if table.ndim != 2 or ids.ndim != 2:
        raise ValueError(f"table must be (V, D) and ids (B, L); got "
                         f"{tuple(table.shape)} and {tuple(ids.shape)}")
    _build.check_tensor(table, "table", tuple(TABLE_DTYPES))
    _build.check_tensor(ids, "ids", tuple(ID_DTYPES))
    if ids.device != table.device:
        raise ValueError("ids must be on the table's device")
    (v, d), (b, l) = table.shape, ids.shape
    if d >= 2**31 or l >= 2**31:
        raise ValueError("D and L must be below 2**31")
    out = torch.empty((b, d), dtype=table.dtype, device=table.device)
    fn = _build.entry("segment_bag", f"segment_bag_{TABLE_DTYPES[table.dtype]}"
                      f"_{ID_DTYPES[ids.dtype]}", _ARGTYPES)
    with torch.cuda.device(table.device):
        err = fn(table.data_ptr(), ids.data_ptr(), out.data_ptr(), v, d, b, l,
                 _build.stream(table))
    _build.raise_on_error("segment_bag", err)
    if b and d:                 # else the kernel returns at once
        launches[str(table.dtype).removeprefix("torch.")] += 1
    return out

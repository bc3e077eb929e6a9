"""Wrapper of the CUDA tile-confined pointer doubling
(`csrc/block_pathcompress.cu`; replaces the Pallas TPU kernel
`repro/kernels/block_pathcompress.py::block_pathcompress`).

`rounds` synchronous rounds of ``d <- d[d]``, each confined to a tile of
``min(block, next_pow2(n))`` pointers (`ref.snapped_block`); negative and
out-of-tile pointers are fixed points, and the tail past n reads as the -1
sentinel.  The kernel has two launch configurations: the tiles in shared
memory when two tiles fit in a block's 227 KB (persistent CTAs stream the
tiles through a ring of stages filled by bulk copies, every round in
shared memory, one launch a call, any base alignment), else one launch per
round over device memory.  The plain version is
`ref.block_pathcompress_kernel_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import snapped_block

SHARED_BYTES = 232448      # sm_90's opt-in shared memory per block

# kernel launches, by configuration; only `block_pathcompress` adds to it:
# 1 a call in the shared configuration, `rounds` (one launch a round) in
# the global one
launches = {"shared": 0, "global": 0}

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 + [ctypes.c_int] * 2 + [
    ctypes.c_void_p]


def configuration(block: int, dtype: torch.dtype) -> str:
    """"shared" when two tiles of `block` ids fit in a block's shared
    memory (the streaming kernel), else "global"."""
    return "shared" if 2 * block * dtype.itemsize <= SHARED_BYTES else "global"


def block_pathcompress(d: torch.Tensor, rounds: int = 4, block: int = 4096):
    """Launch the CUDA kernel on `d`'s device and current stream.

    d: contiguous (N,) int32 or int64 CUDA tensor of pointers (-1 for none).
    Returns a new tensor of the same shape and dtype; `d` is not changed.
    """
    if d.ndim != 1:
        raise ValueError(f"d must be 1-D, got shape {tuple(d.shape)}")
    if rounds < 0:
        raise ValueError(f"rounds must be >= 0, got {rounds}")
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    _build.check_tensor(d, "d", (torch.int32, torch.int64))
    n = d.numel()
    block = snapped_block(n, block)
    config = configuration(block, d.dtype)
    out = torch.empty_like(d)
    scratch = (torch.empty_like(d) if config == "global" and rounds > 1
               else None)
    fn = _build.entry("block_pathcompress", "block_pathcompress_i32"
                      if d.dtype == torch.int32 else "block_pathcompress_i64",
                      _ARGTYPES)
    with torch.cuda.device(d.device):
        err = fn(d.data_ptr(), out.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), n, block,
                 rounds, int(config == "shared"), _build.stream(d))
    _build.raise_on_error("block_pathcompress", err)
    if n and rounds:            # else the kernel copies or returns at once
        launches[config] += 1 if config == "shared" else rounds
    return out

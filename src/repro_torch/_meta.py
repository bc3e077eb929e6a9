"""Shape-only runs of the port on the meta device, the counterpart of JAX's
`jax.eval_shape` and of XLA's cost analysis (`launch.dryrun`).

A meta tensor has a shape and a dtype and no values, so a step traced on
meta tensors allocates nothing and reads nothing back.  Three things the
eager port does need values for, and this module gives each its meta rule:

  * a fixpoint loop's host read of its "changed" flag (`again`): on meta
    the loop runs its body once, as XLA costs a `while` body once, so the
    DPC terms of a dry run are per doubling round;
  * a compaction whose length depends on the data (`nonzero`, `select`,
    `read_int`): on meta every element is kept, the most the data could
    need;
  * the kernels (`kernels.ops`): on meta each returns outputs of its
    shapes and dtypes and adds its FLOPs and bytes to the active count.

The counts (`counting`) also take the collectives that
`runtime.meshctx.Mesh` and `core.distributed.DPCMesh` issue, by their
result-shape bytes under JAX's keys.  Outside `counting` nothing is
counted; on real tensors every rule here is the plain host read.
"""
from __future__ import annotations

import contextlib

import torch

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")

_active: list = []


def is_meta(t) -> bool:
    return isinstance(t, torch.Tensor) and t.is_meta


def again(flag) -> bool:
    """Whether a fixpoint loop runs another round: the host read of the
    0-d bool `flag`; False for a meta tensor (the body runs once)."""
    if is_meta(flag):
        return False
    return bool(flag)


def read_int(t, meta_value: int = 0) -> int:
    """The host read of a 0-d integer tensor; `meta_value` on meta."""
    if is_meta(t):
        return meta_value
    return int(t)


def nonzero(mask: torch.Tensor) -> torch.Tensor:
    """Flat int64 indices of the true entries of `mask`; on meta every
    index (the longest result the data could give)."""
    if mask.is_meta:
        return torch.arange(mask.numel(), device=mask.device)
    return mask.reshape(-1).nonzero().reshape(-1)


def select(t: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``t[mask]``; on meta every element of `t`, flat."""
    if mask.is_meta or t.is_meta:
        return t.reshape(-1)
    return t[mask]


def cumsum(t: torch.Tensor, dtype) -> torch.Tensor:
    """``torch.cumsum(t, 0, dtype=dtype)``; on meta an empty tensor of its
    shape (torch's meta cumsum builds an (n, n) mask and overflows past
    2**31.5 elements)."""
    if t.is_meta:
        return torch.empty(t.shape, dtype=dtype, device=t.device)
    return torch.cumsum(t, 0, dtype=dtype)


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Counts:
    """What ran under one `counting()`: the collectives (JAX's keys:
    result-shape bytes per kind, `n_collectives`, `total`) and the kernels'
    meta branches (FLOPs, bytes read once and written once, and calls by
    kernel)."""

    def __init__(self):
        self.collective_bytes = {k: 0 for k in COLLECTIVE_KINDS}
        self.n_collectives = 0
        self.kernel_flops = 0.0
        self.kernel_bytes = 0.0
        self.kernel_calls: dict = {}

    @property
    def collectives(self) -> dict:
        out = dict(self.collective_bytes)
        out["n_collectives"] = self.n_collectives
        out["total"] = sum(self.collective_bytes.values())
        return out


@contextlib.contextmanager
def counting():
    """Count the collectives and the kernels' meta branches of the block:
    yields a `Counts` (nested blocks each count everything inside them)."""
    c = Counts()
    _active.append(c)
    try:
        yield c
    finally:
        _active.remove(c)


def add_collective(kind: str, nbytes_: int) -> None:
    """A collective of `kind` whose result has `nbytes_` bytes on this
    rank (JAX's `collective_bytes` rule: the result shape, counted once)."""
    for c in _active:
        c.collective_bytes[kind] += int(nbytes_)
        c.n_collectives += 1


def add_kernel(name: str, flops: float, nbytes_: float) -> None:
    """A kernel's meta branch: its FLOPs and the bytes it must move."""
    for c in _active:
        c.kernel_flops += float(flops)
        c.kernel_bytes += float(nbytes_)
        c.kernel_calls[name] = c.kernel_calls.get(name, 0) + 1


# --- the five kernels on meta tensors ---------------------------------------
#
# Each returns outputs of the kernel's shapes and dtypes (and allocates what
# the CUDA wrapper allocates for the launch) and counts the kernel's
# operations and bytes: PERF.md section 6's bounds, each input read once and
# each output written once.


def fused_local_phase(field, connectivity, mode, self_mask, id_dtype):
    """(pointers, 1): one round is costed."""
    n = field.numel()
    out = torch.empty(field.shape, dtype=id_dtype, device=field.device)
    # the wrapper's scratch: 8-byte words a voxel and a bit a voxel
    scratch = torch.empty((8 * n + (n + 31) // 32 * 4 + 11) // 8,
                          dtype=torch.int64, device=field.device)
    del scratch
    moved = nbytes(field) + nbytes(out) + (
        self_mask.numel() if self_mask is not None else 0)
    add_kernel(f"fused_local_phase/{mode}", n * (connectivity + 1), moved)
    return out, 1


def steepest_neighbor(order, connectivity):
    out = torch.empty_like(order, dtype=torch.int32)
    add_kernel("steepest_neighbor", order.numel() * (connectivity + 1),
               nbytes(order) + nbytes(out))
    return out


def block_pathcompress(d, rounds):
    out = torch.empty_like(d)
    add_kernel("block_pathcompress", d.numel() * rounds,
               nbytes(d) + nbytes(out))
    return out


def visible_pairs(sq: int, sk: int, causal: bool) -> int:
    """Query-key pairs a row sees: all, or under the bottom-right causal
    mask (row i sees keys up to i + sk - sq)."""
    if not causal:
        return sq * sk
    shift = sk - sq
    full = max(0, min(sq, -shift))            # rows that see no key
    rows = sq - full
    first = max(shift + full + 1, 0)          # keys the first such row sees
    last = min(shift + sq, sk)
    return rows * (first + last) // 2 if rows else 0


def flash_attention(q, k, v, causal):
    b, h, sq, d = q.shape
    out = torch.empty_like(q)
    flops = 4 * b * h * d * visible_pairs(sq, k.shape[2], causal)
    add_kernel(f"flash_attention/{str(q.dtype).split('.')[-1]}", flops,
               nbytes(q) + nbytes(k) + nbytes(v) + nbytes(out))
    return out


def segment_bag(table, ids):
    b, l = ids.shape
    d = table.shape[1]
    out = torch.empty((b, d), dtype=table.dtype, device=table.device)
    rows = min(b * l, table.shape[0])         # each distinct row once
    add_kernel(f"segment_bag/{str(table.dtype).split('.')[-1]}", b * l * d,
               nbytes(ids) + rows * d * table.element_size() + nbytes(out))
    return out


"""Plain PyTorch versions of the port's kernels: what the CPU runs, and what
`chip_smoke.py` holds each CUDA kernel against on the card."""
from __future__ import annotations

import torch

from ..core.steepest import grid_mask_argmax, grid_steepest, id_dtype_for


def max_saturation_rounds(tsize: int) -> int:
    """Round cap of the in-tile saturation: a chain fits in the tile, so
    doubling resolves it in ceil(log2(tsize)) rounds, plus the final
    no-change verification round."""
    return max((tsize - 1).bit_length(), 1) + 1


def local_phase_init(field: torch.Tensor, connectivity: int, mode: str,
                     self_mask=None, id_dtype=None) -> torch.Tensor:
    """The pointer init of the block-local phase, flat: steepest argmax
    (manifold) or largest masked neighbor id (cc), then the `self_mask`
    override ((masked) vertices point at themselves)."""
    if mode == "manifold":
        d = grid_steepest(field, connectivity)
    elif mode == "cc":
        d = grid_mask_argmax(field, connectivity)
    else:
        raise ValueError(f"mode must be 'manifold' or 'cc', got {mode!r}")
    d = d.to(id_dtype_for(field.numel()) if id_dtype is None else id_dtype)
    if self_mask is not None:
        keep = self_mask.reshape(-1).bool()
        if mode == "cc":
            keep = keep & (field.reshape(-1) != 0)
        ids = torch.arange(field.numel(), dtype=d.dtype, device=d.device)
        d = torch.where(keep, ids, d)
    return d


def fused_local_phase_ref(field: torch.Tensor, connectivity: int,
                          mode: str = "manifold", self_mask=None,
                          block_x: int = 8, id_dtype=None):
    """Plain version of the fused block-local kernel
    (`repro/kernels/fused_local_phase.py::fused_local_phase`): the pointer
    init (steepest argmax / largest masked neighbor id), the optional
    `self_mask` override, then pointer doubling confined to each
    `block_x`-plane x-slab, counting rounds as the kernel's while loop does.

    All slabs double together, one synchronous round at a time, until a round
    changes nothing anywhere.  A converged slab is a fixed point of further
    rounds and every slab has the same round cap, so the number of rounds
    run is the max over slabs of each slab's own count, which is what the
    TPU kernel reports.  Returns ((X, Y, Z) pointers, rounds as an int).
    """
    n = field.numel()
    row = n // field.shape[0] if field.shape[0] else 0
    d = local_phase_init(field, connectivity, mode, self_mask, id_dtype)
    ids = torch.arange(n, dtype=d.dtype, device=d.device)
    tsize = block_x * row
    max_rounds = max_saturation_rounds(tsize)
    lo = ids // tsize * tsize          # first id of each vertex's slab
    rounds, changed = 0, True
    while changed and rounds < max_rounds:
        # pointers that are negative or leave the slab are fixed points
        # (d - lo, not lo + tsize: the latter can pass the int32 range)
        in_tile = (d >= lo) & (d - lo < tsize)
        nxt = torch.where(in_tile, d.index_select(0, d.clamp(min=0)), d)
        changed = bool((nxt != d).any())
        d, rounds = nxt, rounds + 1
    return d.reshape(field.shape), rounds

"""Steepest-neighbor initialisation on structured grids (port of
`repro/core/steepest.py`, paper Alg. 1 lines 3-5, Alg. 3 line 6).

`descending=True` points each vertex at its largest-order neighbor (steepest
ascent -> descending manifold terminating in maxima); `descending=False`
flips the order field (steepest descent -> ascending manifold / minima).
A vertex larger than all its neighbors points at itself (root).

The offset tables are a copy of the JAX package's, in the same order: the
candidate order decides ties.  The graph variants come with the graph
slice of the port.
"""
from __future__ import annotations

import torch

# --- neighborhood offset tables -------------------------------------------

_OFF_2D_4 = [(1, 0), (-1, 0), (0, 1), (0, -1)]
# Freudenthal triangulation of a 2D grid: axis edges + one diagonal
_OFF_2D_6 = _OFF_2D_4 + [(1, 1), (-1, -1)]
_OFF_3D_6 = [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)]
# Kuhn/Freudenthal 3D: all nonzero {0,1}^3 offsets and their negatives
_OFF_3D_14 = _OFF_3D_6 + [
    (1, 1, 0), (-1, -1, 0), (0, 1, 1), (0, -1, -1),
    (1, 0, 1), (-1, 0, -1), (1, 1, 1), (-1, -1, -1),
]
# full digital-topology neighborhoods: 26 = every nonzero {-1,0,1}^3 offset,
# 18 = the subset sharing a face or an edge (no corner diagonals)
_OFF_3D_26 = [(i, j, k)
              for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)
              if (i, j, k) != (0, 0, 0)]
_OFF_3D_18 = [off for off in _OFF_3D_26 if sum(abs(o) for o in off) <= 2]


def neighbor_offsets(ndim: int, connectivity: int):
    table = {
        (1, 2): [(1,), (-1,)],
        (2, 4): _OFF_2D_4,
        (2, 6): _OFF_2D_6,
        (3, 6): _OFF_3D_6,
        (3, 14): _OFF_3D_14,
        (3, 18): _OFF_3D_18,
        (3, 26): _OFF_3D_26,
    }
    key = (ndim, connectivity)
    if key not in table:
        raise ValueError(f"unsupported (ndim, connectivity)={key}")
    return table[key]


def id_dtype_for(n: int) -> torch.dtype:
    """Flat ids are int32 unless the grid has 2**31 vertices or more."""
    return torch.int32 if n < 2**31 else torch.int64


def shift_fill(a: torch.Tensor, off, fill) -> torch.Tensor:
    """result[p] = a[p + off], `fill` outside the domain."""
    out = torch.full_like(a, fill)
    dst, src = [], []
    for o, s in zip(off, a.shape):
        if abs(o) >= s:
            return out
        dst.append(slice(max(-o, 0), s - max(o, 0)))
        src.append(slice(max(o, 0), s - max(-o, 0)))
    out[tuple(dst)] = a[tuple(src)]
    return out


# --- structured grids -------------------------------------------------------


def grid_steepest(order: torch.Tensor, connectivity: int = 6,
                  descending: bool = True, id_offset=0) -> torch.Tensor:
    """Pointer init on a structured grid.

    Args:
      order: integer order field (any shape, unique values).
      id_offset: added to the returned flat indices.

    Returns flat pointer array of `order.numel()` ids (self for local
    extrema), int32 unless n >= 2**31.
    """
    key = order if descending else -order
    n = order.numel()
    dtype = id_dtype_for(n)
    idx = (torch.arange(n, dtype=dtype, device=order.device)
           + id_offset).reshape(order.shape)
    fill_key = torch.iinfo(key.dtype).min
    # A strict-> chain with self first picks the FIRST maximum among
    # (self, offsets...), which is jnp.argmax's tie rule over JAX's stacked
    # candidates; the chain holds two arrays instead of 2*(K+1).
    best_val, best_idx = key, idx
    for off in neighbor_offsets(order.ndim, connectivity):
        cand = shift_fill(key, off, fill_key)
        better = cand > best_val
        best_val = torch.where(better, cand, best_val)
        best_idx = torch.where(better, shift_fill(idx, off, -1), best_idx)
    return best_idx.reshape(-1)


def grid_mask_argmax(mask: torch.Tensor, connectivity: int = 6,
                     id_offset=0) -> torch.Tensor:
    """Pointer init for connected components (Alg. 3 line 6): largest masked
    neighbor id (including self); -1 for unmasked vertices."""
    n = mask.numel()
    dtype = id_dtype_for(n)
    idx = (torch.arange(n, dtype=dtype, device=mask.device)
           + id_offset).reshape(mask.shape)
    m = mask.bool()
    key = torch.where(m, idx, -1)
    best = key
    for off in neighbor_offsets(mask.ndim, connectivity):
        best = torch.maximum(best, shift_fill(key, off, -1))
    return torch.where(m, best, -1).reshape(-1)

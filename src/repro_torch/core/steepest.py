"""Steepest-neighbor initialisation on structured grids (port of
`repro/core/steepest.py`, paper Alg. 1 lines 3-5, Alg. 3 line 6).

`descending=True` points each vertex at its largest-order neighbor (steepest
ascent -> descending manifold terminating in maxima); `descending=False`
flips the order field (steepest descent -> ascending manifold / minima).
A vertex larger than all its neighbors points at itself (root).

Two mesh regimes, as in JAX: structured grids (stencil shifts over the
axis/Freudenthal neighborhood) and unstructured graphs (edge lists and a
segment max by sender).  The offset tables are a copy of the JAX package's,
in the same order: the candidate order decides ties.
"""
from __future__ import annotations

import torch

from .ids import inverse_permutation

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


# --- unstructured graphs ----------------------------------------------------
#
# Edge ids follow JAX's index rules, so an id outside [0, n) gives what it
# gives there: a gather (`key[receivers]`, `mask[senders]`) wraps a negative
# id once and clamps the result to [0, n - 1]; `segment_max` drops an edge
# whose sender lies outside [0, n).  The ids are checked once a call (one
# host read) and copied only when one is out of range.
#
# The segment max runs as `index_reduce_(..., "amax", include_self=True)`
# into a copy of the vertex's own value, which takes int32 ids: no int64
# copy of the edge list (1.87 GB at 233 M edges) is made.


def gather_ids(ids: torch.Tensor, n: int) -> torch.Tensor:
    """`ids` as JAX's gather reads them from an axis of n: negative ids wrap
    once (+n), then every id is clamped to [0, n - 1].  Returns `ids` itself
    when all are in range.  n must be > 0."""
    if ids.numel() == 0 or ids.is_meta:     # meta: no values to check
        return ids
    lo, hi = (int(v) for v in torch.aminmax(ids))
    if lo >= 0 and hi < n:
        return ids
    return torch.where(ids < 0, ids + n, ids).clamp_(0, n - 1)


def compact(keep: torch.Tensor | None, *edges: torch.Tensor):
    """The edges where `keep` holds (all of them, uncopied, where `keep` is
    None or all true, or on the meta device)."""
    if keep is None or keep.is_meta or bool(keep.all()):
        return edges
    return tuple(e.masked_select(keep) for e in edges)


def graph_edges(senders: torch.Tensor, receivers: torch.Tensor, n: int):
    """(gather senders, gather receivers, segment ok): both id lists as
    `gather_ids` reads them, and the bool mask of edges whose sender is a
    segment id in [0, n) (None when all are).  A graph of 0 vertices takes
    no edge: JAX's gather from an empty axis raises too."""
    if n == 0:
        if senders.numel() or receivers.numel():
            raise ValueError("a graph of 0 vertices has no edge to gather")
        return senders, receivers, None
    gs = gather_ids(senders, n)
    seg_ok = None if gs is senders else (senders >= 0) & (senders < n)
    return gs, gather_ids(receivers, n), seg_ok


def segment_max_into(out: torch.Tensor, segments: torch.Tensor,
                     values: torch.Tensor) -> torch.Tensor:
    """out[s] = max(out[s], every value whose segment is s), in place; the
    segment ids must lie in [0, out.numel())."""
    return out.index_reduce_(0, segments, values, "amax", include_self=True)


def graph_steepest(order: torch.Tensor, senders: torch.Tensor,
                   receivers: torch.Tensor,
                   descending: bool = True) -> torch.Tensor:
    """Pointer init on an edge-list graph (directed edges sender->receiver;
    pass both directions for undirected meshes).

    order must be a permutation of [0, n) so that the max order value can be
    inverted back to a vertex id.  A vertex with no neighbor above it
    (none at all included) points at itself.
    """
    n = order.shape[0]
    key = order if descending else (n - 1 - order)
    inv = inverse_permutation(key)
    gs, gr, seg_ok = graph_edges(senders, receivers, n)
    seg, recv = compact(seg_ok, gs, gr)
    neigh_max = segment_max_into(key.clone(), seg, key.index_select(0, recv))
    ids = torch.arange(n, dtype=torch.int32, device=order.device)
    # neigh_max is a vertex's own key or a neighbor's: in [0, n) for a
    # permutation (the clamp only keeps any other input off the card's
    # bounds check, as JAX's gather clamps)
    up = inv.index_select(0, neigh_max.clamp(0, max(n - 1, 0)))
    return torch.where(neigh_max > key, up, ids)


def graph_mask_argmax_pairs(mask: torch.Tensor, senders: torch.Tensor,
                            receivers: torch.Tensor,
                            ghost=None) -> torch.Tensor:
    """`graph_mask_argmax` over edges already cut to those with both ends
    masked and a sender in [0, n), ids in range."""
    n = mask.shape[0]
    m = mask.bool()
    ids = torch.arange(n, dtype=torch.int32, device=mask.device)
    key = torch.where(m, ids, -1)
    best = segment_max_into(key.clone(), senders,
                            key.index_select(0, receivers))
    out = torch.where(m, best, -1)
    if ghost is not None:
        out = torch.where(ghost.bool() & m, ids, out)
    return out


def graph_mask_argmax(mask: torch.Tensor, senders: torch.Tensor,
                      receivers: torch.Tensor,
                      ghost: torch.Tensor | None = None) -> torch.Tensor:
    """CC pointer init on an edge-list graph; -1 for unmasked vertices.
    Edges incident to unmasked vertices are ignored (paper Alg. 3).

    An edge counts where `mask[sender] & mask[receiver]` is nonzero, the
    bitwise and of JAX: an integer mask of 1 and 2 does not join them, and
    a floating mask raises TypeError, as it does there.

    `ghost` (optional bool array) marks one-ring ghost vertices of a
    distributed vertex partition: masked ghosts pretend to be roots (point
    to themselves), their true pointer resolved later through the gathered
    boundary table.  Owned vertices may still point *at* a ghost.
    """
    if mask.is_floating_point() or mask.is_complex():
        raise TypeError(f"graph_mask_argmax takes a bool or integer mask, "
                        f"not {mask.dtype}: JAX's bitwise and refuses it")
    n = mask.shape[0]
    gs, gr, seg_ok = graph_edges(senders, receivers, n)
    both = (mask.index_select(0, gs) & mask.index_select(0, gr)) != 0
    if seg_ok is not None:
        both &= seg_ok
    return graph_mask_argmax_pairs(mask, *compact(both, gs, gr), ghost=ghost)

"""Connected components via path compression (port of
`repro/core/connected_components.py`, paper Alg. 3).

Pointer init: largest masked neighbor id (incl. self); unmasked vertices are
labeled -1 and excluded.  After a first compression, sub-segments (one per
local id-maximum) are merged by the *stitch* pass
    d[d[v]] <- max over masked neighbors u of d[u]
followed by another compression, iterated to a fixpoint (deviation (d) in
DESIGN.md).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .._meta import again, select
from .pathcompress import path_compress
from .steepest import (compact, graph_edges, graph_mask_argmax,
                       graph_mask_argmax_pairs, neighbor_offsets,
                       segment_max_into, shift_fill)


class CCResult(NamedTuple):
    labels: torch.Tensor   # largest vertex id of the component; -1 unmasked
    n_rounds: int          # stitch rounds executed
    n_compress_iter: int


def _grid_stitch(d: torch.Tensor, mask_flat: torch.Tensor, shape,
                 connectivity: int) -> torch.Tensor:
    """One stitch pass (Alg. 3 lines 25-29) on a structured grid, as a
    scatter-max: for each directed neighbor pair (v, u) with both masked,
    d[d[v]] <- max(d[d[v]], d[u]).

    JAX scatters every pair and drops the out-of-range index n it gives the
    invalid ones (`mode="drop"`).  Here the invalid pairs are dropped before
    the scatter.  Scattering them into an extra slot n instead sends about
    90% of all updates under a top-10% mask to that one address: 3.6 s per
    cc query at 512^3 on an H100 (PERF.md)."""
    d_grid = d.reshape(shape)
    m_grid = mask_flat.reshape(shape)
    out = d.clone()
    for off in neighbor_offsets(len(shape), connectivity):
        valid = mask_flat & shift_fill(m_grid, off, False).reshape(-1)
        u_label = shift_fill(d_grid, off, -1).reshape(-1)          # d[u]
        out.scatter_reduce_(0, select(d, valid).long(),
                            select(u_label, valid), "amax")
    return out


def _graph_stitch(d: torch.Tensor, senders: torch.Tensor,
                  receivers: torch.Tensor) -> torch.Tensor:
    """One stitch pass on an edge-list graph: d[d[s]] <- max(d[d[s]], d[r])
    over the edges given, which must be the query's stitch pairs (both ends
    masked, ids as JAX's gather reads them).  JAX scatters every edge and
    drops the index n it gives the others; those pairs never change between
    rounds, so `connected_components_graph` keeps only the valid ones.

    A masked pointer never points below its vertex (d[v] >= v: the init
    takes the max with self, the stitch and compression only raise it), so
    out[t] starts at d[t] >= t and a pair whose d[r] is not above d[s]
    changes nothing.  Only the others are scattered: once labels converge,
    every pair of a component names one root, and scattering them all
    would send every update to that one address (190 ms a pure-geometry
    query on a 256^3 tet mesh, PERF.md)."""
    tgt, val = d.index_select(0, senders), d.index_select(0, receivers)
    return segment_max_into(d.clone(), *compact(val > tgt, tgt, val))


def _cc_fixpoint(d0: torch.Tensor, stitch_fn, max_rounds: int = 64) -> CCResult:
    d, its = path_compress(d0)
    rounds, changed = 0, True
    while changed and rounds < max_rounds:
        compressed, it = path_compress(stitch_fn(d))
        changed = again((compressed != d).any())
        d, rounds, its = compressed, rounds + 1, its + it
    return CCResult(d, rounds, its)


def connected_components_grid(mask: torch.Tensor, connectivity: int = 6,
                              fused_impl: str = "auto") -> CCResult:
    """Mask-implicit connected components on a structured grid: non-feature
    vertices carry -1 (the paper's "implicitly thresholded grids", §5).
    fused_impl selects the pointer-init implementation
    (`kernels.ops.fused_local_phase`); labels are bit-identical across
    choices."""
    from ..kernels import ops   # lazy: the kernels import core.steepest
    mask_flat = mask.reshape(-1).bool()
    d0, _ = ops.fused_local_phase(mask, connectivity, mode="cc",
                                  impl=fused_impl)
    res = _cc_fixpoint(d0.reshape(-1), lambda d: _grid_stitch(
        d, mask_flat, mask.shape, connectivity))
    return CCResult(res.labels.reshape(mask.shape), res.n_rounds,
                    res.n_compress_iter)


def connected_components_graph(mask: torch.Tensor, senders: torch.Tensor,
                               receivers: torch.Tensor) -> CCResult:
    """Mask-implicit connected components on an edge-list graph.  Pass both
    edge directions for undirected graphs.  mask=ones labels pure geometry
    (paper: CC "computed on pure geometry without any scalar data").

    The pointer init takes JAX's bitwise `mask[s] & mask[r]` (see
    `graph_mask_argmax`), the stitch the bool mask.  With a bool mask
    and every sender in range both use the same pairs, compacted once."""
    n = mask.shape[0]
    m = mask.bool()
    gs, gr, seg_ok = graph_edges(senders, receivers, n)
    both = m.index_select(0, gs) & m.index_select(0, gr)
    pairs = compact(both, gs, gr)
    del both
    if mask.dtype == torch.bool and seg_ok is None:
        d0 = graph_mask_argmax_pairs(m, *pairs)
    else:
        d0 = graph_mask_argmax(mask, senders, receivers)
    return _cc_fixpoint(d0, lambda d: _graph_stitch(d, *pairs))


def component_sizes(labels: torch.Tensor, num_segments: int | None = None):
    """Histogram of component sizes keyed by root id (unmasked dropped)."""
    flat = labels.reshape(-1)
    # `is None`, not truthiness: num_segments=0 gives an empty histogram
    n = flat.numel() if num_segments is None else num_segments
    keep = (flat >= 0) & (flat < n)   # JAX's segment_sum drops other ids
    seg = torch.where(keep, flat, n).long()
    return torch.bincount(seg, minlength=n + 1)[:n].to(flat.dtype)

"""Morse-Smale segmentation via path compression (port of
`repro/core/ms_segmentation.py`, paper §4.2).

The descending manifold maps every vertex to the maximum its steepest-ascent
integral line terminates in; the ascending manifold symmetrically to minima.
Their product partitions the domain into the MS segmentation.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .pathcompress import path_compress
from .steepest import graph_steepest, grid_steepest, id_dtype_for


class MSSegmentation(NamedTuple):
    ascending: torch.Tensor    # flat vertex id of the reached minimum
    descending: torch.Tensor   # flat vertex id of the reached maximum
    segmentation: torch.Tensor # hash of the (asc, desc) pair, see _pair_hash
    n_iter_asc: int
    n_iter_desc: int


def _fused_init(order, connectivity, fused_impl):
    """Block-local phase through the kernels dispatch; the path_compress
    fixpoint of the (possibly pre-saturated) pointers is bit-identical to
    that of the plain grid_steepest init.  (Lazy import: the kernels
    import repro_torch.core.steepest at module load.)"""
    from ..kernels import ops
    d0, _ = ops.fused_local_phase(order, connectivity, mode="manifold",
                                  impl=fused_impl)
    return d0.reshape(-1)


def descending_manifold(order: torch.Tensor, connectivity: int = 6,
                        fused_impl: str = "auto"):
    """(flat labels: id of the maximum each vertex flows to, rounds)."""
    return path_compress(_fused_init(order, connectivity, fused_impl))


def ascending_manifold(order: torch.Tensor, connectivity: int = 6,
                       fused_impl: str = "auto"):
    # ascending = descending on the flipped order field (a monotone flip of
    # unique values keeps the argmax of grid_steepest's descending=False)
    return path_compress(_fused_init(order.numel() - 1 - order, connectivity,
                                     fused_impl))


def _pair_hash(desc, asc, n):
    """desc * n + asc in int32, wrapping as the JAX package's does with x64
    off (its default).  Injective only while n*n < 2**31, so a grid of 2**16
    or more vertices needs the (desc, asc) pair itself: count segments from
    the pair in int64, never from this hash."""
    wide = desc.to(torch.int64) * n + asc.to(torch.int64)
    return ((wide + 2**31) % 2**32 - 2**31).to(torch.int32)


def ms_segmentation(order: torch.Tensor, connectivity: int = 6,
                    fused_impl: str = "auto") -> MSSegmentation:
    desc, it_d = descending_manifold(order, connectivity, fused_impl)
    asc, it_a = ascending_manifold(order, connectivity, fused_impl)
    seg = _pair_hash(desc, asc, order.numel())
    return MSSegmentation(asc.reshape(order.shape), desc.reshape(order.shape),
                          seg.reshape(order.shape), it_a, it_d)


def ms_segmentation_graph(order: torch.Tensor, senders: torch.Tensor,
                          receivers: torch.Tensor, connectivity: int = 0
                          ) -> MSSegmentation:
    """Unstructured variant: edges as (senders, receivers) index lists."""
    del connectivity
    desc, it_d = path_compress(graph_steepest(order, senders, receivers,
                                              descending=True))
    asc, it_a = path_compress(graph_steepest(order, senders, receivers,
                                             descending=False))
    seg = _pair_hash(desc, asc, order.shape[0])
    return MSSegmentation(asc, desc, seg, it_a, it_d)


def extrema(order: torch.Tensor, connectivity: int = 6):
    """(maxima_mask, minima_mask): vertices that are their own steepest target."""
    n = order.numel()
    idx = torch.arange(n, dtype=id_dtype_for(n), device=order.device)
    maxima = grid_steepest(order, connectivity, descending=True) == idx
    minima = grid_steepest(order, connectivity, descending=False) == idx
    return maxima.reshape(order.shape), minima.reshape(order.shape)

"""Core library of the port: order field, steepest init, path compression,
Morse-Smale segmentation and connected components on structured grids.
The graph and distributed backends come in later slices of the port."""
from .ids import compute_order, inverse_permutation, flat_ids, compact_labels
from .pathcompress import (path_compress, path_compress_unrolled, jump,
                           is_converged)
from .steepest import grid_steepest, grid_mask_argmax, neighbor_offsets, \
    shift_fill
from .ms_segmentation import (ms_segmentation, descending_manifold,
                              ascending_manifold, extrema, MSSegmentation)
from .connected_components import (connected_components_grid,
                                   component_sizes, CCResult)

__all__ = [
    "compute_order", "inverse_permutation", "flat_ids", "compact_labels",
    "path_compress", "path_compress_unrolled", "jump", "is_converged",
    "grid_steepest", "grid_mask_argmax", "neighbor_offsets", "shift_fill",
    "ms_segmentation", "descending_manifold", "ascending_manifold",
    "extrema", "MSSegmentation", "connected_components_grid",
    "component_sizes", "CCResult",
]

"""Core library of the port: order field, steepest init, path compression,
Morse-Smale segmentation and connected components on structured grids and
edge-list graphs, the boundary-table machinery and run statistics of the
distributed backends, the distributed grid and graph backends over
torch.distributed (`core.distributed`, `core.distributed_graph`) with their
batched entry points, and the label-propagation baseline.  JAX's deprecated
query shims are not ported (`topology.submit` is the entry point)."""
from .ids import compute_order, inverse_permutation, flat_ids, compact_labels
from .pathcompress import (path_compress, path_compress_unrolled, jump,
                           is_converged)
from .steepest import (grid_steepest, grid_mask_argmax, graph_steepest,
                       graph_mask_argmax, neighbor_offsets, shift_fill)
from .ms_segmentation import (ms_segmentation, ms_segmentation_graph,
                              descending_manifold, ascending_manifold,
                              extrema, MSSegmentation)
from .connected_components import (connected_components_grid,
                                   connected_components_graph,
                                   component_sizes, CCResult)
from .baseline_cc import label_propagation_grid, extract_masked_edges
from .stats import DPCStats, GraphDPCStats, STAT_FIELDS, stats_as_dict
from .distributed import (BlockDecomp, DPCMesh, make_dpc_mesh,
                          distributed_manifold,
                          distributed_connected_components,
                          distributed_manifold_batch,
                          distributed_connected_components_batch)
from .distributed_graph import (GraphDecomp,
                                distributed_connected_components_graph,
                                distributed_connected_components_graph_batch,
                                assemble_graph_labels)

__all__ = [
    "compute_order", "inverse_permutation", "flat_ids", "compact_labels",
    "path_compress", "path_compress_unrolled", "jump", "is_converged",
    "grid_steepest", "grid_mask_argmax", "graph_steepest", "graph_mask_argmax",
    "neighbor_offsets", "shift_fill",
    "ms_segmentation", "ms_segmentation_graph", "descending_manifold",
    "ascending_manifold", "extrema", "MSSegmentation",
    "connected_components_grid", "connected_components_graph",
    "component_sizes", "CCResult",
    "label_propagation_grid", "extract_masked_edges",
    "DPCStats", "GraphDPCStats", "STAT_FIELDS", "stats_as_dict",
    "BlockDecomp", "DPCMesh", "make_dpc_mesh", "distributed_manifold",
    "distributed_connected_components", "distributed_manifold_batch",
    "distributed_connected_components_batch", "GraphDecomp",
    "distributed_connected_components_graph",
    "distributed_connected_components_graph_batch", "assemble_graph_labels",
]

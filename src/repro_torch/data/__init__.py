from .chains import serpentine_order, z_line_mask, z_ramp_order
from .graphs import (NeighborSampler, build_triplets, component_labels,
                     cora_like, grid_edge_list, mesh_grid_graph,
                     molecule_batch, random_csr, sampled_batch)
from .perlin import perlin_noise
from .quantile import quantile
from .tokens import TokenStream

__all__ = ["perlin_noise", "grid_edge_list", "random_csr", "quantile",
           "serpentine_order", "z_line_mask", "z_ramp_order", "TokenStream",
           "cora_like", "molecule_batch", "build_triplets", "mesh_grid_graph",
           "NeighborSampler", "sampled_batch", "component_labels"]

from .chains import serpentine_order, z_line_mask, z_ramp_order
from .graphs import grid_edge_list, random_csr
from .perlin import perlin_noise
from .quantile import quantile
from .tokens import TokenStream

__all__ = ["perlin_noise", "grid_edge_list", "random_csr", "quantile",
           "serpentine_order", "z_line_mask", "z_ramp_order", "TokenStream"]

from .chains import serpentine_order, z_line_mask, z_ramp_order
from .perlin import perlin_noise
from .quantile import quantile

__all__ = ["perlin_noise", "quantile", "serpentine_order", "z_line_mask",
           "z_ramp_order"]

from .perlin import perlin_noise
from .quantile import quantile

__all__ = ["perlin_noise", "quantile"]

"""dimenet [gnn]: n_blocks=6 d_hidden=128 n_bilinear=8 n_spherical=7
n_radial=6  [arXiv:2003.03123; unverified]
(copy of `repro/configs/dimenet.py`)"""
from repro_torch.models.gnn import DimeNetConfig
from .gnn_shapes import SHAPES, SMOKE_SHAPES  # noqa: F401

FAMILY = "gnn"


def full_config() -> DimeNetConfig:
    return DimeNetConfig(name="dimenet", n_blocks=6, d_hidden=128,
                         n_bilinear=8, n_spherical=7, n_radial=6)


def smoke_config() -> DimeNetConfig:
    return DimeNetConfig(name="dimenet-smoke", n_blocks=2, d_hidden=16,
                         n_bilinear=4, n_spherical=3, n_radial=4)

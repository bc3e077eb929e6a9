"""schnet [gnn]: n_interactions=3 d_hidden=64 rbf=300 cutoff=10
[arXiv:1706.08566; paper]
(copy of `repro/configs/schnet.py`)"""
from repro_torch.models.gnn import SchNetConfig
from .gnn_shapes import SHAPES, SMOKE_SHAPES  # noqa: F401

FAMILY = "gnn"


def full_config() -> SchNetConfig:
    return SchNetConfig(name="schnet", n_interactions=3, d_hidden=64,
                        n_rbf=300, cutoff=10.0)


def smoke_config() -> SchNetConfig:
    return SchNetConfig(name="schnet-smoke", n_interactions=2, d_hidden=16,
                        n_rbf=16, cutoff=10.0)

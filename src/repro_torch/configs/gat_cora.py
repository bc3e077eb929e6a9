"""gat-cora [gnn]: n_layers=2 d_hidden=8 n_heads=8 aggregator=attn
[arXiv:1710.10903; paper]
(copy of `repro/configs/gat_cora.py`)"""
from repro_torch.models.gnn import GATConfig
from .gnn_shapes import SHAPES, SMOKE_SHAPES  # noqa: F401

FAMILY = "gnn"


def full_config() -> GATConfig:
    return GATConfig(name="gat-cora", n_layers=2, d_hidden=8, n_heads=8,
                     d_in=1433, n_classes=7)


def smoke_config() -> GATConfig:
    return GATConfig(name="gat-cora-smoke", n_layers=2, d_hidden=4,
                     n_heads=2, d_in=16, n_classes=7)

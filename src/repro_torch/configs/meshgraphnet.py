"""meshgraphnet [gnn]: n_layers=15 d_hidden=128 aggregator=sum mlp_layers=2
[arXiv:2010.03409; unverified]
(copy of `repro/configs/meshgraphnet.py`)"""
from repro_torch.models.gnn import MGNConfig
from .gnn_shapes import SHAPES, SMOKE_SHAPES  # noqa: F401

FAMILY = "gnn"


def full_config() -> MGNConfig:
    return MGNConfig(name="meshgraphnet", n_layers=15, d_hidden=128,
                     mlp_layers=2)


def smoke_config() -> MGNConfig:
    return MGNConfig(name="meshgraphnet-smoke", n_layers=3, d_hidden=16,
                     mlp_layers=2)

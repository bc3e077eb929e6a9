"""bst [recsys]: embed_dim=32 seq_len=20 n_blocks=1 n_heads=8
mlp=1024-512-256 interaction=transformer-seq — Behavior Sequence Transformer
(Alibaba) [arXiv:1905.06874; paper]
(copy of `repro/configs/bst.py`)"""
from repro_torch.models.bst import BSTConfig

FAMILY = "recsys"

SHAPES = {
    "train_batch": {"kind": "train", "batch": 65_536},
    "serve_p99": {"kind": "serve", "batch": 512},
    "serve_bulk": {"kind": "serve", "batch": 262_144},
    "retrieval_cand": {"kind": "retrieval", "batch": 1,
                       "n_candidates": 1_000_000},
}

SMOKE_SHAPES = {
    "train_batch": {"kind": "train", "batch": 512},
    "serve_p99": {"kind": "serve", "batch": 128},
    "serve_bulk": {"kind": "serve", "batch": 1024},
    "retrieval_cand": {"kind": "retrieval", "batch": 1,
                       "n_candidates": 2048},
}


def full_config() -> BSTConfig:
    return BSTConfig(name="bst", embed_dim=32, seq_len=20, n_blocks=1,
                     n_heads=8, mlp_dims=(1024, 512, 256))


def smoke_config() -> BSTConfig:
    return BSTConfig(name="bst-smoke", embed_dim=16, seq_len=8, n_blocks=1,
                     n_heads=2, mlp_dims=(32, 16), item_vocab=1024,
                     profile_vocab=64, multihot_vocab=128, multihot_len=4)

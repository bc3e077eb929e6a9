"""minitron-8b [dense]: 32L d_model=4096 32H (GQA kv=8) d_ff=16384
vocab=256000 — pruned nemotron [arXiv:2407.14679; hf]
(copy of `repro/configs/minitron_8b.py` with torch dtypes)"""
import torch

from repro_torch.models.lm import LMConfig
from .lm_shapes import SHAPES, SMOKE_SHAPES  # noqa: F401

FAMILY = "lm"


def full_config() -> LMConfig:
    return LMConfig(
        name="minitron-8b", n_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=8, d_ff=16384, vocab=256000,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)


def smoke_config() -> LMConfig:
    return LMConfig(
        name="minitron-8b-smoke", n_layers=2, d_model=64, n_heads=16,
        n_kv_heads=4, d_ff=256, vocab=256, d_head=4, loss_chunks=2)

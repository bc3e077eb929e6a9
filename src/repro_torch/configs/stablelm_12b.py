"""stablelm-12b [dense]: 40L d_model=5120 32H (GQA kv=8) d_ff=13824
vocab=100352  [hf:stabilityai/stablelm-2-12b; hf]
(copy of `repro/configs/stablelm_12b.py` with torch dtypes)"""
import torch

from repro_torch.models.lm import LMConfig
from .lm_shapes import SHAPES, SMOKE_SHAPES  # noqa: F401

FAMILY = "lm"


def full_config() -> LMConfig:
    return LMConfig(
        name="stablelm-12b", n_layers=40, d_model=5120, n_heads=32,
        n_kv_heads=8, d_ff=13824, vocab=100352,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)


def smoke_config() -> LMConfig:
    return LMConfig(
        name="stablelm-12b-smoke", n_layers=2, d_model=64, n_heads=16,
        n_kv_heads=4, d_ff=160, vocab=128, d_head=4, loss_chunks=2)

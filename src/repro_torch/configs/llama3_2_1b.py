"""llama3.2-1b [dense]: 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256 — small llama3 [hf:meta-llama/Llama-3.2-1B; unverified]
(copy of `repro/configs/llama3_2_1b.py` with torch dtypes)"""
import torch

from repro_torch.models.lm import LMConfig
from .lm_shapes import SHAPES, SMOKE_SHAPES  # noqa: F401

FAMILY = "lm"


def full_config() -> LMConfig:
    return LMConfig(
        name="llama3.2-1b", n_layers=16, d_model=2048, n_heads=32,
        n_kv_heads=8, d_ff=8192, vocab=128256, d_head=64,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)


def smoke_config() -> LMConfig:
    return LMConfig(
        name="llama3.2-1b-smoke", n_layers=2, d_model=64, n_heads=16,
        n_kv_heads=4, d_ff=128, vocab=128, d_head=4, loss_chunks=2)

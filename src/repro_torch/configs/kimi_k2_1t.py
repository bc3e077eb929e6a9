"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) d_ff=2048
vocab=163840, MoE 384e top-8 — trillion-param MoE (paper-table)
[arXiv:2501.kimi2; unverified]
(copy of `repro/configs/kimi_k2_1t.py` with torch dtypes)"""
import torch

from repro_torch.models.lm import LMConfig, MoEConfig
from .lm_shapes import SHAPES, SMOKE_SHAPES  # noqa: F401

FAMILY = "lm"


def full_config() -> LMConfig:
    return LMConfig(
        name="kimi-k2-1t-a32b", n_layers=61, d_model=7168, n_heads=64,
        n_kv_heads=8, d_ff=2048, vocab=163840, d_head=112,
        moe=MoEConfig(n_experts=384, top_k=8, n_shared=1),
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)


def smoke_config() -> LMConfig:
    return LMConfig(
        name="kimi-k2-1t-smoke", n_layers=2, d_model=64, n_heads=16,
        n_kv_heads=4, d_ff=32, vocab=128, d_head=4,
        moe=MoEConfig(n_experts=16, top_k=2, n_shared=1), loss_chunks=2)

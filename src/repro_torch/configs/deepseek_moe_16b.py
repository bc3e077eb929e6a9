"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=102400, MoE 64e top-6 — 2 shared + 64 routed top-6, fine-grained
[arXiv:2401.06066; hf].  All layers are MoE (the HF model's dense first
layer is folded into the shared experts — DESIGN.md §Arch-applicability).
(copy of `repro/configs/deepseek_moe_16b.py` with torch dtypes)"""
import torch

from repro_torch.models.lm import LMConfig, MoEConfig
from .lm_shapes import SHAPES, SMOKE_SHAPES  # noqa: F401

FAMILY = "lm"


def full_config() -> LMConfig:
    return LMConfig(
        name="deepseek-moe-16b", n_layers=28, d_model=2048, n_heads=16,
        n_kv_heads=16, d_ff=1408, vocab=102400,
        moe=MoEConfig(n_experts=64, top_k=6, n_shared=2),
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)


def smoke_config() -> LMConfig:
    return LMConfig(
        name="deepseek-moe-16b-smoke", n_layers=2, d_model=64, n_heads=16,
        n_kv_heads=16, d_ff=32, vocab=128, d_head=4,
        moe=MoEConfig(n_experts=16, top_k=2, n_shared=2), loss_chunks=2)

"""Gradient compression with error feedback (port of
`repro/optim/compression.py`): top-k sparsification (the entries of at
least the k-th largest magnitude kept) and per-tensor symmetric int8
quantisation, each a compress -> decompress round trip on one tensor;
`compressed_gradients` applies one over a gradient tree and carries what
it dropped into the next step's gradients (Karimireddy et al., EF-SGD)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.tree import tree_map


class ErrorFeedbackState(NamedTuple):
    residual: object  # a tree like the gradients, fp32


def topk_compress_decompress(g: torch.Tensor, frac: float = 0.01):
    """(g with the entries below the k-th largest magnitude zeroed, the
    fraction of L2 mass kept), k = max(1, int(frac * size))."""
    flat = g.reshape(-1).float()
    k = max(1, int(frac * flat.numel()))
    thresh = torch.topk(flat.abs(), k).values[-1]
    kept = torch.where(flat.abs() >= thresh, flat, 0.0)
    mass = torch.sum(kept * kept) / torch.clamp(torch.sum(flat * flat),
                                                min=1e-20)
    return kept.reshape(g.shape).to(g.dtype), mass


def int8_compress_decompress(g: torch.Tensor) -> torch.Tensor:
    """Per-tensor symmetric int8 quantise -> dequantise round trip (scale
    max|g| / 127, round half to even, clip to [-127, 127])."""
    flat = g.float()
    scale = torch.clamp(flat.abs().max(), min=1e-20) / 127.0
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    return (q.float() * scale).to(g.dtype)


def compressed_gradients(grads, ef: ErrorFeedbackState | None,
                         codec: str = "int8", topk_frac: float = 0.01):
    """(the compressed gradients, the new error-feedback state): each
    gradient plus its residual goes through `codec` ("int8" or "topk"),
    and what the codec dropped becomes the next residual."""
    if ef is None:
        ef = ErrorFeedbackState(tree_map(
            lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                  device=g.device), grads))

    def one(g, r):
        corrected = g.float() + r
        if codec == "int8":
            out = int8_compress_decompress(corrected)
        elif codec == "topk":
            out, _ = topk_compress_decompress(corrected, topk_frac)
        else:
            raise ValueError(codec)
        return out.to(g.dtype), corrected - out.float()

    pairs = tree_map(one, grads, ef.residual)
    comp = tree_map(lambda _, t: t[0], grads, pairs)
    resid = tree_map(lambda _, t: t[1], grads, pairs)
    return comp, ErrorFeedbackState(resid)

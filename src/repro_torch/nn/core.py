"""Functional NN layers of the LM and recsys models (port of
`repro/nn/core.py`): parameters are plain dicts of tensors, each layer a
function of tensors.

The inits draw truncated normals on [-2, 2] from the caller's
`torch.Generator`, on the generator's device unless `device` names another:
JAX's distribution, not its values.  ``device="meta"`` gives the shapes
and dtypes only (JAX's `jax.eval_shape` of an init).  Norms and rotary
angles run in fp32 and cast back to the input's dtype, as in JAX.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _truncated_normal(generator, shape, device=None) -> torch.Tensor:
    """Standard normal truncated to [-2, 2] (not rescaled), fp32, on
    `device` (default: the generator's)."""
    out = torch.empty(shape, dtype=torch.float32,
                      device=generator.device if device is None else device)
    return torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0,
                                       generator=generator)


def dense_init(generator, in_dim: int, out_dim: int, dtype=torch.float32,
               scale: float | None = None, device=None) -> torch.Tensor:
    """(in_dim, out_dim) weights: truncated normal times `scale` (default
    1/sqrt(in_dim)), drawn in fp32 and cast to `dtype`."""
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    return (_truncated_normal(generator, (in_dim, out_dim), device)
            .mul_(scale).to(dtype))


def embed_init(generator, vocab: int, dim: int, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """(vocab, dim) embedding rows: truncated normal, cast to `dtype`."""
    return _truncated_normal(generator, (vocab, dim), device).to(dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    """x / rms(x) * w over the last axis, in fp32, cast back to x's dtype."""
    xf = x.float()
    xf = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (xf * w.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 500_000.0) -> torch.Tensor:
    """Rotary embedding, half-split (the first and second halves of the
    head dim rotate as pairs).  x: (..., S, H, D), D even; positions:
    (..., S).  Angles and the rotation in fp32, cast back to x's dtype."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    angles = positions[..., None].float() * freqs        # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                # over the heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    """silu(x w_gate) * (x w_up), times w_down."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def cross_entropy_chunked(h, unembed, labels, n_chunks: int = 8,
                          logit_dtype=torch.float32):
    """Token-mean cross entropy over sequence chunks, so the (B, chunk, V)
    logits of one chunk live at a time.  h: (B, S, D); unembed: (D, V);
    labels: (B, S) int, label < 0 = padding.  S not a multiple of
    `n_chunks` runs as one chunk."""
    b, s, _ = h.shape
    if s % n_chunks:
        n_chunks = 1
    cs = s // n_chunks
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.int32, device=h.device)
    w = unembed.to(logit_dtype)
    for c in range(n_chunks):
        logits = h[:, c * cs:(c + 1) * cs].to(logit_dtype) @ w
        ll = labels[:, c * cs:(c + 1) * cs]
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, ll.clamp(min=0)[..., None].long())
        valid = ll >= 0
        tot = tot + torch.where(valid, lse - gold[..., 0], 0.0).sum()
        cnt = cnt + valid.sum(dtype=torch.int32)
    return tot / cnt.clamp(min=1)

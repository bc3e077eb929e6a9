"""Wrapper of the CUDA forward attention (`csrc/flash_attention.cu`;
replaces the Pallas TPU kernel
`repro/kernels/flash_attention.py::flash_attention`).

Online-softmax attention in fp32 with GQA by index, the TPU kernel's
bottom-right causal mask filled with -1e30 (a fully masked query row
averages V), and the output cast to q's dtype.  The plain version is
`ref.flash_attention_kernel_ref`; `ops.flash_attention` dispatches between
the two by the tensor's device.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import softmax_scale

MAX_HEAD_DIM = 256
DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}

# launches of the kernel, by dtype; only `flash_attention` adds to it
launches = {"float32": 0, "bfloat16": 0}

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def check_shapes(q, k, v) -> None:
    """Raise ValueError on shapes the kernel (and its plain version) does
    not take: q (B, H, Sq, D), k and v (B, Hkv, Sk, D), H % Hkv == 0,
    Sq, Sk >= 1, D <= 256."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, H, Sq, D) and k, v (B, Hkv, Sk, D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, sq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k and v must have q's batch {b} and head dim {d}, "
                         f"got {tuple(k.shape)}")
    if h % k.shape[1]:
        raise ValueError(f"the query heads ({h}) must be a multiple of the "
                         f"kv heads ({k.shape[1]})")
    if sq < 1 or k.shape[2] < 1:
        raise ValueError("Sq and Sk must be >= 1")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} > {MAX_HEAD_DIM} is not supported")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Launch the CUDA kernel on q's device and current stream.

    q, k, v: contiguous float32 or bfloat16 CUDA tensors of one dtype, on
    one device.  Returns (B, H, Sq, D) in q's dtype.
    """
    check_shapes(q, k, v)
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        _build.check_tensor(t, what, (q.dtype,) if t is not q
                            else tuple(DTYPES))
        if t.device != q.device:
            raise ValueError(f"{what} must be on q's device")
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if b * h > 65535:
        raise ValueError(f"B * H = {b * h} > 65535 CTA rows")
    out = torch.empty_like(q)
    fn = _build.entry("flash_attention", f"flash_attention_{DTYPES[q.dtype]}",
                      _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, h, hkv, sq, sk, d, softmax_scale(d), int(causal),
                 _build.stream(q))
    _build.raise_on_error("flash_attention", err)
    if b:                       # else the kernel returns at once
        launches[str(q.dtype).removeprefix("torch.")] += 1
    return out

"""Wrapper of the CUDA forward attention (`csrc/flash_attention.cu`;
replaces the Pallas TPU kernel
`repro/kernels/flash_attention.py::flash_attention`).

Online-softmax attention in fp32 with GQA by index, the TPU kernel's
bottom-right causal mask filled with -1e30 (a fully masked query row
averages V), and the output cast to q's dtype.  Which kernel a CUDA call
runs (`route`):

* bfloat16, D <= 256: `flash_tc`, on the tensor cores (mma.sync m16n8k16,
  fp32 accumulation, P as two bf16 parts, a two-stage cp.async ring);
* float32, D <= 128: `flash_f32tc`, QK^T on the CUDA cores as one fma chain
  over D per score (the reference's order, which large scores need to stay
  within 2e-5) and O += P V on the tensor cores in 3xTF32 (mma.sync
  m16n8k8, P and V each split into two TF32 parts), a two-stage cp.async
  ring;
* bfloat16, 256 < D <= 1247, and float32, 128 < D <= 1247: `flash_fwd`, on
  the CUDA cores (fp32 throughout), output columns split over CTAs in
  chunks of 256;
* D > 1247: ValueError (the CUDA-core kernel's shared memory would pass
  227 KB).

The plain version is `ref.flash_attention_kernel_ref`, for any D;
`ops.flash_attention` dispatches between it and this wrapper by the
tensor's device.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import softmax_scale

# kTcMaxHeadDim and kF32TcMaxHeadDim of csrc/flash_attention.cu: head dims
# up to them run the tensor-core entry point of their dtype, those above its
# `_cuda_cores` one; each entry point rejects the other's
TC_MAX_HEAD_DIM = 256
F32_TC_MAX_HEAD_DIM = 128
MAX_HEAD_DIM = 1247        # 4 (32 (D + 1) + 32 * 256 + 8 D) bytes <= 227 KB
DTYPES = (torch.float32, torch.bfloat16)
# C entry point of each kernel, by its `launches` key
SYMBOLS = {"float32": "flash_attention_f32",
           "float32_cuda_cores": "flash_attention_f32_cuda_cores",
           "bfloat16": "flash_attention_bf16",
           "bfloat16_cuda_cores": "flash_attention_bf16_cuda_cores"}

# launches of each kernel (see `route`); only `flash_attention` adds to it
launches = {key: 0 for key in SYMBOLS}

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel that a CUDA call with this dtype and head dim runs, as
    its `launches` key: "bfloat16" (tensor cores, D <= 256), "float32"
    (PV on the tensor cores, D <= 128), or "float32_cuda_cores" /
    "bfloat16_cuda_cores" (CUDA cores, the head dims above)."""
    if dtype == torch.float32:
        return "float32" if d <= F32_TC_MAX_HEAD_DIM else "float32_cuda_cores"
    if dtype == torch.bfloat16:
        return "bfloat16" if d <= TC_MAX_HEAD_DIM else "bfloat16_cuda_cores"
    raise ValueError(f"q must be float32 or bfloat16, got {dtype}")


def check_shapes(q, k, v) -> None:
    """Raise ValueError on shapes neither the kernels nor their plain
    version take: q (B, H, Sq, D), k and v (B, Hkv, Sk, D), H % Hkv == 0,
    Sq, Sk >= 1."""
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Launch the kernel that `route` names on q's device and current
    stream.

    q, k, v: contiguous float32 or bfloat16 CUDA tensors of one dtype, on
    one device, D <= 1247.  Returns (B, H, Sq, D) in q's dtype.
    """
    check_shapes(q, k, v)
    b, h, sq, d = q.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} > {MAX_HEAD_DIM}: the CUDA-core "
                         "kernel's shared memory would pass 227 KB")
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        _build.check_tensor(t, what, (q.dtype,) if t is not q else DTYPES)
        if t.device != q.device:
            raise ValueError(f"{what} must be on q's device")
    hkv, sk = k.shape[1], k.shape[2]
    if b * h > 65535:
        raise ValueError(f"B * H = {b * h} > 65535 CTA rows")
    key = route(q.dtype, d)
    out = torch.empty_like(q)
    fn = _build.entry("flash_attention", SYMBOLS[key], _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, h, hkv, sq, sk, d, softmax_scale(d), int(causal),
                 _build.stream(q))
    _build.raise_on_error("flash_attention", err)
    if b:                       # else the kernel returns at once
        launches[key] += 1
    return out

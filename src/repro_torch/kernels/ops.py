"""Public dispatch for the port's kernels (port of `repro/kernels/ops.py`).

A CUDA tensor runs the CUDA kernel; a CPU tensor runs the kernel's plain
PyTorch version (`ref.py`), which computes the same pointers and rounds.
Nothing falls back from the kernel to the plain version: on a CUDA tensor
the kernel runs or the call raises.
"""
from __future__ import annotations

import torch

from . import ref
from .fused_local_phase import (KERNEL_CONNECTIVITIES,
                                fused_local_phase as _fused_kernel)


def _grid_kernel_ok(field, connectivity: int) -> bool:
    """The grid stencil kernels are 3-D x-slab programs; 2-D fields and
    connectivities outside the 3-D offset table take the init-only path."""
    return field.ndim == 3 and connectivity in KERNEL_CONNECTIVITIES


def fused_local_phase(field: torch.Tensor, connectivity: int = 6,
                      mode: str = "manifold", self_mask=None,
                      impl: str = "auto", block_x: int = 8, id_dtype=None):
    """Fused block-local phase: pointer init + in-tile saturation rounds.

    Returns ``(pointers, kernel_rounds)``.  Every path gives pointers with
    the same chase fixpoint as the plain init, so the global `path_compress`
    that follows converges to bit-identical labels; the kernel path starts
    it near-converged.

    impl="auto": the CUDA kernel on a CUDA tensor, its plain version on a
    CPU tensor (so the CPU reports the kernel's rounds; the JAX package's
    CPU "auto" is init-only);
    impl="kernel": the CUDA kernel; raises on a CPU tensor;
    impl="ref": the plain init only (``kernel_rounds == 0``), as in JAX.
    2-D fields and unsupported connectivities always take the init-only
    path, as in JAX.
    """
    if impl not in ("auto", "kernel", "ref"):
        raise ValueError(f"impl must be auto|kernel|ref, got {impl!r}")
    if mode not in ("manifold", "cc"):
        raise ValueError(f"mode must be 'manifold' or 'cc', got {mode!r}")
    if impl != "ref" and _grid_kernel_ok(field, connectivity):
        if field.is_cuda:
            if mode == "cc" and field.dtype != torch.bool:
                field = field != 0
            if self_mask is not None:
                self_mask = self_mask.bool()
            return _fused_kernel(field.contiguous(), connectivity, mode=mode,
                                 self_mask=self_mask, block_x=block_x,
                                 id_dtype=id_dtype)
        if impl == "kernel":
            raise RuntimeError(
                "impl='kernel' runs the CUDA kernel and needs a CUDA tensor; "
                f"got one on {field.device} (impl='auto' runs the kernel's "
                "plain version there)")
        return ref.fused_local_phase_ref(field, connectivity, mode=mode,
                                         self_mask=self_mask, block_x=block_x,
                                         id_dtype=id_dtype)
    d0 = ref.local_phase_init(field, connectivity, mode, self_mask, id_dtype)
    return d0.reshape(field.shape), 0

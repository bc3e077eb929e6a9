"""Public dispatch for the port's kernels (port of `repro/kernels/ops.py`),
with the JAX names, signatures and `impl` values.

impl="auto": a CUDA tensor runs the CUDA kernel; a CPU tensor runs the
kernel's plain PyTorch version (`ref.py`), which computes what the kernel
computes (the JAX package's CPU "auto" runs its jnp oracles instead).
impl="kernel": the CUDA kernel; raises on a CPU tensor.
impl="plain": the kernel's plain PyTorch version on any device (no JAX
counterpart; the models' callers hold the kernel to it).
impl="ref": the JAX package's `impl="ref"` path, ported as it is.
Nothing falls back from the kernel to the plain version: on a CUDA tensor
the kernel runs or the call raises.  The only other fallback is JAX's own:
2-D fields and connectivities outside (6, 14, 18, 26) take the plain
stencil path of `steepest_neighbor` and `fused_local_phase`.
"""
from __future__ import annotations

import torch

from . import ref
from .block_pathcompress import block_pathcompress as _bpc_kernel
from .flash_attention import (check_shapes as _check_attention_shapes,
                              flash_attention as _flash_kernel)
from .fused_local_phase import (KERNEL_CONNECTIVITIES,
                                fused_local_phase as _fused_kernel)
from .segment_bag import segment_bag as _bag_kernel
from .steepest_neighbor import steepest_neighbor as _steepest_kernel

IMPLS = ("auto", "kernel", "plain", "ref")


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be auto|kernel|plain|ref, got {impl!r}")


def _use_kernel(impl: str, t: torch.Tensor, name: str) -> bool:
    """Whether impl "auto", "kernel" or "plain" on tensor `t` runs the CUDA
    kernel (else the kernel's plain version); raises on impl="kernel" with
    a CPU tensor."""
    if impl == "plain":
        return False
    if impl == "kernel" and not t.is_cuda:
        raise RuntimeError(
            f"impl='kernel' runs the CUDA {name} kernel and needs a CUDA "
            f"tensor; got one on {t.device} (impl='auto' runs the kernel's "
            "plain version there)")
    return t.is_cuda


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
    impl="plain": the kernel's plain version on any device;
    impl="ref": the plain init only (``kernel_rounds == 0``), as in JAX.
    2-D fields and unsupported connectivities always take the init-only
    path, as in JAX.
    """
    _check_impl(impl)
    if mode not in ("manifold", "cc"):
        raise ValueError(f"mode must be 'manifold' or 'cc', got {mode!r}")
    if impl != "ref" and _grid_kernel_ok(field, connectivity):
        if _use_kernel(impl, field, "fused_local_phase"):
            if mode == "cc" and field.dtype != torch.bool:
                field = field != 0
            if self_mask is not None:
                self_mask = self_mask.bool()
            return _fused_kernel(field.contiguous(), connectivity, mode=mode,
                                 self_mask=self_mask, block_x=block_x,
                                 id_dtype=id_dtype)
        return ref.fused_local_phase_ref(field, connectivity, mode=mode,
                                         self_mask=self_mask, block_x=block_x,
                                         id_dtype=id_dtype)
    d0 = ref.local_phase_init(field, connectivity, mode, self_mask, id_dtype)
    return d0.reshape(field.shape), 0


def steepest_neighbor(order: torch.Tensor, connectivity: int = 6,
                      impl: str = "auto", block_x: int = 8) -> torch.Tensor:
    """Steepest-neighbor pointer init: per voxel the flat id of the
    largest-order vertex among itself and its neighbours, int32, in the
    shape of `order`.

    impl="auto"/"kernel" on a 3-D field with connectivity 6/14/18/26: the
    CUDA stencil (int32 order only), or its plain version on a CPU tensor
    under "auto" and anywhere under "plain".  impl="ref", 2-D fields and
    other connectivities: `grid_steepest`, as in JAX.  `block_x` is the
    TPU kernel's x-slab (any value >= 1 gives the same ids); the CUDA
    kernel tiles on its own.
    """
    _check_impl(impl)
    if block_x < 1:
        raise ValueError(f"block_x must be >= 1, got {block_x}")
    if (impl != "ref" and _grid_kernel_ok(order, connectivity)
            and _use_kernel(impl, order, "steepest_neighbor")):
        return _steepest_kernel(order.contiguous(), connectivity)
    return ref.steepest_neighbor_ref(order, connectivity)


def block_pathcompress(d: torch.Tensor, rounds: int = 4, block: int = 4096,
                       impl: str = "auto") -> torch.Tensor:
    """`rounds` pointer-doubling rounds confined to tiles of
    ``min(block, next_pow2(n))`` pointers (the kernel, or its plain version
    on a CPU tensor under "auto" and anywhere under "plain").  impl="ref":
    JAX's whole-array rounds (`ref.block_pathcompress_ref`, block = the
    array)."""
    _check_impl(impl)
    if impl == "ref":
        return ref.block_pathcompress_ref(d, rounds)
    if block < 1 or rounds < 0:
        raise ValueError(f"block must be >= 1 and rounds >= 0, got block "
                         f"{block}, rounds {rounds}")
    if _use_kernel(impl, d, "block_pathcompress"):
        return _bpc_kernel(d.contiguous(), rounds=rounds, block=block)
    return ref.block_pathcompress_kernel_ref(d, rounds=rounds, block=block)


def flash_attention(q, k, v, causal: bool = False, impl: str = "auto",
                    block_q: int = 128, block_k: int = 128,
                    check_tiles: bool = True) -> torch.Tensor:
    """Forward attention, q (B, H, Sq, D), k and v (B, Hkv, Sk, D), H a
    multiple of Hkv; returns (B, H, Sq, D) in q's dtype.

    As in JAX, ``Sq % min(block_q, Sq)`` and ``Sk % min(block_k, Sk)`` must
    be 0 (ValueError here, an assertion there) unless `check_tiles` is
    False: the CUDA kernel tiles on its own and it and its plain version
    take any length (the LM's prefill turns the check off, as JAX's model
    never calls the Pallas kernel).  "auto"/"kernel": a CUDA kernel
    (bfloat16 with D <= 256 on the tensor cores, float32 with D <= 128 with
    P V on them in 3xTF32, wider float32 and bfloat16 up to D = 1247 on the
    CUDA cores; `flash_attention.route`), or its plain version, for any D,
    on a CPU tensor under "auto" and anywhere under "plain"; both give a
    fully masked causal row the mean of V.  impl="ref": JAX's chunked
    oracle `ref.flash_attention_ref`, NaN on such rows.
    """
    _check_impl(impl)
    if impl == "ref":
        return ref.flash_attention_ref(q, k, v, causal=causal)
    _check_attention_shapes(q, k, v)
    sq, sk = q.shape[2], k.shape[2]
    if block_q < 1 or block_k < 1:
        raise ValueError(f"block_q and block_k must be >= 1, got {block_q}, "
                         f"{block_k}")
    if check_tiles and (sq % min(block_q, sq) or sk % min(block_k, sk)):
        raise ValueError(f"Sq = {sq} and Sk = {sk} must be multiples of "
                         f"min(block_q, Sq) = {min(block_q, sq)} and "
                         f"min(block_k, Sk) = {min(block_k, sk)}")
    if _use_kernel(impl, q, "flash_attention"):
        return _flash_kernel(q.contiguous(), k.contiguous(), v.contiguous(),
                             causal=causal)
    return ref.flash_attention_kernel_ref(q, k, v, causal=causal,
                                          block_k=min(block_k, sk))


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, impl: str = "auto",
                  vocab_block: int = 2048,
                  batch_block: int = 256) -> torch.Tensor:
    """Sum EmbeddingBag: table (V, D), ids (B, L) with -1 pads; returns
    (B, D) in the table's dtype.

    "auto"/"kernel": the CUDA kernel (float32 or bfloat16 tables), or its
    plain version on a CPU tensor under "auto" and anywhere under "plain";
    ids outside [0, V) add nothing, as in the Pallas kernel.  impl="ref":
    JAX's jnp oracle (`ref.embedding_bag`, from `models/bst.py`), whose bag
    is NaN where an id is >= V.  `vocab_block` and `batch_block` are the TPU
    kernel's tiles (validated, unused: the CUDA kernel gathers rows).
    """
    _check_impl(impl)
    if impl == "ref":
        return ref.embedding_bag(table, ids)
    if vocab_block < 1 or batch_block < 1:
        raise ValueError(f"vocab_block and batch_block must be >= 1, got "
                         f"{vocab_block}, {batch_block}")
    if _use_kernel(impl, table, "segment_bag"):
        return _bag_kernel(table.contiguous(), ids.contiguous())
    return ref.segment_bag_ref(table, ids)

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
the kernel runs or the call raises.  On a meta tensor (a shape-only trace,
`launch.dryrun`) "auto" and "kernel" take the kernel's meta rule in
`repro_torch._meta`: outputs of the kernel's shapes and dtypes, its FLOPs
and bytes added to the active count (`_meta.counting`), `fused_local_phase`
costed as one round.  No other tensor takes that branch.

`flash_attention` and `embedding_bag` under "auto" and "kernel" are
`torch.autograd.Function`s: the forward is the kernel (or, on a CPU tensor
under "auto", its plain version), the backward is written in PyTorch ops
(`attention_backward`, `bag_backward`), as JAX, which has no backward
kernel, differentiates its jnp oracles.  "plain" and "ref" are autograd
through their PyTorch ops.  The only other fallback is JAX's own:
2-D fields and connectivities outside (6, 14, 18, 26) take the plain
stencil path of `steepest_neighbor` and `fused_local_phase`.
"""
from __future__ import annotations

import torch

from .. import _meta
from ..core.steepest import id_dtype_for
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
        if field.is_meta and impl != "plain":
            return _meta.fused_local_phase(
                field, connectivity, mode, self_mask,
                id_dtype or id_dtype_for(field.numel()))
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
    if (impl in ("auto", "kernel") and order.is_meta
            and _grid_kernel_ok(order, connectivity)):
        return _meta.steepest_neighbor(order, connectivity)
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
    if d.is_meta and impl != "plain":
        return _meta.block_pathcompress(d, rounds)
    if _use_kernel(impl, d, "block_pathcompress"):
        return _bpc_kernel(d.contiguous(), rounds=rounds, block=block)
    return ref.block_pathcompress_kernel_ref(d, rounds=rounds, block=block)


# --- gradients of the two model kernels ---------------------------------------


def attention_backward(q, k, v, do, causal: bool, block_k: int | None = None):
    """(dq, dk, dv) of the kernel's attention at q (B, H, Sq, D), k, v
    (B, Hkv, Sk, D), given the output's gradient `do`, in fp32 PyTorch ops
    over chunks of `block_k` keys (default: about 2**26 scores a chunk), so
    no (B, H, Sq, Sk) tensor is made when Sk is longer than a chunk.

    A first pass rebuilds each row's max, sum and fp32 output with the
    kernel's online softmax (q scaled by `ref.softmax_scale(D)` after its
    cast to fp32, the causal mask bottom-right filled with -1e30); then,
    chunk by chunk, P, dV += P^T dO, dP = dO V^T, dS = P (dP - rowsum(dO O))
    with dS = 0 on masked scores (a fully masked row's output is the mean
    of V, whatever q and k are), dQ += scale dS K and dK += dS^T (scale q),
    dK and dV summed over each GQA group of query heads.  In a causal chunk
    the rows that see none of its keys are skipped (their P is exactly 0)
    unless Sq > Sk, where the first rows see no key at all.  The gradients
    come back in the inputs' dtypes."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = h // hkv
    scale = ref.softmax_scale(d)
    if block_k is None:
        block_k = max(1, min(sk, 2 ** 26 // max(b * h * sq, 1)))
    qf = q.float().reshape(b, hkv, g, sq, d) * scale
    dof = do.float().reshape(b, hkv, g, sq, d)
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    shift = sk - sq                       # query row i sits at key i + shift
    skip = causal and sq <= sk

    def scores(j0, j1, r0):
        s = qf[..., r0:, :] @ kf[..., j0:j1, :].transpose(-1, -2)
        if not causal:
            return s, None
        seen = (torch.arange(r0, sq, device=q.device)[:, None] + shift
                >= torch.arange(j0, j1, device=q.device))
        return torch.where(seen, s, ref.MASKED), seen

    def first_row(j0):
        return max(0, j0 - shift) if skip else 0

    m = torch.full((b, hkv, g, sq, 1), ref.MASKED, device=q.device)
    lsum = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for j0 in range(0, sk, block_k):
        j1, r0 = min(j0 + block_k, sk), first_row(j0)
        s, _ = scores(j0, j1, r0)
        m_old = m[..., r0:, :]
        m_new = torch.maximum(m_old, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m_old - m_new)
        lsum[..., r0:, :] = lsum[..., r0:, :] * corr + p.sum(-1, keepdim=True)
        acc[..., r0:, :] = acc[..., r0:, :] * corr + p @ vf[..., j0:j1, :]
        m[..., r0:, :] = m_new
    lsum = lsum.clamp(min=1e-30)
    delta = (dof * (acc / lsum)).sum(-1, keepdim=True)
    del acc
    dq = torch.zeros_like(qf)
    dk = torch.zeros((b, hkv, sk, d), device=q.device)
    dv = torch.zeros_like(dk)
    for j0 in range(0, sk, block_k):
        j1, r0 = min(j0 + block_k, sk), first_row(j0)
        s, seen = scores(j0, j1, r0)
        p = torch.exp(s - m[..., r0:, :]) / lsum[..., r0:, :]
        dov = dof[..., r0:, :]
        dv[:, :, j0:j1] = (p.transpose(-1, -2) @ dov).sum(2)
        ds = p * (dov @ vf[..., j0:j1, :].transpose(-1, -2)
                  - delta[..., r0:, :])
        if seen is not None:
            ds = torch.where(seen, ds, 0.0)
        dq[..., r0:, :] += (ds @ kf[..., j0:j1, :]) * scale
        dk[:, :, j0:j1] = (ds.transpose(-1, -2) @ qf[..., r0:, :]).sum(2)
    return (dq.reshape(b, h, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def bag_backward(dout, ids, vocab: int, dtype) -> torch.Tensor:
    """The table's gradient (vocab, D) of the sum EmbeddingBag, given the
    bags' gradient `dout` (B, D): each bag's gradient added (`index_add_`,
    in fp32) to the rows of its ids in [0, vocab); ids < 0 and >= vocab add
    nothing, as in the forward.  Cast to `dtype`."""
    b, l = ids.shape
    valid = ((ids >= 0) & (ids < vocab)).reshape(-1, 1)
    rows = torch.where(valid[:, 0], ids.reshape(-1), 0).long()
    src = dout.float()[:, None].expand(b, l, dout.shape[1]).reshape(b * l, -1)
    grad = torch.zeros((vocab, dout.shape[1]), dtype=torch.float32,
                       device=dout.device)
    grad.index_add_(0, rows, torch.where(valid, src, 0.0))
    return grad.to(dtype)


class _FlashAttention(torch.autograd.Function):
    """The attention kernel (or its plain version, `kernel` False, or its
    meta rule, `kernel` "meta") with `attention_backward` as its gradient;
    saves q, k and v only."""

    @staticmethod
    def forward(ctx, q, k, v, causal, kernel, block_k):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        if kernel == "meta":
            return _meta.flash_attention(q, k, v, causal)
        if kernel:
            return _flash_kernel(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal=causal)
        return ref.flash_attention_kernel_ref(q, k, v, causal=causal,
                                              block_k=block_k)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return (*attention_backward(q, k, v, do, ctx.causal),
                None, None, None)


class _SegmentBag(torch.autograd.Function):
    """The bag kernel (or its plain version, `kernel` False, or its meta
    rule, `kernel` "meta") with `bag_backward` as its gradient; saves the
    ids only."""

    @staticmethod
    def forward(ctx, table, ids, kernel):
        ctx.save_for_backward(ids)
        ctx.vocab, ctx.dtype = table.shape[0], table.dtype
        if kernel == "meta":
            return _meta.segment_bag(table, ids)
        if kernel:
            return _bag_kernel(table.contiguous(), ids.contiguous())
        return ref.segment_bag_ref(table, ids)

    @staticmethod
    def backward(ctx, dout):
        ids, = ctx.saved_tensors
        return bag_backward(dout, ids, ctx.vocab, ctx.dtype), None, None


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
    on a CPU tensor under "auto"; both give a fully masked causal row the
    mean of V, and `attention_backward` is their gradient.  "plain": the
    plain version anywhere, autograd through its ops.  impl="ref": JAX's
    chunked oracle `ref.flash_attention_ref`, NaN on such rows.
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
    if impl == "plain":
        return ref.flash_attention_kernel_ref(q, k, v, causal=causal,
                                              block_k=min(block_k, sk))
    return _FlashAttention.apply(q, k, v, causal, "meta" if q.is_meta else
                                 _use_kernel(impl, q, "flash_attention"),
                                 min(block_k, sk))


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, impl: str = "auto",
                  vocab_block: int = 2048,
                  batch_block: int = 256) -> torch.Tensor:
    """Sum EmbeddingBag: table (V, D), ids (B, L) with -1 pads; returns
    (B, D) in the table's dtype.

    "auto"/"kernel": the CUDA kernel (float32 or bfloat16 tables), or its
    plain version on a CPU tensor under "auto"; ids outside [0, V) add
    nothing, as in the Pallas kernel, and `bag_backward` is the table's
    gradient.  "plain": the plain version anywhere, autograd through its
    ops.  impl="ref": JAX's jnp oracle (`ref.embedding_bag`, from
    `models/bst.py`), whose bag is NaN where an id is >= V.  `vocab_block`
    and `batch_block` are the TPU kernel's tiles (validated, unused: the
    CUDA kernel gathers rows).
    """
    _check_impl(impl)
    if impl == "ref":
        return ref.embedding_bag(table, ids)
    if vocab_block < 1 or batch_block < 1:
        raise ValueError(f"vocab_block and batch_block must be >= 1, got "
                         f"{vocab_block}, {batch_block}")
    if impl == "plain":
        return ref.segment_bag_ref(table, ids)
    return _SegmentBag.apply(table, ids, "meta" if table.is_meta else
                             _use_kernel(impl, table, "segment_bag"))

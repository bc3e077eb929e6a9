"""Plain PyTorch versions of the port's kernels: what the CPU runs, and what
`chip_smoke.py` holds each CUDA kernel against on the card.  Beside them,
ports of the JAX package's jnp oracles that its `impl="ref"` dispatch runs
(`block_pathcompress_ref`, `mha_ref`, `flash_attention_ref`,
`embedding_bag`), where they differ from the kernel's plain version."""
from __future__ import annotations

import numpy as np
import torch

from ..core.steepest import grid_mask_argmax, grid_steepest, id_dtype_for


def max_saturation_rounds(tsize: int) -> int:
    """Round cap of the in-tile saturation: a chain fits in the tile, so
    doubling resolves it in ceil(log2(tsize)) rounds, plus the final
    no-change verification round."""
    return max((tsize - 1).bit_length(), 1) + 1


def local_phase_init(field: torch.Tensor, connectivity: int, mode: str,
                     self_mask=None, id_dtype=None) -> torch.Tensor:
    """The pointer init of the block-local phase, flat: steepest argmax
    (manifold) or largest masked neighbor id (cc), then the `self_mask`
    override ((masked) vertices point at themselves)."""
    if mode == "manifold":
        d = grid_steepest(field, connectivity)
    elif mode == "cc":
        d = grid_mask_argmax(field, connectivity)
    else:
        raise ValueError(f"mode must be 'manifold' or 'cc', got {mode!r}")
    d = d.to(id_dtype_for(field.numel()) if id_dtype is None else id_dtype)
    if self_mask is not None:
        keep = self_mask.reshape(-1).bool()
        if mode == "cc":
            keep = keep & (field.reshape(-1) != 0)
        ids = torch.arange(field.numel(), dtype=d.dtype, device=d.device)
        d = torch.where(keep, ids, d)
    return d


def fused_local_phase_ref(field: torch.Tensor, connectivity: int,
                          mode: str = "manifold", self_mask=None,
                          block_x: int = 8, id_dtype=None):
    """Plain version of the fused block-local kernel
    (`repro/kernels/fused_local_phase.py::fused_local_phase`): the pointer
    init (steepest argmax / largest masked neighbor id), the optional
    `self_mask` override, then pointer doubling confined to each
    `block_x`-plane x-slab, counting rounds as the kernel's while loop does.

    All slabs double together, one synchronous round at a time, until a round
    changes nothing anywhere.  A converged slab is a fixed point of further
    rounds and every slab has the same round cap, so the number of rounds
    run is the max over slabs of each slab's own count, which is what the
    TPU kernel reports.  Returns ((X, Y, Z) pointers, rounds as an int).
    """
    n = field.numel()
    row = n // field.shape[0] if field.shape[0] else 0
    d = local_phase_init(field, connectivity, mode, self_mask, id_dtype)
    ids = torch.arange(n, dtype=d.dtype, device=d.device)
    tsize = block_x * row
    max_rounds = max_saturation_rounds(tsize)
    lo = ids // tsize * tsize          # first id of each vertex's slab
    rounds, changed = 0, True
    while changed and rounds < max_rounds:
        # pointers that are negative or leave the slab are fixed points
        # (d - lo, not lo + tsize: the latter can pass the int32 range)
        in_tile = (d >= lo) & (d - lo < tsize)
        nxt = torch.where(in_tile, d.index_select(0, d.clamp(min=0)), d)
        changed = bool((nxt != d).any())
        d, rounds = nxt, rounds + 1
    return d.reshape(field.shape), rounds


# --- steepest_neighbor -------------------------------------------------------


def steepest_neighbor_ref(order: torch.Tensor,
                          connectivity: int = 6) -> torch.Tensor:
    """Plain version of the steepest-neighbor kernel (and of JAX's
    `ref.steepest_neighbor_ref`): per voxel the flat id of the largest-order
    vertex among itself and its neighbours, self first, strict ``>``; in
    the shape of `order`."""
    return grid_steepest(order, connectivity).reshape(order.shape)


# --- block_pathcompress -------------------------------------------------------


def block_pathcompress_ref(d: torch.Tensor, rounds: int,
                           base: int = 0) -> torch.Tensor:
    """Port of JAX's `ref.block_pathcompress_ref`: `rounds` doubling steps
    confined to the id range [base, base + len(d)); negative and
    out-of-range pointers are fixed points.  `ops.block_pathcompress` with
    ``impl="ref"`` runs it over the whole array, as JAX's does."""
    n = d.shape[0]
    for _ in range(rounds):
        local = d - base
        in_block = (d >= 0) & (local >= 0) & (local < n)
        nd = d.index_select(0, local.clamp(0, n - 1))
        d = torch.where(in_block, nd, d)
    return d


def snapped_block(n: int, block: int) -> int:
    """The tile size JAX's `block_pathcompress` runs for length n: `block`
    cut to the pow2 bucket capacity of n (1 for n <= 1)."""
    return min(block, 1 if n <= 1 else 1 << (int(n) - 1).bit_length())


def block_pathcompress_kernel_ref(d: torch.Tensor, rounds: int = 4,
                                  block: int = 4096) -> torch.Tensor:
    """Plain version of the block_pathcompress kernel (and of the Pallas
    kernel): `block` is snapped as the JAX entry point snaps it
    (`snapped_block`), the array is padded with -1 to whole tiles, and every
    tile runs `block_pathcompress_ref` with its own base, all tiles at
    once."""
    n = d.numel()
    block = snapped_block(n, block)
    tiles = -(-n // block)
    t = torch.full((tiles * block,), -1, dtype=d.dtype, device=d.device)
    t[:n] = d
    t = t.view(tiles, block)
    base = torch.arange(tiles, dtype=torch.int64, device=d.device)[:, None]
    base = base * block
    for _ in range(rounds):
        local = t.long() - base
        in_tile = (t >= 0) & (local >= 0) & (local < block)
        t = torch.where(in_tile, t.gather(1, local.clamp(0, block - 1)), t)
    return t.reshape(-1)[:n].clone()


# --- segment_bag / embedding_bag ---------------------------------------------


def segment_bag_ref(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain version of the segment_bag kernel (and of the Pallas kernel):
    per bag, the fp32 sum of the rows of its ids in [0, V), cast to the
    table's dtype; ids outside the table add nothing."""
    valid = (ids >= 0) & (ids < table.shape[0])
    rows = table.index_select(0, torch.where(valid, ids, 0).reshape(-1))
    rows = rows.float().reshape(*ids.shape, table.shape[1])
    return torch.where(valid[..., None], rows, 0.0).sum(1).to(table.dtype)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Port of `repro/models/bst.py::embedding_bag`, the jnp oracle that
    JAX's ``ops.embedding_bag(impl="ref")`` runs: gather + segment sum in
    the table's dtype, -1 (any negative id) adds nothing.  An id >= V reads
    NaN, as `jnp.take`'s default fill gives for an out-of-range row, so its
    bag is NaN (the kernels ignore such ids)."""
    b, l = ids.shape
    flat = ids.reshape(-1)
    valid = flat >= 0
    idx = flat.clamp(min=0)
    inside = idx < table.shape[0]
    rows = table.index_select(0, torch.where(inside, idx, 0))
    rows = torch.where(inside[:, None], rows, float("nan"))
    rows = torch.where(valid[:, None], rows, 0.0)
    seg = torch.arange(b, device=ids.device).repeat_interleave(l)
    return torch.zeros((b, table.shape[1]), dtype=table.dtype,
                       device=table.device).index_add_(0, seg, rows)


# --- flash_attention ----------------------------------------------------------

MASKED = -1e30          # the Pallas kernel's mask fill and initial max


def softmax_scale(d: int) -> float:
    """1/sqrt(D) as the Pallas kernel applies it: computed in float64, then
    rounded to fp32 when it meets the fp32 queries."""
    return float(np.float32(1.0 / np.sqrt(d)))


def flash_attention_kernel_ref(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, causal: bool = False,
                               block_k: int = 128) -> torch.Tensor:
    """Plain version of the flash_attention kernel (and of the Pallas
    kernel): online softmax over key tiles of `block_k` in fp32, q scaled
    after its cast to fp32, GQA by broadcasting each kv head over its group
    of query heads (no copy of K/V), the bottom-right causal mask filled
    with -1e30 (a fully masked row averages V), output acc / max(l, 1e-30)
    in q's dtype."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qf = (q.float() * softmax_scale(d)).reshape(b, hkv, h // hkv, sq, d)
    m = torch.full((b, hkv, h // hkv, sq, 1), MASKED, device=q.device)
    lsum = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    for j0 in range(0, sk, block_k):
        kc = k[:, :, None, j0:j0 + block_k].float()
        vc = v[:, :, None, j0:j0 + block_k].float()
        s = qf @ kc.transpose(-1, -2)
        if causal:
            kpos = torch.arange(j0, j0 + kc.shape[3], device=q.device)
            s = torch.where(qpos >= kpos, s, MASKED)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        lsum = lsum * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p @ vc
        m = m_new
    out = acc / lsum.clamp(min=1e-30)
    return out.reshape(b, h, sq, d).to(q.dtype)


def mha_ref(q, k, v, causal: bool = False, scale=None) -> torch.Tensor:
    """Port of JAX's `ref.mha_ref`: unfused attention, K/V repeated over
    each GQA group, causal mask filled with -inf (a fully masked row is
    NaN)."""
    b, h, sq, d = q.shape
    group = h // k.shape[1]
    scale = scale or (1.0 / np.sqrt(d))
    kk = k.repeat_interleave(group, dim=1)
    vv = v.repeat_interleave(group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                          kk.float()) * float(np.float32(scale))
    if causal:
        skv = k.shape[2]
        mask = (torch.arange(sq, device=q.device)[:, None] + (skv - sq)
                >= torch.arange(skv, device=q.device)[None, :])
        logits = torch.where(mask, logits, -torch.inf)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, vv.float()).to(q.dtype)


def flash_attention_ref(q, k, v, causal: bool = False, block_kv: int = 128,
                        scale=None) -> torch.Tensor:
    """Port of JAX's `ref.flash_attention_ref`, the chunked oracle that
    JAX's ``ops.flash_attention(impl="ref")`` runs: -inf mask and -inf
    initial max (a fully masked row is NaN), ``nblk = max(Sk // block_kv,
    1)`` chunks of ``Sk // nblk`` keys (keys past nblk * blk are dropped,
    as in the reference), K/V repeated over each GQA group."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = h // hkv
    scale = scale or (1.0 / np.sqrt(d))
    qf = q.float() * float(np.float32(scale))
    nblk = max(skv // block_kv, 1)
    blk = skv // nblk
    m = torch.full((b, h, sq), -torch.inf, device=q.device)
    lsum = torch.zeros((b, h, sq), device=q.device)
    acc = torch.zeros((b, h, sq, d), device=q.device)
    for i in range(nblk):
        ks = k[:, :, i * blk:(i + 1) * blk].repeat_interleave(group, dim=1)
        vs = v[:, :, i * blk:(i + 1) * blk].repeat_interleave(group, dim=1)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, ks.float())
        if causal:
            qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
            kpos = i * blk + torch.arange(blk, device=q.device)[None, :]
            s = torch.where(qpos >= kpos, s, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        lsum = lsum * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p,
                                                   vs.float())
        m = m_new
    return (acc / lsum.clamp(min=1e-30)[..., None]).to(q.dtype)

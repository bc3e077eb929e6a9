"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here is marked `cuda` and skips without a CUDA device: a CUDA
kernel has no CPU mode (the plain versions are held to the JAX package by
the other `tests/test_torch_*.py` files).  Tolerances: exact for the
pointer kernels (`fused_local_phase`, `steepest_neighbor`,
`block_pathcompress`); 1e-5 (fp32) and 3e-2 (bf16) for `segment_bag` and
2e-5 (fp32) and 2e-2 (bf16) for `flash_attention`, whose sums run in
another order than their plain versions' (whose p stays fp32; the bf16
tensor-core kernel carries it as two bf16 parts, the fp32 one P and V as
two TF32 parts each), with rtol 8e-3 / atol 2e-3 (one bf16 ulp) for the bf16
Sq = Sk = 1024 case.  The models (`repro_torch.models`) at small widths:
the LM's prefill through the attention kernel against the same model with
the plain version (fp32 1e-4; bf16 8 ulps of each row's largest logit),
BST's forward through the bag kernel (1e-5).  Training: the gradients
through the kernels' autograd Functions against autograd through the plain
versions (attention: each within 1e-5 (fp32) or 1e-2 (bf16) of the
tensor's largest |grad|; the bag's table: 1e-5, bf16 one bf16 ulp), a MoE
prefill and decode step on the card against the CPU (1e-4), and the
training launcher on the card (wq's gradient within 1e-4 of its largest
of the CPU's).  This file imports neither jax nor `repro`, so it runs on a
machine that has only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.data import chains
from repro_torch.kernels import _build
from repro_torch.kernels import fused_local_phase as kmod, ops, ref
from repro_torch.kernels import block_pathcompress as bpc_mod
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import segment_bag as bag_mod
from repro_torch.kernels import steepest_neighbor as steepest_mod

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(mode, shape, seed, device):
    rng = np.random.default_rng(seed)
    if mode == "manifold":
        field = rng.permutation(int(np.prod(shape))).reshape(shape).astype(
            np.int32)
    else:
        field = rng.random(shape) < 0.6
    smask = rng.random(shape) < 0.2
    return (torch.from_numpy(field).to(device),
            torch.from_numpy(smask).to(device))


@pytest.mark.parametrize("mode", ["manifold", "cc"])
@pytest.mark.parametrize("conn", [6, 14, 18, 26])
def test_kernel_vs_plain(cuda, mode, conn):
    """Pointers and rounds exactly equal, ragged X, self_mask on and off,
    block_x 1/4/8; each launch counted once."""
    field, smask = _inputs(mode, (13, 11, 9), conn, cuda)
    before = kmod.launches[mode]
    for block_x in (1, 4, 8):
        for sm in (None, smask):
            got, rounds = ops.fused_local_phase(field, conn, mode=mode,
                                                self_mask=sm, block_x=block_x)
            want, wrounds = ref.fused_local_phase_ref(
                field, conn, mode=mode, self_mask=sm, block_x=block_x)
            torch.cuda.synchronize()
            assert got.dtype == want.dtype == torch.int32
            assert torch.equal(got, want) and rounds == wrounds
    assert kmod.launches[mode] - before == 6


def test_kernel_int64_ids(cuda):
    field, smask = _inputs("manifold", (9, 7, 5), 0, cuda)
    got, rounds = kmod.fused_local_phase(field, 14, self_mask=smask,
                                         block_x=4, id_dtype=torch.int64)
    want, wrounds = ref.fused_local_phase_ref(field, 14, self_mask=smask,
                                              block_x=4, id_dtype=torch.int64)
    assert got.dtype == torch.int64
    assert torch.equal(got, want) and rounds == wrounds


def test_kernel_rejects_what_it_cannot_take(cuda):
    field, smask = _inputs("manifold", (5, 4, 3), 1, cuda)
    with pytest.raises(ValueError, match="int32"):
        kmod.fused_local_phase(field.long(), 6)
    with pytest.raises(ValueError, match="contiguous"):
        kmod.fused_local_phase(field.transpose(0, 2), 6)
    with pytest.raises(ValueError, match="self_mask"):
        kmod.fused_local_phase(field, 6, self_mask=smask[:2])


# --- long chains: the resolve pass's worst cases -----------------------------


def _long_chain_field(make, shape, flip, device):
    field = getattr(chains, make)(shape, device=device)
    return (field.flip((1, 2)) if flip else field).contiguous()


@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("make,flip,shape,mode,conn,block_x,min_rounds", [
    ("serpentine_order", False, (4, 64, 64), "manifold", 6, 1, 13),
    ("serpentine_order", True, (4, 64, 64), "manifold", 6, 1, 13),
    ("serpentine_order", False, (3, 256, 256), "manifold", 6, 2, 17),
    ("z_ramp_order", False, (6, 32, 700), "manifold", 6, 4, 11),
    ("z_ramp_order", True, (6, 32, 700), "manifold", 26, 8, 11),
    ("z_line_mask", False, (5, 6, 1000), "cc", 6, 2, 11),
    ("z_line_mask", False, (5, 6, 1000), "cc", 26, 8, 11)])
def test_kernel_vs_plain_long_chains(cuda, make, flip, shape, mode, conn,
                                     block_x, min_rounds, id_dtype):
    """Chains of thousands of hops in one slab, both directions of the ids
    (`repro_torch.data.chains`): pointers and rounds exactly equal, and a
    second launch on the same input gives the same result (the resolve
    pass's races between threads are benign)."""
    field = _long_chain_field(make, shape, flip, cuda)
    want, wrounds = ref.fused_local_phase_ref(field, conn, mode=mode,
                                              block_x=block_x,
                                              id_dtype=id_dtype)
    assert wrounds >= min_rounds
    for _ in range(2):
        got, rounds = kmod.fused_local_phase(field, conn, mode=mode,
                                             block_x=block_x,
                                             id_dtype=id_dtype)
        torch.cuda.synchronize()
        assert got.dtype == id_dtype
        assert torch.equal(got, want) and rounds == wrounds


@pytest.mark.parametrize("mode", ["manifold", "cc"])
def test_kernel_repeat_launches_on_a_smooth_field(cuda, mode):
    """A Perlin field at 96^3 (chains of tens of hops in every direction),
    its top-30% mask for cc, with a self_mask: five launches, each equal to
    the plain version."""
    from repro_torch.core.ids import compute_order
    from repro_torch.data import perlin_noise, quantile
    field = perlin_noise((96, 96, 96), frequency=0.1, seed=3, device=cuda)
    field = compute_order(field) if mode == "manifold" else \
        field > quantile(field, 0.7)
    smask = torch.rand(field.shape, generator=torch.Generator(
        device=cuda).manual_seed(5), device=cuda) < 0.01
    want, wrounds = ref.fused_local_phase_ref(field, 6, mode=mode,
                                              self_mask=smask)
    for _ in range(5):
        got, rounds = kmod.fused_local_phase(field, 6, mode=mode,
                                             self_mask=smask)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and rounds == wrounds


# --- the four stand-alone kernels --------------------------------------------


def _close(got, want, tol):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol,
                               equal_nan=False)


@pytest.mark.parametrize("ties", [False, True], ids=["unique", "ties"])
@pytest.mark.parametrize("conn", [6, 14, 18, 26])
@pytest.mark.parametrize("shape,lead", [
    ((13, 11, 37), 0), ((3, 1, 2), 0),
    ((6, 19, 300), 0),     # y and z past whole tiles (16 rows, 128 z)
    ((1, 9, 40), 0), ((6, 1, 200), 0), ((5, 7, 1), 0), ((1, 1, 1), 0),
    ((9, 7, 3), 0),        # Z = 3: no 16-byte store lines up
    ((7, 5, 33), 1),       # base Y * Z ids into a larger tensor, Y * Z odd
    ((40, 30, 260), 0),
    # 128 tiles: the x-run rule gives runs of ~8 planes on an H100 (132
    # SMs, 4 CTAs each), the last one shorter
    ((130, 512, 512), 0)])
def test_steepest_kernel_vs_plain(cuda, conn, ties, shape, lead):
    """Ragged extents against the streaming stencil's tiles and x-runs,
    each extent 1, a base off the 16-byte grid, runs of one plane (small
    grids) and of several; with ties the offset order decides, so it must
    be the plain one.  One launch a call."""
    rng = np.random.default_rng(conn + 100 * ties + sum(shape))
    full = (shape[0] + lead,) + tuple(shape[1:])
    n = int(np.prod(full))
    order = (rng.integers(0, 4, size=full) if ties
             else rng.permutation(n).reshape(full)).astype(np.int32)
    t = torch.from_numpy(order).to(cuda)[lead:]
    assert t.is_contiguous() and (t.data_ptr() % 16 != 0) == (lead > 0)
    before = steepest_mod.launches[conn]
    got = ops.steepest_neighbor(t, conn)
    want = ref.steepest_neighbor_ref(t, conn)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert steepest_mod.launches[conn] == before + 1


@pytest.mark.parametrize("conn", [6, 26])
def test_stencil_refuses_another_offset_order(cuda, monkeypatch, conn):
    """The stencil's offsets are compile-time constants (`csrc/stencil.cuh`);
    both kernels that run it refuse a Python table in another order, whose
    ties would differ, instead of computing with their own."""
    from repro_torch.core.steepest import neighbor_offsets
    table = list(neighbor_offsets(3, conn))
    table[0], table[1] = table[1], table[0]
    order = torch.arange(60, dtype=torch.int32, device=cuda).reshape(3, 4, 5)
    for mod, call in ((steepest_mod, lambda: steepest_mod.steepest_neighbor(
            order, conn)), (kmod, lambda: kmod.fused_local_phase(order,
                                                                 conn))):
        monkeypatch.setattr(mod, "neighbor_offsets", lambda *a: table)
        with pytest.raises(RuntimeError, match="invalid argument"):
            call()


def _pointers(n, seed):
    rng = np.random.default_rng(seed)
    d = np.minimum(np.arange(n) + rng.integers(0, 64, size=n), n + 40)
    d[rng.random(n) < 0.05] = -1
    return d.astype(np.int32)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n,block,rounds,config,offset,fixpoint", [
    (100, 32, 3, "shared", 0, False), (1005, 100, 2, "shared", 0, False),
    (50, 4096, 4, "shared", 0, False), (100_000, 4096, 6, "shared", 0, False),
    (100_000, 8192, 1, "shared", 0, False),
    (100_000, 40_000, 5, "global", 0, False),  # int32 tile of 160 KB
    (70_000, 65_536, 2, "global", 0, False),
    # the streaming kernel's edges: a base off the 16-byte grid (d[1:]),
    # tile starts off it (block 1001), fewer tiles than persistent CTAs and
    # many more, the largest int64 tile in shared memory (one stage),
    # rounds 1 and 7, an input already at its fixpoint
    (100_000, 4096, 4, "shared", 1, False),
    (100_001, 1001, 3, "shared", 0, False),
    (100_001, 1001, 7, "shared", 3, False),
    (9000, 4096, 4, "shared", 1, False),
    (2 ** 20 + 3, 4096, 4, "shared", 0, False),
    (50_000, 14_528, 3, "shared", 0, False),
    (50_000, 14_528, 2, "shared", 1, False),
    (100_000, 4096, 1, "shared", 0, False),
    (100_000, 4096, 7, "shared", 0, False),
    (100_000, 4096, 4, "shared", 0, True),
    (100_003, 1001, 4, "shared", 1, True)])
def test_block_pathcompress_kernel_vs_plain(cuda, n, block, rounds, config,
                                            offset, fixpoint, dtype):
    """Both launch configurations, exact, twice (the streaming kernel's
    ring of stages); pointers run past n (into the -1 pad) and past their
    tile.  `offset` ids in front of d put its base off the 16-byte grid."""
    d = torch.from_numpy(_pointers(n, n + rounds)).to(cuda, dtype)
    if fixpoint:
        d = ref.block_pathcompress_kernel_ref(d, 64, block)
        assert torch.equal(ref.block_pathcompress_kernel_ref(d, 1, block), d)
    buf = torch.zeros(n + offset, dtype=dtype, device=cuda)
    buf[offset:] = d
    d = buf[offset:]
    assert (d.data_ptr() % 16 != 0) == (offset > 0)
    assert bpc_mod.configuration(ref.snapped_block(n, block),
                                 dtype) == config
    want = ref.block_pathcompress_kernel_ref(d, rounds, block)
    if fixpoint:
        assert torch.equal(want, d)
    before = bpc_mod.launches[config]
    for _ in range(2):
        got = ops.block_pathcompress(d, rounds, block)
        torch.cuda.synchronize()
        assert got.dtype == dtype and torch.equal(got, want)
    # one launch a call in shared memory, one a round in device memory
    assert bpc_mod.launches[config] == before + 2 * (
        1 if config == "shared" else rounds)
    assert torch.equal(ops.block_pathcompress(d, 0, block), d)
    assert bpc_mod.launches[config] == before + 2 * (
        1 if config == "shared" else rounds)


def _bag_case(v, d, b, l, how, id_dtype, table_dtype, device):
    """A normal table and ids from [-3, V + 5) (bag 0 all padding), laid
    out as `how` says: "" contiguous; "table+1" / "ids+1" a view one
    element past a 16-byte boundary; "big" ids past int32's range (int64)
    or at its ends (int32); "bst" BST's field 1 (ids in [V/2, V), -1 pads
    drawn as data/recsys.py draws them)."""
    rng = np.random.default_rng(v + d)
    table = torch.from_numpy(rng.normal(size=(v, d)).astype(np.float32)).to(
        device, table_dtype)
    ids = rng.integers(-3, v + 5, size=(b, l))
    if how == "big":
        big = ([2**31, 2**32 + 1, 2**62, -2**40] if id_dtype == torch.int64
               else [2**31 - 1, -2**31])
        ids.reshape(-1)[::3] = np.resize(big, ids.reshape(-1)[::3].size)
    if how == "bst":
        x = rng.integers(-1, v // 2, size=(b, l))
        ids = np.where(x >= 0, x + v // 2, -1)
    if b:
        ids[0] = -1
    ids = torch.from_numpy(ids).to(device, id_dtype)
    if how == "table+1":
        table = torch.empty(v * d + 1, dtype=table_dtype,
                            device=device)[1:].view(v, d).copy_(table)
    if how == "ids+1":
        ids = torch.empty(b * l + 1, dtype=id_dtype,
                          device=device)[1:].view(b, l).copy_(ids)
    return table, ids


@pytest.mark.parametrize("table_dtype,tol", [(torch.float32, 1e-5),
                                             (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("v,d,b,l,how", [
    (256, 32, 64, 16, ""), (96, 40, 12, 37, ""), (1000, 4, 300, 1, ""),
    (500, 1, 64, 16, ""), (300, 8, 50, 16, ""), (200, 31, 40, 9, ""),
    (200, 33, 40, 16, ""), (1000, 64, 100, 16, ""), (400, 160, 30, 5, ""),
    (256, 32, 40, 17, ""), (256, 32, 20, 61, ""), (256, 16, 10, 100, ""),
    (4096, 32, 65_536, 8, ""),        # several waves of blocks
    (1000, 32, 0, 16, ""), (100, 0, 12, 4, ""), (0, 32, 12, 4, ""),
    (256, 32, 64, 16, "table+1"), (256, 32, 64, 16, "ids+1"),
    (256, 33, 40, 17, "table+1"), (256, 32, 64, 16, "big"),
    (100_000, 32, 4096, 16, "bst")])
def test_segment_bag_kernel_vs_plain(cuda, v, d, b, l, how, id_dtype,
                                     table_dtype, tol):
    """ids from [-3, V + 5): -1 pads, other negative ids and ids >= V add
    nothing; bag 0 is all padding.  Any D, L, base alignment and size;
    B = 0 and D = 0 launch nothing, V = 0 gives zeros."""
    table, ids = _bag_case(v, d, b, l, how, id_dtype, table_dtype, cuda)
    if how:
        assert (table.data_ptr() % 16 != 0) == (how == "table+1")
        assert (ids.data_ptr() % 16 != 0) == (how == "ids+1")
    key = str(table_dtype).removeprefix("torch.")
    before = bag_mod.launches[key]
    got = ops.embedding_bag(table, ids)
    want = (ref.segment_bag_ref(table, ids) if v else
            torch.zeros((b, d), dtype=table_dtype, device=cuda))
    _close(got, want, tol)
    if b:
        assert not got[0].any()
    assert bag_mod.launches[key] == before + (1 if b and d else 0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,h,hkv,sq,sk,d,causal", [
    (1, 4, 2, 128, 256, 64, False),   # GQA
    (1, 4, 2, 64, 192, 112, True),    # causal, Sk > Sq, D = 112
    (1, 4, 2, 128, 64, 4, True),      # causal, Sk < Sq: rows average V
    (2, 8, 8, 100, 100, 160, True),   # Sq not a multiple of 8 rows
    (1, 2, 1, 40, 72, 256, False),    # D = 256: 74 KB of shared memory
    (1, 8, 1, 33, 33, 128, True),     # MQA, a ragged last key tile
    (1, 2, 1, 40, 72, 1, True),       # D = 1: element loads
    (1, 4, 2, 70, 130, 64, True),     # Sk not a multiple of 64 keys
    (2, 4, 1, 200, 136, 128, True)])  # D = 128, Sk < Sq, 4 query tiles
def test_flash_kernel_vs_plain(cuda, b, h, hkv, sq, sk, d, causal, dtype,
                               tol):
    """bf16 runs the tensor-core kernel at every D here (1 to 256); f32 the
    kernel with PV on the tensor cores up to D = 128 and the CUDA-core one
    above; each call adds one to its kernel's count only."""
    q, k, v = _attention_inputs(b, h, hkv, sq, sk, d, dtype, cuda,
                                seed=sq * d + sk)
    key = {torch.float32: "float32" if d <= 128 else "float32_cuda_cores",
           torch.bfloat16: "bfloat16"}[dtype]
    got = _flash_once(q, k, v, causal, key)
    _close(got, ref.flash_attention_kernel_ref(q, k, v, causal=causal), tol)
    if causal and sk < sq:            # the first sq - sk rows: mean of V
        mean = v.float().mean(2).repeat_interleave(h // hkv, dim=1)
        torch.testing.assert_close(got[:, :, 0].float(), mean, rtol=tol,
                                   atol=tol)


def _attention_inputs(b, h, hkv, sq, sk, d, dtype, device, seed, mag=1.0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.normal(size=s) * mag).astype(
        np.float32)).to(device, dtype)
        for s in ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]


def _flash_once(q, k, v, causal, key):
    """ops.flash_attention, asserting that it launched kernel `key` once
    and no other kernel."""
    before = dict(flash_mod.launches)
    got = ops.flash_attention(q, k, v, causal=causal, block_q=q.shape[2],
                              block_k=k.shape[2])
    assert flash_mod.route(q.dtype, q.shape[3]) == key
    assert flash_mod.launches == {n: c + (n == key)
                                  for n, c in before.items()}
    return got


def test_flash_tc_causal_gqa_1024(cuda):
    """bf16, causal GQA at Sq = Sk = 1024, D = 64: 8 query tiles of 128
    rows, the early stop and the diagonal tiles, held to the full-size
    limit (rtol 8e-3, atol 2e-3: one bf16 ulp), not 2e-2."""
    q, k, v = _attention_inputs(2, 8, 2, 1024, 1024, 64, torch.bfloat16,
                                cuda, seed=1024)
    got = _flash_once(q, k, v, True, "bfloat16")
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got.float(), ref.flash_attention_kernel_ref(q, k, v,
                                                    causal=True).float(),
        rtol=8e-3, atol=2e-3)


def test_flash_f32_causal_gqa_1024(cuda):
    """f32, causal GQA at Sq = Sk = 1024, D = 64: 8 query tiles of 128
    rows, the early stop and the diagonal tiles, within 2e-5."""
    q, k, v = _attention_inputs(2, 8, 2, 1024, 1024, 64, torch.float32,
                                cuda, seed=1024)
    got = _flash_once(q, k, v, True, "float32")
    _close(got, ref.flash_attention_kernel_ref(q, k, v, causal=True), 2e-5)


@pytest.mark.parametrize("dtype,tol,key", [
    (torch.float32, 2e-5, "float32"),
    (torch.bfloat16, 2e-2, "bfloat16")])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_tc_large_scores(cuda, causal, dtype, tol, key):
    """q and k times 8 (scores of hundreds): the online rescale of m, l and
    the accumulator across key tiles.  In f32 the reference's own sums are
    more than 2e-5 from exact here; the kernel sums each score in its
    order (tests/test_torch_kernels.py models why)."""
    q, k, v = _attention_inputs(1, 4, 2, 200, 300, 64, dtype, cuda, seed=8)
    q, k = q * 8, k * 8
    got = _flash_once(q, k, v, causal, key)
    _close(got, ref.flash_attention_kernel_ref(q, k, v, causal=causal), tol)


@pytest.mark.parametrize("dtype,tol,key", [
    (torch.float32, 2e-5, "float32"),
    (torch.float32, 2e-5, "float32_cuda_cores"),
    (torch.bfloat16, 2e-2, "bfloat16"),
    (torch.bfloat16, 2e-2, "bfloat16_cuda_cores")])
def test_flash_kernel_unaligned_base(cuda, dtype, tol, key):
    """q, k, v and the output one element past a 16-byte boundary: element
    loads and stores in place of the 16-byte ones."""
    d = {"float32": 64, "float32_cuda_cores": 160, "bfloat16": 64,
         "bfloat16_cuda_cores": 320}[key]
    q, k, v = _attention_inputs(1, 4, 2, 96, 80, d, dtype, cuda, seed=d)
    q, k, v = (torch.cat([t.new_zeros(1), t.reshape(-1)])[1:].view(t.shape)
               for t in (q, k, v))
    assert all(t.data_ptr() % 16 for t in (q, k, v))
    before = dict(flash_mod.launches)
    out = torch.empty(q.numel() + 1, dtype=dtype, device=cuda)[1:]
    fn = _build.entry("flash_attention", flash_mod.SYMBOLS[key],
                      flash_mod._ARGTYPES)
    with torch.cuda.device(cuda):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 1, 4, 2, 96, 80, d, ref.softmax_scale(d), 1,
                 _build.stream(q))
    assert err == 0 and flash_mod.route(dtype, d) == key
    got = ops.flash_attention(q, k, v, causal=True, block_q=96, block_k=80)
    assert flash_mod.launches[key] == before[key] + 1
    want = ref.flash_attention_kernel_ref(q, k, v, causal=True)
    _close(out.view(q.shape), want, tol)
    _close(got, want, tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("sq,sk,causal", [(1, 1, False), (1, 1, True),
                                          (1, 77, True), (65, 1, True)])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_kernel_single_rows(cuda, sq, sk, causal, d, dtype, tol):
    """Sq = 1 and Sk = 1 (one key: the output is v, or the mean of V for a
    fully masked row), on both tile shapes of each tensor-core kernel."""
    q, k, v = _attention_inputs(2, 4, 1, sq, sk, d, dtype, cuda,
                                seed=sq + 7 * sk)
    got = _flash_once(q, k, v, causal, str(dtype).removeprefix("torch."))
    _close(got, ref.flash_attention_kernel_ref(q, k, v, causal=causal), tol)


@pytest.mark.parametrize("dtype,tol,key,d", [
    (torch.float32, 2e-5, "float32_cuda_cores", 320),
    (torch.bfloat16, 2e-2, "bfloat16_cuda_cores", 320),
    (torch.float32, 2e-5, "float32_cuda_cores", 129)])
@pytest.mark.parametrize("sq,sk,causal", [(40, 72, False), (96, 64, True)])
def test_flash_kernel_head_dim_320(cuda, sq, sk, causal, dtype, tol, key, d):
    """D = 320 (> 256) runs the CUDA-core kernel in both dtypes, its output
    columns in two chunks (256 + 64); f32 takes it from D = 129 on."""
    q, k, v = _attention_inputs(1, 4, 2, sq, sk, d, dtype, cuda,
                                seed=d + sq)
    got = _flash_once(q, k, v, causal, key)
    _close(got, ref.flash_attention_kernel_ref(q, k, v, causal=causal), tol)


def test_new_kernels_reject_what_they_cannot_take(cuda):
    t = torch.zeros(2, 3, 4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        steepest_mod.steepest_neighbor(t.long(), 6)
    with pytest.raises(ValueError, match="contiguous"):
        steepest_mod.steepest_neighbor(t.transpose(0, 2), 6)
    with pytest.raises(ValueError, match="1-D"):
        bpc_mod.block_pathcompress(t)
    with pytest.raises(ValueError, match="int32 or"):
        bpc_mod.block_pathcompress(t.reshape(-1).float())
    table = torch.zeros(8, 4, device=cuda)
    with pytest.raises(ValueError, match="ids must be a CUDA tensor"):
        bag_mod.segment_bag(table, torch.zeros(2, 3, dtype=torch.int32))
    with pytest.raises(ValueError, match="float32 or"):
        bag_mod.segment_bag(table.half(), t[0])
    q = torch.zeros(1, 2, 8, 1248, device=cuda)
    with pytest.raises(ValueError, match="1247"):
        ops.flash_attention(q, q, q)
    q = torch.zeros(1, 2, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        flash_mod.flash_attention(q, q.bfloat16(), q)


@pytest.mark.parametrize("key, d", [
    ("bfloat16", flash_mod.TC_MAX_HEAD_DIM + 1),
    ("bfloat16_cuda_cores", flash_mod.TC_MAX_HEAD_DIM),
    ("float32", flash_mod.F32_TC_MAX_HEAD_DIM + 1),
    ("float32_cuda_cores", flash_mod.F32_TC_MAX_HEAD_DIM)])
def test_flash_bf16_entry_points_meet_at_tc_max_head_dim(cuda, key, d):
    """The two C entry points of each dtype split the head dims where
    `route` does: each returns cudaErrorInvalidValue (1) on the other's
    side."""
    dtype = torch.float32 if key.startswith("float32") else torch.bfloat16
    q = torch.zeros(1, 2, 8, d, dtype=dtype, device=cuda)
    out = torch.empty_like(q)
    fn = _build.entry("flash_attention", flash_mod.SYMBOLS[key],
                      flash_mod._ARGTYPES)
    with torch.cuda.device(cuda):
        err = fn(q.data_ptr(), q.data_ptr(), q.data_ptr(), out.data_ptr(),
                 1, 2, 2, 8, 8, d, 0.1, 0, _build.stream(q))
    assert err == 1


# --- the graph domain: no kernel of its own, card == CPU ----------------------


def _graph_cases():
    """(name, n, senders, receivers): the Freudenthal edge list of a ragged
    11x9x7 grid (connectivity 14), and a random multigraph whose ids leave
    [0, n) on both sides (JAX's rules: a gather wraps a negative id once
    and clamps, the segment max drops a sender out of range)."""
    from repro_torch.data import grid_edge_list
    shape = (11, 9, 7)
    s, r = grid_edge_list(shape, 14, device="cpu")
    yield "tet 11x9x7", int(np.prod(shape)), s.numpy(), r.numpy()
    rng = np.random.default_rng(19)
    n, m = 300, 900
    a, b = rng.integers(-40, n + 40, m), rng.integers(-40, n + 40, m)
    yield "random, ids out of range", n, np.concatenate([a, b]), \
        np.concatenate([b, a])


@pytest.mark.parametrize("geometry", [False, True])
def test_graph_routes_card_equals_cpu(cuda, geometry):
    """cc, ms and threshold_sweep with domain="graph" on the card equal the
    same calls with device="cpu": labels, dtypes and every meta count."""
    from repro_torch.interop import to_numpy
    from repro_torch.topology import TopologyRequest, submit
    for name, n, s, r in _graph_cases():
        rng = np.random.default_rng(n)
        field = rng.random(n).astype(np.float32)
        mask = np.ones(n, bool) if geometry else field > 0.6
        edges = dict(domain="graph", senders=s, receivers=r)
        reqs = [TopologyRequest("cc", mask=mask, **edges),
                TopologyRequest("ms", order=rng.permutation(n).astype(
                    np.int32), **edges),
                TopologyRequest("threshold_sweep", field=field,
                                thresholds=np.array([0.2, 0.9], np.float32),
                                **edges)]
        for req in reqs:
            got = submit(req, device=cuda)
            want = to_numpy(submit(req, device="cpu"))
            assert got.meta == want.meta, (name, req.query)
            for f in ("labels", "ascending", "descending", "segmentation"):
                w = getattr(want, f)
                if w is not None:
                    g = getattr(got, f)
                    assert g.is_cuda, (name, req.query, f)
                    np.testing.assert_array_equal(to_numpy(g), w)
                    assert to_numpy(g).dtype == w.dtype


def test_grid_edge_list_on_the_card(cuda):
    from repro_torch.data import grid_edge_list
    for shape, conn in (((11, 9, 7), 14), ((6, 5), 6), ((5, 4, 3), 26)):
        got = grid_edge_list(shape, conn, device=cuda)
        want = grid_edge_list(shape, conn, device="cpu")
        for g, w in zip(got, want):
            assert g.is_cuda and torch.equal(g.cpu(), w)


def test_distributed_one_rank_nccl_equals_pure(cuda, tmp_path):
    """The distributed grid backend on a 1-rank NCCL group (FileStore) at
    64^3, both table modes, the mask gathered and not: labels equal the pure
    port's on the card, bit for bit, and the fused kernel runs once a call."""
    import torch.distributed as dist
    from repro_torch.core.connected_components import \
        connected_components_grid
    from repro_torch.core.distributed import (
        distributed_connected_components, distributed_manifold,
        make_dpc_mesh)
    from repro_torch.core.ms_segmentation import (ascending_manifold,
                                                  descending_manifold)
    shape = (64, 64, 64)
    order, _ = _inputs("manifold", shape, 64, cuda)
    mask, _ = _inputs("cc", shape, 65, cuda)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_dpc_mesh((1, 1, 1), device=cuda)
        assert mesh.backend == "nccl" and not mesh.staged
        for conn in (6, 26):
            want = {True: descending_manifold(order, conn)[0],
                    False: ascending_manifold(order, conn)[0]}
            want_cc = connected_components_grid(mask, conn).labels
            for mode in ("replicated", "sharded"):
                for desc in (True, False):
                    before = dict(kmod.launches)
                    got, stats = distributed_manifold(
                        order, mesh, shape, conn, descending=desc,
                        table_mode=mode)
                    assert kmod.launches["manifold"] == \
                        before["manifold"] + 1
                    assert got.is_cuda and got.dtype == torch.int32
                    assert torch.equal(got.reshape(-1), want[desc]), \
                        (conn, mode, desc)
                    assert int(stats.converged) == 1
                    assert int(stats.kernel_rounds) >= 1
                for gm in (True, False):
                    got, stats = distributed_connected_components(
                        mask, mesh, shape, conn, gather_mask=gm,
                        table_mode=mode)
                    assert torch.equal(got, want_cc), (conn, mode, gm)
                    assert int(stats.converged) == 1
    finally:
        dist.destroy_process_group()


def test_distributed_batch_one_rank_nccl_equals_single_calls(cuda, tmp_path):
    """The batched grid entry points on a 1-rank NCCL group at 64^3, both
    table modes: each item of a B = 3 batch of order fields and of masks
    equals its single call (labels and every stats field) and the pure
    port on the card; a batch launches the fused kernel B times."""
    import torch.distributed as dist
    from repro_torch.core.connected_components import \
        connected_components_grid
    from repro_torch.core.distributed import (
        distributed_connected_components,
        distributed_connected_components_batch, distributed_manifold,
        distributed_manifold_batch, make_dpc_mesh)
    from repro_torch.core.ms_segmentation import descending_manifold
    shape, conn = (64, 64, 64), 6
    orders = torch.stack([_inputs("manifold", shape, 70 + i, cuda)[0]
                          for i in range(3)])
    masks = torch.stack([_inputs("cc", shape, 80 + i, cuda)[0]
                         for i in range(3)])
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_dpc_mesh((1, 1, 1), device=cuda)
        for mode in ("replicated", "sharded"):
            for batch_fn, single_fn, x, kind in (
                    (distributed_manifold_batch, distributed_manifold,
                     orders, "manifold"),
                    (distributed_connected_components_batch,
                     distributed_connected_components, masks, "cc")):
                before = kmod.launches[kind]
                got, stats = batch_fn(x, mesh, shape, conn, table_mode=mode)
                assert kmod.launches[kind] == before + 3
                assert got.is_cuda and got.shape == (3,) + shape
                for b in range(3):
                    want, st = single_fn(x[b], mesh, shape, conn,
                                         table_mode=mode)
                    assert torch.equal(got[b], want), (mode, kind, b)
                    pure = (descending_manifold(x[b], conn)[0]
                            if kind == "manifold" else
                            connected_components_grid(x[b], conn).labels)
                    assert torch.equal(got[b].reshape(-1),
                                       pure.reshape(-1)), (mode, kind, b)
                    for field, v in zip(st._fields, st):
                        w = getattr(stats, field)
                        assert w.shape == (3,) and w.dtype == v.dtype
                        assert w[b].item() == v.item(), (mode, kind, field)
    finally:
        dist.destroy_process_group()


def test_distributed_graph_one_part_nccl_equals_pure(cuda, tmp_path):
    """The distributed graph backend with one partition (table_size 0, the
    early return: no table, comm_phases 0) on a 1-rank NCCL group, the
    11x9x7 tet mesh, both table modes, a mask and a batch of two: labels
    equal the pure graph cc on the card; the path launches no kernel."""
    import torch.distributed as dist
    from repro_torch.core.connected_components import \
        connected_components_graph
    from repro_torch.core.distributed import make_dpc_mesh
    from repro_torch.core.distributed_graph import (
        GraphDecomp, distributed_connected_components_graph,
        distributed_connected_components_graph_batch)
    from repro_torch.data import grid_edge_list
    shape = (11, 9, 7)
    n = int(np.prod(shape))
    s, r = grid_edge_list(shape, 14, device="cpu")
    dec = GraphDecomp(n, s.numpy(), r.numpy(), 1)
    assert dec.table_size == 0
    rng = np.random.default_rng(5)
    masks = torch.from_numpy(rng.random((2, n)) < 0.6).to(cuda)
    sc, rc = s.to(cuda).to(torch.int32), r.to(cuda).to(torch.int32)
    want = [connected_components_graph(m, sc, rc).labels for m in masks]
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_dpc_mesh(1, device=cuda)
        before = dict(kmod.launches)
        for mode in ("replicated", "sharded"):
            got, stats = distributed_connected_components_graph(
                masks[0], dec, mesh, table_mode=mode)
            assert got.is_cuda and torch.equal(got, want[0]), mode
            assert int(stats.comm_phases) == 0
            assert int(stats.converged) == 1
            got, stats = distributed_connected_components_graph_batch(
                masks, dec, mesh, table_mode=mode)
            for b in range(2):
                assert torch.equal(got[b], want[b]), (mode, b)
            assert stats.comm_phases.tolist() == [0, 0]
        assert dict(kmod.launches) == before
    finally:
        dist.destroy_process_group()


def _capacity_sum(engine, kind):
    """Slots a pure grid executable of `kind` ran, over every execution:
    the fused kernel's launches on that path (one a slot, dummies too)."""
    return sum(key[-2] * runs for key, runs in
               engine.cache_info()["runs_per_executable"].items()
               if key[:3] == ("grid", "pure", kind))


def _serve_equal(got, want):
    assert (got.query, got.tag) == (want.query, want.tag)
    for f in ("labels", "ascending", "descending", "segmentation"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.is_cuda and a.dtype == b.dtype and torch.equal(a, b), f


def test_serve_engine_on_card_equals_submit_many(cuda):
    """The serving engine at the serve config's smoke widths on the card:
    results == `submit_many` bit for bit, on the card; the fused kernel
    launches once a grid slot (the capacity sum of the grid buckets), and
    a replay builds nothing."""
    from repro_torch.configs.serve_topology import smoke_config
    from repro_torch.serve import TopologyEngine
    from repro_torch.serve.workload import synthetic_requests
    from repro_torch.topology import submit_many
    cfg = smoke_config()
    reqs = synthetic_requests(24, cfg.shapes, cfg.mix, cfg.connectivity,
                              cfg.sweep_k, seed=0)
    eng = TopologyEngine(min_extent=cfg.min_extent, max_batch=cfg.max_batch,
                         slot_cost_cells=cfg.slot_cost_cells)
    assert eng.device.type == "cuda"
    for _ in range(2):
        before = dict(kmod.launches)
        got = eng.submit_batch(reqs)
        torch.cuda.synchronize()
        launched = {k: kmod.launches[k] - before[k] for k in before}
        if _ == 0:
            misses = eng.stats.cache_misses
    assert eng.stats.cache_misses == misses
    half = {k: _capacity_sum(eng, k) for k in ("manifold", "cc")}
    assert all(v % 2 == 0 for v in half.values())
    assert launched == {k: v // 2 for k, v in half.items()}, launched
    for g, w in zip(got, submit_many(reqs)):
        _serve_equal(g, w)


def test_serve_async_engine_on_card_equals_submit_many(cuda):
    """The async plane on a VirtualClock over a smoke-config trace, the
    execution time charged to the clock: every handle == `submit_many`,
    the flush reasons sum to the executions."""
    from repro_torch.configs.serve_topology import smoke_config
    from repro_torch.serve import AsyncTopologyEngine, VirtualClock
    from repro_torch.serve.workload import synthetic_trace
    from repro_torch.topology import submit_many
    cfg = smoke_config()
    trace = synthetic_trace(24, cfg.shapes, cfg.mix, cfg.connectivity,
                            cfg.sweep_k, seed=1, rate=cfg.rate,
                            deadline_slack=cfg.deadline_slack)
    reqs = trace.requests()
    eng = AsyncTopologyEngine(min_extent=cfg.min_extent,
                              max_batch=cfg.max_batch, clock=VirtualClock(),
                              charge_execution_time=True)
    handles = []
    for req, (t, dl) in zip(reqs, trace.arrivals):
        if t > eng.clock.now():
            eng.advance(t - eng.clock.now())
        handles.append(eng.submit(req, deadline=dl))
    eng.drain()
    s = eng.stats
    assert s.completed == len(reqs) and s.failures == 0
    assert s.batches == (s.flush_capacity + s.flush_deadline + s.flush_drain
                         + s.flush_retry)
    for h, w in zip(handles, submit_many(reqs)):
        _serve_equal(h.result(), w)


def test_serve_distributed_engine_one_rank_nccl(cuda, tmp_path):
    """The engine's distributed buckets on a 1-rank NCCL group at 32^3: an
    ms and a three-threshold sweep in one `submit_batch` == the facade's
    distributed routes (labels and stats) and the pure routes; one batched
    call a bucket, one fused launch a slot: 2 manifold, and 3 cc masks at
    capacity 4 (one inert dummy block)."""
    import torch.distributed as dist
    from repro_torch.core.distributed import make_dpc_mesh
    from repro_torch.core.ids import compute_order
    from repro_torch.serve import TopologyEngine
    from repro_torch.topology import TopologyRequest, submit
    shape = (32, 32, 32)
    field = torch.from_numpy(np.random.default_rng(9).standard_normal(
        shape).astype(np.float32)).to(cuda)
    thr = np.quantile(field.cpu().numpy(), [0.5, 0.7, 0.9]).astype(
        np.float32)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_dpc_mesh((1, 1, 1), device=cuda)
        base = dict(backend="distributed", mesh=mesh, grid_shape=shape,
                    connectivity=6)
        reqs = [TopologyRequest("ms", order=compute_order(field), tag="ms",
                                **base),
                TopologyRequest("threshold_sweep", field=field,
                                thresholds=thr, tag="sw", **base)]
        eng = TopologyEngine()
        before = dict(kmod.launches)
        got = eng.submit_batch(reqs)
        assert {k: kmod.launches[k] - before[k] for k in before} == \
            {"manifold": 2, "cc": 4}
        assert eng.stats.batches == 2
        assert eng.stats.padded_cells == (2 + 4) * 32 ** 3
        for g, req in zip(got, reqs):
            want = submit(req)
            _serve_equal(g, want)
            assert g.stats == want.stats
            pure = submit(dataclasses.replace(req, backend="pure", mesh=None,
                                              grid_shape=None))
            _serve_equal(dataclasses.replace(g, stats=None), pure)
    finally:
        dist.destroy_process_group()


# --- the LM and BST models on the card (repro_torch.models) -------------------


def _card_lm_config(dtype):
    """llama3.2-1b's head layout (D = 64, GQA 4:1) at a small width."""
    from repro_torch.models.lm import LMConfig
    return LMConfig(name="card-lm", n_layers=2, d_model=256, n_heads=4,
                    n_kv_heads=1, d_ff=512, vocab=1000, d_head=64,
                    param_dtype=dtype, compute_dtype=dtype)


def _row_ulps(got, want):
    """|got - want| in bf16 ulps of each row's largest |want|."""
    top = want.float().abs().amax(-1, keepdim=True)
    return (got.float() - want.float()).abs() / torch.exp2(
        torch.floor(torch.log2(top)) - 7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1, 300])
def test_lm_prefill_kernel_vs_plain(cuda, dtype, s):
    """Prefill launches the flash_attention kernel once a layer (its route
    for the dtype), decode none; logits and caches against the same model
    with attention through the plain version: fp32 within 1e-4 (the kernel
    within 2e-5 of plain, through two layers), bf16 within 8 ulps of each
    row's largest logit (one ulp of the attention output a layer)."""
    from repro_torch.models import lm
    cfg = _card_lm_config(dtype)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = lm.init_params(gen, cfg)
    tok = torch.randint(0, cfg.vocab, (3, s), generator=gen, device=cuda)
    key = flash_mod.route(dtype, 64)
    before = dict(flash_mod.launches)
    got, cache = lm.prefill(params, tok, cfg, max_len=s + 2)
    assert flash_mod.launches[key] == before[key] + cfg.n_layers
    want, wcache = lm.prefill(params, tok, cfg, max_len=s + 2, impl="plain")
    assert flash_mod.launches[key] == before[key] + cfg.n_layers
    nxt = want.argmax(-1)[:, None]
    dgot, _ = lm.decode_step(params, cache, nxt, cfg)
    dwant, _ = lm.decode_step(params, wcache, nxt, cfg)
    assert flash_mod.launches == {k: before[k] + cfg.n_layers * (k == key)
                                  for k in before}
    if dtype == torch.float32:
        for g, w in ((got, want), (dgot, dwant), (cache["k"], wcache["k"]),
                     (cache["v"], wcache["v"])):
            _close(g, w, 1e-4)
    else:
        assert float(_row_ulps(got, want).max()) <= 8
        assert float(_row_ulps(dgot, dwant).max()) <= 8


def test_bst_forward_kernel_vs_plain(cuda):
    """BST's smoke config on the card: two segment_bag launches a forward,
    logits within 1e-5 of the bags' plain version and of the CPU's;
    retrieval launches none and gives the CPU's ids."""
    from repro_torch.configs.bst import smoke_config
    from repro_torch.data import recsys
    from repro_torch.models import bst
    cfg = smoke_config()
    params = bst.init_params(torch.Generator(device=cuda).manual_seed(0),
                             cfg)
    host = {k: v.cpu() for k, v in params.items() if torch.is_tensor(v)}
    host["blocks"] = [{k: v.cpu() for k, v in b.items()}
                      for b in params["blocks"]]
    host["mlp"] = [{k: v.cpu() for k, v in m.items()} for m in params["mlp"]]
    b = recsys.bst_batch(cfg, 1024, seed=0)
    before = bag_mod.launches["float32"]
    got = bst.forward(params, recsys.to_tensors(b, cuda), cfg)
    assert bag_mod.launches["float32"] == before + cfg.n_multihot_fields
    _close(got, bst.forward(params, recsys.to_tensors(b, cuda), cfg,
                            impl="plain"), 1e-5)
    _close(got.cpu(), bst.forward(host, recsys.to_tensors(b, "cpu"), cfg),
           1e-5)
    r = recsys.retrieval_batch(cfg, 1, 2048, seed=0)
    before = bag_mod.launches["float32"]
    vals, ids = bst.retrieval_step(params, recsys.to_tensors(r, cuda), cfg)
    assert bag_mod.launches["float32"] == before
    hvals, hids = bst.retrieval_step(host, recsys.to_tensors(r, "cpu"), cfg)
    assert torch.equal(ids.cpu(), hids)
    _close(vals.cpu(), hvals, 1e-5)


def test_launcher_lm_mode_on_the_card(cuda):
    """`repro_torch.launch.serve`'s LM mode at the smoke config on the card:
    one kernel launch a layer a prefill (a warm-up and LM_RUNS timed ones)."""
    from repro_torch.launch import serve
    before = flash_mod.launches["float32"]
    tps = serve.main(["--arch", "llama3.2-1b", "--smoke", "--batch", "2",
                      "--prompt-len", "40", "--gen", "3"])
    assert tps > 0
    assert flash_mod.launches["float32"] == before + 2 * (serve.LM_RUNS + 1)


# --- training: the kernels' gradients, MoE, the launcher ------------------------


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("b,h,hkv,sq,sk,d,causal", [
    (2, 4, 2, 130, 130, 64, True),
    (1, 8, 2, 40, 300, 128, True),
    (1, 4, 4, 70, 33, 64, True),          # Sq > Sk: rows that see no key
    (2, 2, 1, 17, 65, 32, False),
    (1, 2, 1, 50, 50, 320, True),         # the CUDA-core kernel
])
def test_flash_gradient_vs_plain_autograd(cuda, b, h, hkv, sq, sk, d, causal,
                                          dtype, tol):
    """On a CUDA tensor `ops.flash_attention` gives an output with a
    grad_fn (the kernel's forward, `ops.attention_backward`); dq, dk, dv
    within `tol` of each tensor's largest |grad| of autograd through the
    plain version, one launch a forward."""
    gen = torch.Generator(device=cuda).manual_seed(sq + sk)
    q = torch.randn(b, h, sq, d, generator=gen, device=cuda, dtype=dtype)
    k, v = (torch.randn(b, hkv, sk, d, generator=gen, device=cuda,
                        dtype=dtype) for _ in range(2))
    do = torch.randn(b, h, sq, d, generator=gen, device=cuda, dtype=dtype)
    key = flash_mod.route(dtype, d)
    before = flash_mod.launches[key]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=causal, check_tiles=False)
    assert out.grad_fn is not None
    assert flash_mod.launches[key] == before + 1
    out.backward(do)
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    ref.flash_attention_kernel_ref(*plain, causal=causal).backward(do)
    torch.cuda.synchronize()
    for got, want in zip(leaves, plain):
        assert got.grad.dtype == dtype
        lim = tol * float(want.grad.float().abs().max())
        assert float((got.grad.float() - want.grad.float()).abs().max()) \
            <= lim
    assert flash_mod.launches[key] == before + 1      # backward: no launch


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2 ** -8)])
def test_bag_gradient_vs_plain_autograd(cuda, dtype, tol):
    """`ops.embedding_bag` on a CUDA table has a grad_fn; the table's
    gradient (`bag_backward`: index_add in fp32, ids < 0 and >= V adding
    nothing) against autograd through the plain version in fp32 on the
    same values (bf16: within one bf16 ulp)."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    table = torch.randn(5000, 32, generator=gen, device=cuda).to(dtype)
    ids = torch.randint(-1, 5000, (700, 16), generator=gen, device=cuda)
    ids[0, 0], ids[3, 5] = 5000, 9999                   # past the table
    dout = torch.randn(700, 32, generator=gen, device=cuda).to(dtype)
    t = table.clone().requires_grad_()
    out = ops.embedding_bag(t, ids)
    assert out.grad_fn is not None
    out.backward(dout)
    plain = table.float().requires_grad_()
    ref.segment_bag_ref(plain, ids).backward(dout.float())
    torch.cuda.synchronize()
    assert t.grad.dtype == dtype
    _close(t.grad.float(), plain.grad, tol)


def test_moe_prefill_on_card_equals_cpu(cuda):
    """deepseek-moe-16b's smoke config: prefill and a decode step on the
    card (the attention kernel, fp32) against the same weights on the CPU
    (the plain version): logits within 1e-4, greedy tokens equal; the
    kernel once a layer a prefill."""
    from repro_torch.configs import deepseek_moe_16b
    from repro_torch.models import lm
    cfg = deepseek_moe_16b.smoke_config()
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    card = {k: v.to(cuda) for k, v in params.items() if k != "layers"}
    card["layers"] = [{k: v.to(cuda) for k, v in lp.items()}
                      for lp in params["layers"]]
    tok = torch.randint(0, cfg.vocab, (3, 40),
                        generator=torch.Generator().manual_seed(1))
    before = flash_mod.launches["float32"]
    got, cache = lm.prefill(card, tok.to(cuda), cfg, max_len=41)
    assert flash_mod.launches["float32"] == before + cfg.n_layers
    want, wcache = lm.prefill(params, tok, cfg, max_len=41)
    _close(got.cpu(), want, 1e-4)
    nxt = want.argmax(-1)[:, None]
    assert torch.equal(got.argmax(-1).cpu(), nxt[:, 0])
    dgot, _ = lm.decode_step(card, cache, nxt.to(cuda), cfg)
    dwant, _ = lm.decode_step(params, wcache, nxt, cfg)
    _close(dgot.cpu(), dwant, 1e-4)


def test_launch_train_on_the_card(cuda, tmp_path):
    """Five `launch.train` steps on the card at the smoke config (2 x 2
    attention launches a step under remat, 2 an eval batch); one gradient
    of `lm.loss_fn` on the card reaches every layer's wq through the
    kernel's backward and equals the CPU's within 1e-4 of its largest."""
    from repro_torch.configs import llama3_2_1b
    from repro_torch.launch import train
    from repro_torch.models import lm
    before = flash_mod.launches["float32"]
    loss, report = train.main(["--smoke", "--steps", "5", "--batch", "2",
                               "--seq", "32", "--ckpt-dir", str(tmp_path),
                               "--ckpt-every", "2"])
    assert np.isfinite(loss) and report["restarts"] == 0
    assert flash_mod.launches["float32"] == before + 5 * 2 * 2 + 4 * 2
    cfg = llama3_2_1b.smoke_config()
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    tok = torch.randint(0, cfg.vocab, (2, 33),
                        generator=torch.Generator().manual_seed(2))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    grads = []
    for dev in (cuda, torch.device("cpu")):
        p = {k: v.to(dev).requires_grad_() for k, v in params.items()
             if k != "layers"}
        p["layers"] = [{k: v.to(dev).requires_grad_() for k, v in lp.items()}
                       for lp in params["layers"]]
        lm.loss_fn(p, {k: v.to(dev) for k, v in batch.items()},
                   cfg)[0].backward()
        grads.append([lp["wq"].grad.cpu() for lp in p["layers"]])
    for got, want in zip(*grads):
        assert float(got.abs().max()) > 0
        _close(got, want, 1e-4 * float(want.abs().max()))


def _gnn_case(arch):
    """(smoke config, numpy batch) of a GNN arch, from the port's own
    generators; GAT on a sampled batch with padded edges."""
    from repro_torch import configs
    from repro_torch.data import graphs
    cfg = configs.get(arch).smoke_config()
    if arch == "gat_cora":
        indptr, indices = graphs.random_csr(600, 6, seed=1)
        rng = np.random.default_rng(2)
        feats = rng.standard_normal((600, cfg.d_in)).astype(np.float32)
        sampler = graphs.NeighborSampler(indptr, indices, (4, 3), seed=3)
        return cfg, graphs.sampled_batch(sampler, feats,
                                         rng.integers(0, 7, 600), 16)
    if arch == "meshgraphnet":
        return cfg, graphs.mesh_grid_graph(9, 7, seed=4)
    cfg = dataclasses.replace(cfg, triplet_chunks=4) if arch == "dimenet" \
        else cfg
    return cfg, graphs.molecule_batch(6, 10, 24, seed=5)


@pytest.mark.parametrize("arch", ["gat_cora", "schnet", "meshgraphnet",
                                  "dimenet"])
def test_gnn_on_card_equals_cpu(cuda, arch):
    """A GNN's forward, loss and every gradient on the card against the
    same parameters and batch on the CPU (fp32, TF32 off): outputs and loss
    within 1e-5, gradients within 1e-4, of the tensor's largest |value|
    (the card's `index_add_` sums by atomics, in no fixed order).  No kernel
    of `repro_torch.kernels` launches."""
    from repro_torch.interop import gnn_batch_from_numpy
    from repro_torch.models import gnn
    from repro_torch.tree import tree_leaves, tree_map
    cfg, batch = _gnn_case(arch)
    params = gnn.init_params(torch.Generator().manual_seed(0), cfg)
    counts = [dict(m.launches) for m in (kmod, steepest_mod, bpc_mod,
                                         flash_mod, bag_mod)]
    results = []
    for dev in (cuda, torch.device("cpu")):
        p = tree_map(lambda t: t.to(dev).requires_grad_(), params)
        b = gnn_batch_from_numpy(batch, dev)
        out = gnn.apply(p, b, cfg)
        loss, _ = gnn.loss_fn(p, b, cfg)
        loss.backward()
        results.append((out.detach().cpu(), loss.detach().cpu(),
                        [t.grad.cpu() for t in tree_leaves(p)]))
    (out, loss, grads), (wout, wloss, wgrads) = results
    _close(out, wout, 1e-5 * float(wout.abs().max()))
    _close(loss, wloss, 1e-5 * float(wloss.abs()))
    for got, want in zip(grads, wgrads):
        _close(got, want, 1e-4 * float(want.abs().max()) + 1e-12)
    assert counts == [dict(m.launches) for m in (kmod, steepest_mod, bpc_mod,
                                                 flash_mod, bag_mod)]


# --- the LM on a mesh: two gloo ranks sharing the card ------------------------

MESH_LR = 1e-3


def _mesh_cfgs():
    """(llama smoke, deepseek smoke with shard_map, its one-rank "local"
    twin with dp_shards 2), fp32."""
    from repro_torch import configs
    dense = configs.get("llama3.2-1b").smoke_config()
    moe = configs.get("deepseek-moe-16b").smoke_config()
    shard = dataclasses.replace(moe, moe=dataclasses.replace(
        moe.moe, dispatch="shard_map"))
    local = dataclasses.replace(moe, moe=dataclasses.replace(
        moe.moe, dispatch="local", dp_shards=2))
    return dense, shard, local


def _mesh_step(params, batch, cfg, mesh):
    """One AdamW step: (loss, gradients, updated parameters); on a mesh
    from each rank's blocks, gathered whole."""
    from repro_torch.models import lm
    from repro_torch.optim import adamw, global_norm
    from repro_torch.runtime.meshctx import LOGICAL_AXES, use_mesh
    from repro_torch.tree import tree_map
    if mesh is not None:
        params = lm.shard_params(params, cfg, mesh)
        batch = {k: mesh.block(v, LOGICAL_AXES["dp"], 0)
                 for k, v in batch.items()}
    opt = adamw(MESH_LR, norm_fn=global_norm if mesh is None
                else lm.global_norm_fn(cfg, mesh))
    with use_mesh(mesh):
        leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, _ = lm.loss_fn(leaves, batch, cfg)
        loss.backward()
        grads = tree_map(lambda t: t.grad, leaves)
        new, _, _ = opt.update(grads, opt.init(params), params)
    if mesh is not None:
        grads = lm.unshard_params(grads, cfg, mesh)
        new = lm.unshard_params(new, cfg, mesh)
    return (float(loss.detach()),
            *(tree_map(lambda t: t.detach().cpu(), t) for t in (grads, new)))


def _mesh_rank(rank, world, tmp):
    """A rank of `mesh_ranks`: the sharded step on (1, 2) (TP + SP) and on
    (2, 1) (data parallel + FSDP), context-parallel decode of the cache
    sequence over both ranks on (1, 2), and the shard_map MoE on (2, 1)."""
    import os
    import torch.distributed as dist
    from repro_torch.models import lm
    from repro_torch.runtime.meshctx import Mesh, use_mesh
    from repro_torch.tree import tree_map
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            world_size=world, rank=rank)
    dev = torch.device("cuda")
    inp = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=True)
    inp = tree_map(lambda t: t.to(dev) if isinstance(t, torch.Tensor)
                   else t, inp)
    dense, shard, _ = _mesh_cfgs()
    meshes = {"tp": Mesh((1, 2), ("data", "model"), dev),
              "dp": Mesh((2, 1), ("data", "model"), dev)}
    out = {}
    for name, mesh in meshes.items():
        out[f"step/{name}"] = _mesh_step(inp["dense"], inp["batch"], dense,
                                         mesh)
    mesh = meshes["tp"]
    cache = lm.shard_kv_cache(inp["cache"], mesh, lm.LONG_CACHE_LOGICAL)
    with use_mesh(mesh), torch.no_grad():
        logits, cache = lm.decode_step(lm.shard_params(inp["dense"], dense,
                                                       mesh),
                                       cache, inp["next"], dense)
    out["decode"] = (logits.cpu(), cache["length"])
    mesh = meshes["dp"]
    spec = lm.param_logical_specs(shard)["layers"][0]
    from repro_torch.runtime.meshctx import local_block, logical_to_spec
    lp = {k: local_block(v, logical_to_spec(spec[k], mesh), mesh)
          for k, v in inp["moe_layer"].items()}
    with use_mesh(mesh), torch.no_grad():
        y, aux = lm._moe_ffn(mesh.block(inp["moe_x"], "data", 0), lp, shard)
    out["moe"] = (mesh.gather(y, "data", 0).cpu(), float(aux))
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh_ranks(tmp_path_factory):
    """Two gloo ranks sharing the card (`_mesh_rank`) and the same work on
    one rank in this process: ({name: rank 0's result}, {name: one
    rank's})."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    import torch.multiprocessing as mp
    from repro_torch.models import lm
    from repro_torch.tree import tree_map
    tmp = tmp_path_factory.mktemp("mesh_ranks")
    dev = torch.device("cuda")
    dense, _, local = _mesh_cfgs()
    gen = torch.Generator(device=dev).manual_seed(5)
    params = lm.init_params(gen, dense)
    tok = torch.randint(0, dense.vocab, (4, 16), generator=gen, device=dev)
    batch = {"tokens": tok, "labels": tok.roll(1, 1)}
    with torch.no_grad():
        logits, cache = lm.prefill(params, tok, dense, max_len=24)
    nxt = logits.argmax(-1)[:, None]
    mparams = lm.init_params(gen, local)
    moe_x = torch.randn((32, local.d_model), generator=gen, device=dev)
    inputs = {"dense": params, "batch": batch, "cache": dict(cache),
              "next": nxt, "moe_layer": mparams["layers"][1],
              "moe_x": moe_x}
    torch.save(tree_map(lambda t: t.cpu() if isinstance(t, torch.Tensor)
                        else t, inputs), tmp / "inputs.pt")
    want = {"step": _mesh_step(params, batch, dense, None)}
    with torch.no_grad():
        cache = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
                 for k, v in cache.items()}
        want["decode"] = lm.decode_step(params, cache, nxt, dense)[0].cpu()
        y, aux = lm._moe_ffn(moe_x, mparams["layers"][1], local)
    want["moe"] = (y.cpu(), float(aux))
    mp.spawn(_mesh_rank, args=(2, str(tmp)), nprocs=2)
    got = torch.load(tmp / "rank0.pt", weights_only=True)
    return got, want


@pytest.mark.parametrize("mesh", ["tp", "dp"])
def test_mesh_sharded_step_on_two_ranks_equals_one(mesh_ranks, mesh):
    """The sharded AdamW step on two gloo ranks sharing the card, on (1, 2)
    (TP + SP, the attention kernel on each rank's heads) and on (2, 1)
    (FSDP + data parallel), against the same step on one rank: loss within
    1e-5, each gradient leaf within 1e-5 of its largest |grad|, and every
    updated parameter within 2 lr, all but 0.1% of them within 1e-5.
    Adam divides a gradient by its own size, so a near-zero gradient
    summed in another order can move its weight by up to 2 lr."""
    from repro_torch.tree import tree_leaves
    got, want = mesh_ranks
    loss, grads, params = got[f"step/{mesh}"]
    wloss, wgrads, wparams = want["step"]
    assert abs(loss - wloss) <= 1e-5
    for a, b in zip(tree_leaves(grads), tree_leaves(wgrads)):
        _close(a, b, 1e-5 * float(b.abs().max()))
    far = n = 0
    for a, b in zip(tree_leaves(params), tree_leaves(wparams)):
        _close(a, b, 2 * MESH_LR)
        far += int(((a - b).abs() > 1e-5).sum())
        n += b.numel()
    assert far <= 1e-3 * n, (far, n)


def test_mesh_context_parallel_decode_on_two_ranks_equals_one(mesh_ranks):
    """Decode with the cache's sequence over two gloo ranks (TP on the
    weights) == one rank's decode_step within 1e-5; length + 1."""
    got, want = mesh_ranks
    logits, length = got["decode"]
    assert length == 17
    _close(logits, want["decode"], 1e-5)


def test_mesh_shard_map_moe_on_two_ranks_equals_local(mesh_ranks):
    """The shard_map MoE over two data shards == the "local" dispatch with
    dp_shards 2 on one rank: y within 1e-5, aux within 1e-6."""
    got, want = mesh_ranks
    (y, aux), (wy, waux) = got["moe"], want["moe"]
    _close(y, wy, 1e-5)
    assert abs(aux - waux) <= 1e-6


def test_counting_mode_still_launches_the_kernels(cuda):
    """Under the dry run's counting (`_meta.counting`), a CUDA call of each
    kernel through `kernels.ops` launches it (its counter moves) and the
    meta branch is never taken (no kernel is counted there)."""
    from repro_torch import _meta
    gen = torch.Generator(device=cuda).manual_seed(4)
    order = torch.randperm(6 * 7 * 8, generator=gen, device=cuda).to(
        torch.int32).reshape(6, 7, 8)
    q = torch.randn(1, 4, 64, 64, generator=gen, device=cuda,
                    dtype=torch.bfloat16)
    kv = torch.randn(1, 2, 64, 64, generator=gen, device=cuda,
                     dtype=torch.bfloat16)
    table = torch.randn(100, 32, generator=gen, device=cuda)
    ids = torch.randint(-1, 100, (8, 5), generator=gen, device=cuda)
    mods = (kmod, steepest_mod, bpc_mod, flash_mod, bag_mod)
    for mod in mods:
        for k in mod.launches:
            mod.launches[k] = 0
    with _meta.counting() as counts:
        ops.fused_local_phase(order, 6)
        ops.steepest_neighbor(order, 6)
        ops.block_pathcompress(order.reshape(-1).clone(), 2, 64)
        ops.flash_attention(q, kv, kv, causal=True)
        ops.embedding_bag(table, ids)
        torch.cuda.synchronize()
    assert counts.kernel_calls == {} and counts.kernel_flops == 0
    for mod in mods:
        assert sum(mod.launches.values()) >= 1, mod.__name__

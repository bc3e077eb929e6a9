"""The port's four stand-alone kernels against the JAX package:
`steepest_neighbor`, `block_pathcompress`, `segment_bag` (behind
`ops.embedding_bag`) and `flash_attention`.

On the CPU `repro_torch.kernels.ops` runs each kernel's plain version
(`repro_torch.kernels.ref`).  The same seeded numpy inputs go through the
Pallas kernel in interpret mode (each compile takes well under a second)
and through the port; for `impl="ref"` they go through JAX's jnp oracles
and their ports.  Tolerances are those of `tests/test_kernels.py`: exact for
the two pointer kernels; 1e-5 (fp32) and 3e-2 (bf16) for the bags, whose
fp32 sums run in another order than the Pallas kernel's vocab tiles;
2e-5 (fp32) and 2e-2 (bf16) for attention, whose online softmax runs over
other key tiles.  The CUDA kernels are held to the same plain versions on
the card by `tests/test_torch_cuda.py` and `chip_smoke.py`.

`tests/test_kernels.py`'s `_cache_size` recompile test of
`block_pathcompress` has no counterpart: the port runs eagerly and has no
jit cache to count.  The pow2 snap it guards is tested here through its
result (a ragged n in (cap/2, cap], pointers into the pad).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs.bst as bst_config
import repro.core.steepest as jst
from repro.core.steepest import neighbor_offsets
from repro.data.recsys import bst_batch
from repro.kernels import ops as j_ops, ref as jref
from repro.kernels.block_pathcompress import block_pathcompress as j_bpc
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.segment_bag import segment_bag as j_bag
from repro.kernels.steepest_neighbor import steepest_neighbor as j_steepest
from repro_torch.interop import canonical_tensor, to_numpy
from repro_torch.kernels import ops, ref
from repro_torch.kernels import block_pathcompress as bpc_mod
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import segment_bag as bag_mod
from repro_torch.kernels import steepest_neighbor as steepest_mod

DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}
BAG_TOL = {"f32": 1e-5, "bf16": 3e-2}
ATTN_TOL = {"f32": 2e-5, "bf16": 2e-2}


def _rng(*key):
    return np.random.default_rng(abs(hash(key)) % 2**31)


def _both(a: np.ndarray, dtype: str):
    """`a` as a JAX array of `dtype` and as the port's CPU tensor of the
    same bits (bf16 crosses through `interop.canonical_tensor`)."""
    j = jnp.asarray(a).astype(DTYPES[dtype])
    return j, canonical_tensor(np.asarray(j), "cpu")


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               rtol=tol, atol=tol)


# --- steepest_neighbor --------------------------------------------------------

_J_STEEPEST_REF = jax.jit(jref.steepest_neighbor_ref,
                          static_argnames=("offsets",))
_J_GRID_STEEPEST = jax.jit(jst.grid_steepest,
                           static_argnames=("connectivity", "descending"))
# JAX's oracles, jitted: one compile each instead of one per op, eagerly
_J_MHA_REF = jax.jit(jref.mha_ref, static_argnames=("causal",))
_J_FLASH_REF = jax.jit(jref.flash_attention_ref, static_argnames=("causal",))
_J_OPS_FLASH_REF = jax.jit(functools.partial(j_ops.flash_attention,
                                             impl="ref"),
                           static_argnames=("causal",))


def _order(shape, ties=False, seed=0):
    rng = _rng(shape, ties, seed)
    if ties:                  # few distinct values: the offset order decides
        return rng.integers(0, 4, size=shape).astype(np.int32)
    return rng.permutation(int(np.prod(shape))).reshape(shape).astype(
        np.int32)


@pytest.mark.parametrize("ties", [False, True], ids=["unique", "ties"])
@pytest.mark.parametrize("shape,conn", [
    (s, c) for s in [(8, 8, 8), (16, 8, 8), (4, 16, 8), (32, 4, 4), (8, 5, 7)]
    for c in (6, 14)] + [((8, 5, 7), 18), ((8, 5, 7), 26)])
def test_steepest_plain_vs_jax_ref(shape, conn, ties):
    order = _order(shape, ties)
    got = ops.steepest_neighbor(torch.from_numpy(order), conn)
    want = _J_STEEPEST_REF(jnp.asarray(order),
                           tuple(neighbor_offsets(3, conn)))
    assert got.dtype == torch.int32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("conn,block_x,ties", [
    (6, 4, False), (14, 4, True), (18, 4, True), (26, 4, True),
    (6, 1, False), (6, 2, True), (14, 3, False)])   # 3: X % 3, block_x -> 1
def test_steepest_plain_vs_pallas_interpret(conn, block_x, ties):
    order = _order((8, 5, 7), ties, seed=1)
    got = ops.steepest_neighbor(torch.from_numpy(order), conn,
                                block_x=block_x)
    want = j_steepest(jnp.asarray(order), conn, block_x=block_x,
                      interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_steepest_dispatch_and_validation(monkeypatch):
    # JAX's dispatch imports grid_steepest at call time: the jitted one
    # gives the same arrays from one compile per shape
    monkeypatch.setattr(jst, "grid_steepest", _J_GRID_STEEPEST)
    rng = np.random.default_rng(7)
    order2d = rng.permutation(30).reshape(5, 6).astype(np.int32)
    # 2-D: the grid_steepest fallback, whatever impl asks, as in JAX
    for impl in ("auto", "kernel", "ref"):
        got = ops.steepest_neighbor(torch.from_numpy(order2d), 4, impl=impl)
        want = j_ops.steepest_neighbor(jnp.asarray(order2d), 4, impl=impl)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    order = _order((5, 4, 3))
    t = torch.from_numpy(order)
    np.testing.assert_array_equal(
        ops.steepest_neighbor(t, 14, impl="ref").numpy(),
        np.asarray(j_ops.steepest_neighbor(jnp.asarray(order), 14,
                                           impl="ref")))
    # a 3-D connectivity without a table: the fallback raises in both
    with pytest.raises(ValueError):
        j_ops.steepest_neighbor(jnp.asarray(order), 4)
    with pytest.raises(ValueError):
        ops.steepest_neighbor(t, 4)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        ops.steepest_neighbor(t, 6, impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        ops.steepest_neighbor(t, 6, impl="nope")
    with pytest.raises(ValueError, match="block_x"):
        ops.steepest_neighbor(t, 6, block_x=0)
    # the kernel's wrapper: what it cannot tile, then the device
    with pytest.raises(ValueError, match="3-D"):
        steepest_mod.steepest_neighbor(torch.from_numpy(order2d), 4)
    with pytest.raises(ValueError, match="fallback"):
        steepest_mod.steepest_neighbor(t, 5)
    with pytest.raises(ValueError, match="CUDA tensor"):
        steepest_mod.steepest_neighbor(t, 6)
    np.testing.assert_array_equal(
        ops.steepest_neighbor(t, 6).numpy(),
        np.asarray(_J_GRID_STEEPEST(jnp.asarray(order), 6)).reshape(
            order.shape))


# --- block_pathcompress -------------------------------------------------------


def _pointers(n, block, seed=0):
    """Forward chains (85%), -1 pointers (5%), and in the last tile a few
    pointers into the -1 pad past n and past the tile."""
    rng = _rng(n, block, seed)
    d = np.arange(n)
    for v in range(n - 1):
        if rng.random() < 0.85:
            d[v] = rng.integers(v + 1, n)
    d[rng.random(n) < 0.05] = -1
    block = ref.snapped_block(n, block)
    tile_end = -(-n // block) * block
    last = np.arange(n - min(8, n), n)
    d[last[::2]] = rng.integers(n, tile_end + 1, size=len(last[::2]))
    d[last[1::3]] = tile_end + rng.integers(0, 50, size=len(last[1::3]))
    return d.astype(np.int32)


# (n, block): pow2 fits, ragged n in (cap/2, cap], a non-pow2 block, a
# block larger than the capacity (snapped to it), tiny n
BPC_CASES = [(64, 16), (256, 64), (1024, 1024), (100, 32), (97, 64),
             (130, 128), (1005, 100), (50, 4096), (3, 2), (1, 8)]


@pytest.mark.parametrize("rounds", [1, 3, 6])
@pytest.mark.parametrize("n,block", BPC_CASES)
def test_block_pathcompress_plain_vs_pallas_interpret(n, block, rounds):
    d = _pointers(n, block)
    got = ops.block_pathcompress(torch.from_numpy(d), rounds, block)
    want = j_bpc(jnp.asarray(d), rounds=rounds, block=block, interpret=True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,block,rounds", [(100, 32, 3), (1005, 100, 2),
                                            (64, 64, 0), (2003, 1001, 7)])
def test_block_pathcompress_plain_is_the_per_tile_ref(n, block, rounds):
    """The plain version is JAX's ref run per tile of the snapped block on
    the -1-padded array; int64 ids give the same pointers."""
    d = _pointers(n, block, seed=1)
    block_s = ref.snapped_block(n, block)
    tiles = -(-n // block_s)
    padded = np.full(tiles * block_s, -1, np.int32)
    padded[:n] = d
    want = np.concatenate([
        np.asarray(jref.block_pathcompress_ref(
            jnp.asarray(padded[i:i + block_s]), rounds, base=i))
        for i in range(0, tiles * block_s, block_s)])[:n]
    got = ref.block_pathcompress_kernel_ref(torch.from_numpy(d), rounds,
                                            block)
    np.testing.assert_array_equal(got.numpy(), want)
    got64 = ops.block_pathcompress(torch.from_numpy(d).long(), rounds, block)
    assert got64.dtype == torch.int64
    np.testing.assert_array_equal(got64.numpy(), want)


@pytest.mark.parametrize("n,rounds", [(100, 3), (256, 5)])
def test_block_pathcompress_ref_impl_is_jax_ref_impl(n, rounds):
    d = _pointers(n, 4096, seed=2)
    got = ops.block_pathcompress(torch.from_numpy(d), rounds, impl="ref")
    want = j_ops.block_pathcompress(jnp.asarray(d), rounds, impl="ref")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_block_pathcompress_dispatch_and_validation():
    t = torch.from_numpy(_pointers(40, 16))
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        ops.block_pathcompress(t, impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        ops.block_pathcompress(t, impl="nope")
    with pytest.raises(ValueError, match="block"):
        ops.block_pathcompress(t, block=0)
    with pytest.raises(ValueError, match="rounds"):
        ops.block_pathcompress(t, rounds=-1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bpc_mod.block_pathcompress(t)
    assert ops.block_pathcompress(t[:0]).numel() == 0
    # the two launch configurations the kernel picks by tile size
    assert bpc_mod.configuration(4096, torch.int32) == "shared"
    assert bpc_mod.configuration(29056, torch.int32) == "shared"
    assert bpc_mod.configuration(29057, torch.int32) == "global"
    assert bpc_mod.configuration(14529, torch.int64) == "global"


# --- segment_bag / embedding_bag ---------------------------------------------


def _bag_inputs(v, d, b, l, seed=0):
    """A normal table and ids drawn from [-3, V + 5): -1 pads, other
    negative ids, ids >= V, and two all-padding bags."""
    rng = _rng(v, d, b, l, seed)
    table = rng.normal(size=(v, d)).astype(np.float32)
    ids = rng.integers(-3, v + 5, size=(b, l)).astype(np.int32)
    ids[1] = -1
    ids[-1] = -1
    return table, ids


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("v,d,b,l,vb,bb", [
    (64, 8, 16, 5, 16, 8),
    (256, 32, 32, 16, 64, 32),
    (100, 16, 24, 4, 100, 24),   # single tile
    (512, 4, 8, 3, 128, 4),
    (96, 40, 12, 37, 32, 12),    # D and L past one warp's 32
])
def test_segment_bag_plain_vs_pallas_interpret(v, d, b, l, vb, bb, dtype):
    table, ids = _bag_inputs(v, d, b, l)
    jt, tt = _both(table, dtype)
    got = ops.embedding_bag(tt, torch.from_numpy(ids), vocab_block=vb,
                            batch_block=bb)
    want = j_bag(jt, jnp.asarray(ids), vocab_block=vb, batch_block=bb,
                 interpret=True)
    assert got.dtype == tt.dtype and tuple(got.shape) == (b, d)
    _close(got, want, BAG_TOL[dtype])
    assert not got[1].any() and not got[-1].any()     # all-padding bags


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_embedding_bag_bst_per_field_vs_pallas_interpret(dtype):
    """BST's own calls at its smoke widths (`configs/bst.py::smoke_config`):
    one call a multihot field, field f's ids offset by f * multihot_vocab
    into the shared table, -1 pads kept, as `models/bst.py::user_tower`
    gives them; ids as `data/recsys.py::bst_batch` draws them."""
    cfg = bst_config.smoke_config()
    b = bst_config.SMOKE_SHAPES["serve_p99"]["batch"]
    multihot = bst_batch(cfg, b, seed=5)["multihot_ids"]
    rng = _rng("bst", b)
    table = rng.normal(size=(cfg.n_multihot_fields * cfg.multihot_vocab,
                             cfg.embed_dim)).astype(np.float32)
    jt, tt = _both(table, dtype)
    for f in range(cfg.n_multihot_fields):
        ids = multihot[:, f]
        ids = np.where(ids >= 0, ids + f * cfg.multihot_vocab, -1).astype(
            np.int32)
        assert ids.shape == (b, cfg.multihot_len)
        got = ops.embedding_bag(tt, torch.from_numpy(ids))
        want = j_bag(jt, jnp.asarray(ids), interpret=True)
        assert got.dtype == tt.dtype and tuple(got.shape) == (b,
                                                              cfg.embed_dim)
        _close(got, want, BAG_TOL[dtype])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_embedding_bag_ref_impl_is_jax_ref_impl(id_dtype, dtype):
    """impl="ref" is the bst oracle on both sides: a bag with an id >= V
    is NaN there and here; the other bags agree.  The port also takes int64
    ids (JAX's are int32 under x32)."""
    table, ids = _bag_inputs(50, 8, 20, 6, seed=3)
    ids[4, 2] = 50                       # one id >= V in bag 4
    jt, tt = _both(table, dtype)
    ti = torch.from_numpy(ids).to(id_dtype)
    got = ops.embedding_bag(tt, ti, impl="ref")
    want = np.asarray(j_ops.embedding_bag(jt, jnp.asarray(ids), impl="ref")
                      .astype(jnp.float32))
    got = got.float().numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[4]).all()
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=BAG_TOL[dtype],
                               atol=BAG_TOL[dtype])
    # the kernel path ignores the same id
    plain = ops.embedding_bag(tt, ti).float().numpy()
    assert not np.isnan(plain).any()


def test_embedding_bag_dispatch_and_validation():
    table, ids = _bag_inputs(32, 4, 8, 3)
    tt, ti = torch.from_numpy(table), torch.from_numpy(ids)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        ops.embedding_bag(tt, ti, impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        ops.embedding_bag(tt, ti, impl="nope")
    with pytest.raises(ValueError, match="vocab_block"):
        ops.embedding_bag(tt, ti, vocab_block=0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bag_mod.segment_bag(tt, ti)
    with pytest.raises(ValueError, match=r"\(V, D\)"):
        bag_mod.segment_bag(tt[0], ti)
    # int64 ids give the int32 ids' bags
    np.testing.assert_array_equal(ops.embedding_bag(tt, ti.long()).numpy(),
                                  ops.embedding_bag(tt, ti).numpy())


# --- flash_attention ----------------------------------------------------------


def _qkv(b, h, hkv, sq, sk, d, seed=0):
    rng = _rng(b, h, hkv, sq, sk, d, seed)
    return (rng.normal(size=(b, h, sq, d)).astype(np.float32),
            rng.normal(size=(b, hkv, sk, d)).astype(np.float32),
            rng.normal(size=(b, hkv, sk, d)).astype(np.float32))


# (b, h, hkv, sq, sk, d, causal, block_q, block_k)
FLASH_CASES = [
    (1, 4, 4, 128, 128, 64, False, 128, 128),
    (2, 4, 2, 128, 256, 64, False, 128, 128),   # GQA group 2
    (1, 8, 1, 64, 64, 128, False, 64, 64),      # MQA
    (1, 4, 2, 64, 192, 112, True, 64, 64),      # causal, Sk > Sq, D = 112
    (1, 4, 2, 128, 64, 4, True, 64, 32),        # causal, Sk < Sq: 64 rows
    #                                             see no key (mean of V)
    (2, 2, 1, 64, 64, 4, True, 32, 64),         # causal, Sq == Sk
    (1, 2, 1, 32, 64, 320, False, 32, 32),      # D = 320 > 256
    (1, 2, 1, 64, 32, 320, True, 32, 32),       # D = 320, causal, Sk < Sq
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b,h,hkv,sq,sk,d,causal,bq,bk", FLASH_CASES)
def test_flash_plain_vs_pallas_interpret(b, h, hkv, sq, sk, d, causal, bq,
                                         bk, dtype):
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype)
                                    for a in _qkv(b, h, hkv, sq, sk, d))
    got = ops.flash_attention(tq, tk, tv, causal=causal, block_q=bq,
                              block_k=bk)
    want = j_flash(jq, jk, jv, causal=causal, block_q=bq, block_k=bk,
                   interpret=True)
    assert got.dtype == tq.dtype and tuple(got.shape) == (b, h, sq, d)
    _close(got, want, ATTN_TOL[dtype])


def test_flash_fully_masked_rows_average_v():
    """Causal with Sk < Sq: the first Sq - Sk rows see no key.  The kernel's
    plain version (and the Pallas kernel) give them the mean of V; the jnp
    oracles, here and in JAX, give NaN."""
    q, k, v = _qkv(1, 2, 1, 96, 32, 16, seed=5)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=True, block_q=32,
                              block_k=32)
    np.testing.assert_allclose(got[0, :, :64].numpy(),
                               np.broadcast_to(v[0, 0].mean(0),
                                               (2, 64, 16)),
                               rtol=1e-5, atol=1e-5)
    assert not torch.isnan(got).any()
    for fn, jfn in ((ref.mha_ref, _J_MHA_REF),
                    (ref.flash_attention_ref, _J_FLASH_REF)):
        r = fn(tq, tk, tv, causal=True).numpy()
        jr = np.asarray(jfn(*map(jnp.asarray, (q, k, v)), causal=True))
        np.testing.assert_array_equal(np.isnan(r), np.isnan(jr))
        assert np.isnan(r[0, :, :64]).all() and not np.isnan(r[0, :, 64:]).any()
        np.testing.assert_allclose(r[0, :, 64:], jr[0, :, 64:],
                                   rtol=ATTN_TOL["f32"], atol=ATTN_TOL["f32"])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b,h,hkv,sq,sk,d,causal", [
    (2, 4, 2, 64, 192, 32, True),     # 192 // 128 = 1 chunk of 192 keys
    (1, 4, 4, 64, 301, 16, False),    # 2 chunks of 150: key 300 dropped
    (1, 2, 1, 48, 48, 8, True)])
def test_flash_ref_impls_are_jax_ref_impls(b, h, hkv, sq, sk, d, causal,
                                           dtype):
    """impl="ref" runs the chunked oracle as JAX's ops does; mha_ref too."""
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype)
                                    for a in _qkv(b, h, hkv, sq, sk, d, 1))
    _close(ops.flash_attention(tq, tk, tv, causal=causal, impl="ref"),
           _J_OPS_FLASH_REF(jq, jk, jv, causal=causal), ATTN_TOL[dtype])
    _close(ref.mha_ref(tq, tk, tv, causal=causal),
           _J_MHA_REF(jq, jk, jv, causal=causal), ATTN_TOL[dtype])


def test_flash_dispatch_and_validation():
    tq, tk, tv = map(torch.from_numpy, _qkv(1, 4, 2, 64, 64, 16))
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        ops.flash_attention(tq, tk, tv, impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        ops.flash_attention(tq, tk, tv, impl="nope")
    # as in JAX, Sq and Sk must be multiples of their (clamped) blocks
    with pytest.raises(AssertionError):
        j_flash(*map(jnp.asarray, (tq.numpy(), tk.numpy(), tv.numpy())),
                block_q=48, interpret=True)
    with pytest.raises(ValueError, match="multiples"):
        ops.flash_attention(tq, tk, tv, block_q=48)
    with pytest.raises(ValueError, match="multiples"):
        ops.flash_attention(tq, tk, tv, block_k=24)
    with pytest.raises(ValueError, match="block_q"):
        ops.flash_attention(tq, tk, tv, block_q=0)
    ops.flash_attention(tq, tk, tv, block_q=512, block_k=512)  # clamped
    # the LM's prefill turns the Pallas tile check off: S = 200 is taken,
    # by "auto" and "plain" alike, and equals JAX's mha_ref
    qkv2 = _qkv(1, 4, 2, 200, 200, 16, 3)
    q2, k2, v2 = map(torch.from_numpy, qkv2)
    with pytest.raises(ValueError, match="multiples"):
        ops.flash_attention(q2, k2, v2, causal=True)
    want = _J_MHA_REF(*map(jnp.asarray, qkv2), causal=True)
    for impl in ("auto", "plain"):
        _close(ops.flash_attention(q2, k2, v2, causal=True, impl=impl,
                                   check_tiles=False), want, ATTN_TOL["f32"])
    with pytest.raises(ValueError, match="multiple of the kv heads"):
        ops.flash_attention(tq[:, :3], tk, tv)
    # the plain version takes any D; the CUDA kernels stop at 1247
    big = torch.zeros(1, 1, 4, 1248)
    assert ops.flash_attention(big, big, big).shape == big.shape
    with pytest.raises(ValueError, match="1247"):
        flash_mod.flash_attention(big, big, big)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_mod.flash_attention(tq, tk, tv)


def test_flash_route():
    """Which kernel a CUDA call runs, by dtype and head dim."""
    assert [flash_mod.route(torch.bfloat16, d) for d in (1, 4, 64, 256)] \
        == ["bfloat16"] * 4
    assert [flash_mod.route(torch.bfloat16, d) for d in (257, 320, 1247)] \
        == ["bfloat16_cuda_cores"] * 3
    assert [flash_mod.route(torch.float32, d) for d in (1, 4, 64, 112, 128)] \
        == ["float32"] * 5
    assert [flash_mod.route(torch.float32, d) for d in (129, 256, 320, 1247)] \
        == ["float32_cuda_cores"] * 4
    assert flash_mod.F32_TC_MAX_HEAD_DIM == 128
    assert set(flash_mod.launches) == set(flash_mod.SYMBOLS) == {
        "float32", "float32_cuda_cores", "bfloat16", "bfloat16_cuda_cores"}
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_mod.route(torch.float16, 64)


# --- the fp32 kernel's arithmetic (`flash_f32tc`), modelled on the CPU ---------
#
# The CUDA kernel cannot run here; this model repeats its arithmetic in torch
# so that the CPU shows it meets the fp32 tolerance before any card run: q *
# scale in fp32; each score one fma chain over d = 0, 1, ... (the fma in
# float64, rounded to fp32 at each step); key tiles of 64, the online softmax
# on the scores as they are, p = exp2((s - m) log2(e)); O += P V as three
# products of TF32 parts, P_small V_big + P_big V_small + P_big V_big, each
# part rounded as cvt.rna.tf32.f32 rounds, summed in fp32.  The variants show
# why the kernel is built so: one TF32 product misses 2e-5 at every size, and
# QK^T summed 8 d at a time (a tensor-core mma's order, here with 3xTF32
# products) misses it at large scores, where the reference's own fp32 sums
# are already that far from exact.

# (b, h, hkv, sq, sk, d, causal): the card tests' fp32 cases with D <= 128
F32TC_CASES = [
    (1, 4, 2, 128, 256, 64, False),   # GQA
    (1, 4, 2, 64, 192, 112, True),    # causal, Sk > Sq, D = 112
    (1, 4, 2, 128, 64, 4, True),      # causal, Sk < Sq: rows average V
    (1, 8, 1, 33, 33, 128, True),     # MQA, D = 128, ragged key tile
    (1, 2, 1, 40, 72, 1, True),       # D = 1
    (1, 4, 2, 200, 300, 64, False),   # the large-scores shape
]


def _tf32(x):
    """x rounded to TF32 (10 stored mantissa bits), to nearest with ties
    away from zero, on the bit pattern: half a TF32 ulp added to the
    magnitude, the 13 bits below it cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_split(x):
    big = _tf32(x)
    return big, _tf32(x - big)


def _qk_fma(qf, kt):
    """Each score one fma chain over d, as the kernel's CUDA cores sum it."""
    s = torch.zeros(qf.shape[:-1] + kt.shape[-1:], dtype=torch.float32)
    for d in range(qf.shape[-1]):
        s = (qf[..., d:d + 1].double() * kt[..., d:d + 1, :].double()
             + s.double()).float()
    return s


def _qk_mma_3xtf32(qf, kt):
    """QK^T as m16n8k8 mma would sum it: 8 d a product, 3xTF32."""
    (qb, qs), (kb, ks) = _tf32_split(qf), _tf32_split(kt)
    s = torch.zeros(qf.shape[:-1] + kt.shape[-1:], dtype=torch.float32)
    for d0 in range(0, qf.shape[-1], 8):
        c = slice(d0, d0 + 8)
        s = s + qs[..., c] @ kb[..., c, :]
        s = s + qb[..., c] @ ks[..., c, :]
        s = s + qb[..., c] @ kb[..., c, :]
    return s


def _pv_3xtf32(p, v):
    (pb, ps), (vb, vs) = _tf32_split(p), _tf32_split(v)
    return ps @ vb + pb @ vs + pb @ vb


def _pv_1xtf32(p, v):
    return _tf32(p) @ _tf32(v)


def _f32tc_model(q, k, v, causal, qk=_qk_fma, pv=_pv_3xtf32, block_k=64):
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    log2e = torch.tensor(1.4426950408889634, dtype=torch.float32)
    qf = (q * ref.softmax_scale(d)).reshape(b, hkv, h // hkv, sq, d)
    m = torch.full((b, hkv, h // hkv, sq, 1), ref.MASKED)
    lsum = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    qpos = torch.arange(sq)[:, None] + (sk - sq)
    for j0 in range(0, sk, block_k):
        kc = k[:, :, None, j0:j0 + block_k]
        s = qk(qf, kc.transpose(-1, -2))
        if causal:
            kpos = torch.arange(j0, j0 + kc.shape[3])
            s = torch.where(qpos >= kpos, s, ref.MASKED)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp2((s - m_new) * log2e)
        corr = torch.exp2((m - m_new) * log2e)
        lsum = lsum * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + pv(p, v[:, :, None, j0:j0 + block_k])
        m = m_new
    return (acc / lsum.clamp(min=1e-30)).reshape(b, h, sq, d)


def _attention_f64(q, k, v, causal):
    """The attention in float64 (no row here is fully masked)."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qd = (q.double() * ref.softmax_scale(d)).reshape(b, hkv, h // hkv, sq, d)
    s = qd @ k.double()[:, :, None].transpose(-1, -2)
    if causal:
        visible = torch.arange(sq)[:, None] + (sk - sq) >= torch.arange(sk)
        s = torch.where(visible, s, ref.MASKED)
    return (s.softmax(-1) @ v.double()[:, :, None]).reshape(b, h, sq, d)


def _limit_share(got, want, tol=ATTN_TOL["f32"]):
    """The largest |got - want| / (tol + tol |want|): above 1 fails."""
    return float(((got - want).abs() / (tol + tol * want.abs())).max())


def _f32_inputs(case, scale):
    q, k, v = map(torch.from_numpy, _qkv(*case[:6], seed=3))
    return q * scale, k * scale, v


@pytest.mark.parametrize("scale", [1, 8])      # 8: scores of hundreds
@pytest.mark.parametrize("case", F32TC_CASES)
def test_flash_f32_kernel_arithmetic_meets_2e5(case, scale):
    q, k, v = _f32_inputs(case, scale)
    want = ref.flash_attention_kernel_ref(q, k, v, causal=case[6])
    torch.testing.assert_close(_f32tc_model(q, k, v, case[6]), want,
                               rtol=ATTN_TOL["f32"], atol=ATTN_TOL["f32"])


@pytest.mark.parametrize("case", F32TC_CASES[:2] + F32TC_CASES[-1:])
def test_flash_f32_single_tf32_product_misses_2e5(case):
    """One TF32 product (about 2^-11 of each p v) in place of three."""
    q, k, v = _f32_inputs(case, 1)
    want = ref.flash_attention_kernel_ref(q, k, v, causal=case[6])
    assert _limit_share(_f32tc_model(q, k, v, case[6], pv=_pv_1xtf32),
                        want) > 2


@pytest.mark.parametrize("causal", [False, True])
def test_flash_f32_qk_in_mma_order_misses_2e5_at_large_scores(causal):
    """QK^T summed 8 d at a time in 3xTF32 holds 2e-5 at unit scores but
    not at scores of hundreds; the fp32 reference is itself more than the
    limit from the float64 result there, so only its own order (one fma
    chain over d) stays within it."""
    case = F32TC_CASES[-1][:6] + (causal,)
    q, k, v = _f32_inputs(case, 1)
    want = ref.flash_attention_kernel_ref(q, k, v, causal=causal)
    assert _limit_share(_f32tc_model(q, k, v, causal, qk=_qk_mma_3xtf32),
                        want) < 0.5
    q, k, v = _f32_inputs(case, 8)
    want = ref.flash_attention_kernel_ref(q, k, v, causal=causal)
    assert _limit_share(_f32tc_model(q, k, v, causal, qk=_qk_mma_3xtf32),
                        want) > 1
    assert _limit_share(want.double(), _attention_f64(q, k, v, causal)) > 1


# --- interop: bf16 crosses bit for bit ----------------------------------------


def test_interop_bf16_crosses_bit_for_bit():
    rng = np.random.default_rng(9)
    x = jnp.asarray(rng.normal(size=(7, 5)).astype(np.float32)
                    * np.float32(3.0)).astype(jnp.bfloat16)
    x = x.at[0, :3].set(jnp.array([jnp.inf, -0.0, jnp.nan], jnp.bfloat16))
    t = canonical_tensor(np.asarray(x), "cpu")
    assert t.dtype == torch.bfloat16 and tuple(t.shape) == (7, 5)
    bits = np.asarray(x).view(np.uint16)
    np.testing.assert_array_equal(to_numpy(t), bits)
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(x.astype(jnp.float32)))
    # the x32 rule still holds for everything else
    assert canonical_tensor(np.zeros(2), "cpu").dtype == torch.float32

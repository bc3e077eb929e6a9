"""Parity of the port's core (`repro_torch.core`) with the JAX package on the
same numpy inputs: the seeded ragged grid corpus (2-D and 3-D, connectivity
4/6/14) plus 3-D connectivity 18/26 cases.  Tolerance: exact equality of
values and dtypes (everything compared is an integer or a permutation)."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from oracles import GRID_SEED_CORPUS, ragged_grid_case

from repro.core import ids as jids, steepest as jst, pathcompress as jpc
from repro.core.connected_components import _grid_stitch as j_grid_stitch
from repro.core.connected_components import \
    component_sizes as j_component_sizes
from repro.core.ms_segmentation import _pair_hash as j_pair_hash
from repro_torch.core import ids, steepest, pathcompress
from repro_torch.core.connected_components import (_grid_stitch,
                                                   component_sizes)
from repro_torch.core.ms_segmentation import _pair_hash
from repro_torch.interop import canonical_tensor, to_numpy

# (shape, connectivity, mask probability): the corpus, then 18/26 in 3-D
CASES = [(shape, conn, mask_p) for shape, _, conn, mask_p in
         map(ragged_grid_case, GRID_SEED_CORPUS)] + [((7, 5, 6), 18, 0.6),
                                                     ((6, 7, 5), 26, 0.5)]
CASE_IDS = [f"seed{s}" for s in GRID_SEED_CORPUS] + ["conn18", "conn26"]


@functools.partial(jax.jit, static_argnums=(5,))
def _jax_refs(order, mask, field, field64, tie, conn):
    """Every JAX reference a case needs, in one program: one compile per
    case instead of one per function (or per op, eagerly)."""
    out = {"desc": jst.grid_steepest(order, conn, True),
           "asc": jst.grid_steepest(order, conn, False),
           "cc": jst.grid_mask_argmax(mask, conn),
           "order": jids.compute_order(field),
           "order64": jids.compute_order(field64),
           "order_tie": jids.compute_order(field, tie)}
    for k in ("desc", "cc"):
        out[k + "_pc"] = jpc.path_compress(out[k])
        out[k + "_pc2"] = jpc.path_compress_unrolled(out[k], 2)
    out["stitch"] = j_grid_stitch(out["cc_pc"][0], mask.ravel(), mask.shape,
                                  conn, mask.size)
    return out


@functools.lru_cache(maxsize=None)
def _case(i):
    """Inputs of CASES[i] and their JAX references (numpy)."""
    shape, conn, mask_p = CASES[i]
    rng = np.random.default_rng(1000 + i)
    order = rng.permutation(int(np.prod(shape))).reshape(shape).astype(
        np.int32)
    mask = rng.random(shape) < mask_p
    # few distinct values: many ties, broken by id; zeros of both signs
    field = (rng.integers(-3, 4, shape) * 0.5).astype(np.float32)
    field[(field == 0) & (rng.random(shape) < 0.5)] = -0.0
    # a float64 payload is ordered in float32 by both (x32 canonicalisation)
    field64 = field.astype(np.float64) + rng.standard_normal(shape) * 1e-9
    tie = rng.permutation(field.size).astype(np.int32)
    inputs = dict(shape=shape, conn=conn, order=order, mask=mask,
                  field=field, field64=field64, tie=tie)
    refs = _jax_refs(order, mask, field, field64, tie, conn)
    return inputs, jax.tree.map(np.asarray, refs)


def _t(a):
    return canonical_tensor(a, "cpu")


def _same(got, want):
    """Exact equality of values and of dtype."""
    got, want = to_numpy(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def test_case_table_covers_the_corpus():
    assert {len(c[0]) for c in CASES} == {2, 3}
    assert {c[1] for c in CASES} >= {4, 6, 14, 18, 26}


CASE_NUMS = pytest.mark.parametrize("i", range(len(CASES)), ids=CASE_IDS)


@CASE_NUMS
def test_compute_order_with_ties_and_signed_zeros(i):
    x, ref = _case(i)
    assert np.signbit(x["field"][x["field"] == 0]).any()
    _same(ids.compute_order(_t(x["field"])), ref["order"])
    _same(ids.compute_order(_t(x["field64"])), ref["order64"])
    _same(ids.compute_order(_t(x["field"]), _t(x["tie"])), ref["order_tie"])


@CASE_NUMS
def test_compact_labels_and_inverse_permutation(i):
    x, ref = _case(i)
    rng = np.random.default_rng(i)
    # one label length for every case: jnp.unique(size=n) compiles per n
    labels = np.where(np.resize(x["mask"], 128), rng.integers(0, 7, 128) * 11,
                      -1).astype(np.int32)
    got, k = ids.compact_labels(_t(labels))
    want, wk = jids.compact_labels(jnp.asarray(labels))
    _same(got, want)
    assert k == wk
    perm = rng.permutation(128).astype(np.int32)
    _same(ids.inverse_permutation(_t(perm)),
          jids.inverse_permutation(jnp.asarray(perm)))


@CASE_NUMS
def test_grid_steepest_both_directions_and_mask_argmax(i):
    x, ref = _case(i)
    order, conn = _t(x["order"]), x["conn"]
    _same(steepest.grid_steepest(order, conn, True), ref["desc"])
    _same(steepest.grid_steepest(order, conn, False), ref["asc"])
    _same(steepest.grid_mask_argmax(_t(x["mask"]), conn), ref["cc"])
    assert steepest.neighbor_offsets(len(x["shape"]), conn) == \
        jst.neighbor_offsets(len(x["shape"]), conn)


@CASE_NUMS
def test_path_compress_pointers_and_iters(i):
    _, ref = _case(i)
    for k in ("desc", "cc"):
        got, it = pathcompress.path_compress(_t(ref[k]))
        want, wit = ref[k + "_pc"]
        _same(got, want)
        assert it == int(wit)
        assert pathcompress.is_converged(got)
        _same(pathcompress.path_compress_unrolled(_t(ref[k]), 2),
              ref[k + "_pc2"])


@pytest.mark.parametrize("n", [60, 2**16 + 3, 2**20])
def test_pair_hash_wraps_as_int32(n):
    """desc*n + asc in int32: exact below n*n < 2**31, wrapping above it,
    bit for bit with the JAX package (x64 off)."""
    rng = np.random.default_rng(n)
    desc = rng.integers(0, n, 500).astype(np.int32)
    asc = rng.integers(0, n, 500).astype(np.int32)
    _same(_pair_hash(_t(desc), _t(asc), n),
          j_pair_hash(jnp.asarray(desc), jnp.asarray(asc), n))


def test_interop_canonicalises_like_jax_x32():
    for a in (np.arange(4, dtype=np.int64), np.ones(3, np.float64),
              np.arange(3, dtype=np.uint64), np.array([True, False]),
              np.arange(5, dtype=np.int8)):
        t = canonical_tensor(a, "cpu")
        assert to_numpy(t).dtype == np.asarray(jnp.asarray(a)).dtype
    assert canonical_tensor(torch.ones(2, dtype=torch.float64),
                            "cpu").dtype == torch.float32


@CASE_NUMS
def test_grid_stitch(i):
    """One stitch pass on the compressed CC init: the port drops invalid
    pairs before its scatter, JAX drops their sentinel index in it."""
    x, ref = _case(i)
    d = _t(ref["cc_pc"][0])
    _same(_grid_stitch(d, _t(x["mask"]).reshape(-1), x["shape"], x["conn"]),
          ref["stitch"])


def test_flat_ids():
    for shape, dtype, jdtype in (((3, 4), torch.int32, jnp.int32),
                                 ((2, 3, 5), torch.int8, jnp.int8)):
        _same(ids.flat_ids(shape, dtype, device="cpu"),
              jids.flat_ids(shape, jdtype))


@pytest.mark.parametrize("num_segments", [None, 0, 50, 200])
def test_component_sizes(num_segments):
    """Histogram by root id, unmasked and out-of-range ids dropped."""
    rng = np.random.default_rng(3)
    labels = np.where(rng.random(128) < 0.7, rng.integers(0, 128, 128),
                      -1).astype(np.int32)
    _same(component_sizes(_t(labels), num_segments),
          j_component_sizes(jnp.asarray(labels), num_segments))

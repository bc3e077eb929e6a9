"""The port's first slice end to end against the JAX package: a Perlin field
(`repro.data.perlin.perlin_noise`, 16x13x11) and its top-10% mask through
`repro_torch.topology.submit` and `repro.topology.submit`, at connectivity
6 and 14, labels exactly equal; plus the numpy oracles, the port's Perlin
field and quantile, and the import rule of the port.

Counters: on the CPU the port's `auto` runs the kernel's plain version,
which saturates each slab (kernel_rounds > 0), while the JAX package's CPU
`auto` is the init-only path.  Both reach the same labels, but the global
path_compress starts from other pointers and counts other rounds, so the
port's `meta` is held to the JAX entry points called with
`fused_impl="kernel"` (the Pallas kernel in interpret mode).
"""
import ast
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from oracles import oracle_components, oracle_manifold

from repro import topology as jtop
from repro.core.connected_components import connected_components_grid
from repro.core.ids import compute_order as j_compute_order
from repro.core.ms_segmentation import (ms_segmentation, descending_manifold,
                                        ascending_manifold,
                                        extrema as j_extrema)
from repro.data.perlin import perlin_noise as np_perlin
from repro_torch import topology
from repro_torch.core.ids import compute_order
from repro_torch.core.ms_segmentation import extrema
from repro_torch.data import perlin_noise, quantile
from repro_torch.data import perlin as perlin_mod
from repro_torch.interop import to_numpy

SHAPE = (16, 13, 11)
_ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module")
def field():
    return np_perlin(SHAPE, frequency=0.1, seed=7)


@pytest.fixture(scope="module")
def order(field):
    want = np.array(j_compute_order(jnp.asarray(field)))   # writable copy
    got = compute_order(torch.from_numpy(field)).numpy()
    np.testing.assert_array_equal(got, want)
    return want


@pytest.fixture(scope="module")
def mask(field):
    return field > np.quantile(field, 0.9)


def _equal(got, want):
    got, want = to_numpy(got), np.asarray(want)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("conn", [6, 14])
def test_ms_query(order, conn):
    req = dict(order=order, connectivity=conn)
    got = to_numpy(topology.submit(topology.TopologyRequest("ms", **req),
                                   device="cpu"))
    want = jtop.submit(jtop.TopologyRequest("ms", **req))
    assert (got.query, got.tag, got.stats) == ("ms", None, None)
    for k in ("ascending", "descending", "segmentation"):
        _equal(getattr(got, k), getattr(want, k))
    kern = ms_segmentation(jnp.asarray(order), conn, fused_impl="kernel")
    assert got.meta == {"n_iter_asc": int(kern.n_iter_asc),
                        "n_iter_desc": int(kern.n_iter_desc)}
    _equal(got.descending, oracle_manifold(order, conn, True).astype(np.int32))
    _equal(got.ascending, oracle_manifold(order, conn, False).astype(np.int32))


@pytest.mark.parametrize("conn", [6, 14])
@pytest.mark.parametrize("descending", [True, False])
def test_manifold_query(order, conn, descending):
    req = dict(order=order, connectivity=conn, descending=descending)
    got = topology.submit(topology.TopologyRequest("manifold", **req),
                          device="cpu")
    want = jtop.submit(jtop.TopologyRequest("manifold", **req))
    _equal(got.labels, want.labels)
    fn = descending_manifold if descending else ascending_manifold
    _, kern_it = fn(jnp.asarray(order), conn, fused_impl="kernel")
    assert got.meta == {"n_iter": int(kern_it)}


@pytest.mark.parametrize("conn", [6, 14])
def test_extrema(order, conn):
    got = extrema(torch.from_numpy(order), conn)
    want = j_extrema(jnp.asarray(order), conn)
    for g, w in zip(got, want):
        _equal(g, w)


@pytest.mark.parametrize("conn", [6, 14])
def test_cc_query(mask, conn):
    got = topology.submit(topology.TopologyRequest("cc", mask=mask,
                                                   connectivity=conn),
                          device="cpu")
    want = jtop.submit(jtop.TopologyRequest("cc", mask=mask,
                                            connectivity=conn))
    _equal(got.labels, want.labels)
    kern = connected_components_grid(jnp.asarray(mask), conn,
                                     fused_impl="kernel")
    assert got.meta == {"n_rounds": int(kern.n_rounds),
                        "n_compress_iter": int(kern.n_compress_iter)}
    _equal(got.labels, oracle_components(mask, conn).astype(np.int32))


@pytest.mark.parametrize("conn", [6, 14])
def test_threshold_sweep_query(field, conn):
    thr = np.quantile(field, [0.5, 0.8, 0.9])
    req = dict(field=field, thresholds=thr, connectivity=conn)
    got = topology.submit(topology.TopologyRequest("threshold_sweep", **req),
                          device="cpu")
    want = jtop.submit(jtop.TopologyRequest("threshold_sweep", **req))
    _equal(got.labels, want.labels)


@pytest.mark.parametrize("conn", [6, 26])
def test_threshold_sweep_without_thresholds(conn):
    """No threshold: int32 labels of shape (0, *field.shape), as JAX's vmap
    over zero rows gives."""
    field = np.random.default_rng(5).random((5, 4, 3)).astype(np.float32)
    req = dict(field=field, thresholds=np.array([], np.float32),
               connectivity=conn)
    got = topology.submit(topology.TopologyRequest("threshold_sweep", **req),
                          device="cpu")
    want = jtop.submit(jtop.TopologyRequest("threshold_sweep", **req))
    assert tuple(got.labels.shape) == (0, 5, 4, 3)
    _equal(got.labels, want.labels)


def test_validation_and_unported_routes(order):
    with pytest.raises(ValueError, match="needs order="):
        topology.submit(topology.TopologyRequest("ms"), device="cpu")
    with pytest.raises(ValueError, match="table_mode"):
        topology.submit(topology.TopologyRequest("ms", order=order,
                                                 table_mode="sharded"),
                        device="cpu")
    with pytest.raises(ValueError, match="need grid_shape="):
        topology.submit(topology.TopologyRequest(
            "ms", order=order, backend="distributed", mesh=object()),
            device="cpu")
    req = topology.TopologyRequest("cc", mask=np.ones((2, 3), bool),
                                   backend="distributed", mesh=object(),
                                   grid_shape=(4, 3))
    assert req.shape() == (4, 3)
    graph = dict(domain="graph", senders=np.zeros(1, int),
                 receivers=np.zeros(1, int))
    with pytest.raises(NotImplementedError, match="manifolds on distributed "
                       "graphs need an order-field halo"):
        topology.submit(topology.TopologyRequest(
            "manifold", order=np.arange(3, dtype=np.int32), **graph),
            device="cpu")
    with pytest.raises(ValueError, match="need decomp="):
        topology.submit(topology.TopologyRequest(
            "cc", mask=np.ones(3, bool), backend="distributed",
            mesh=object(), **graph), device="cpu")
    with pytest.raises(NotImplementedError, match="MS on distributed graphs"):
        topology.submit(topology.TopologyRequest(
            "ms", order=np.arange(3, dtype=np.int32), backend="distributed",
            mesh=object(), decomp=object(), **graph), device="cpu")
    res = topology.submit_many([topology.TopologyRequest(
        "manifold", order=order, tag=i) for i in range(2)], device="cpu")
    assert [r.tag for r in res] == [0, 1]


ORDER_60 = np.random.default_rng(0).permutation(60).reshape(5, 4, 3)


@pytest.mark.parametrize("query", ["ms", "manifold"])
def test_float_order_raises_jax_value_error(query):
    """A floating order field on the grid ms / manifold routes raises the
    ValueError JAX's route raises, with its message."""
    order = ORDER_60.astype(np.float32)
    with pytest.raises(ValueError) as want:
        jtop.submit(jtop.TopologyRequest(query, order=order))
    with pytest.raises(ValueError) as got:
        topology.submit(topology.TopologyRequest(query, order=order),
                        device="cpu")
    assert str(got.value) == str(want.value) == \
        "Invalid integer data type 'f'."


@pytest.mark.parametrize("query", ["ms", "manifold"])
def test_int64_order_gives_jax_labels_where_jax_raises(query):
    """An int64 order field: JAX's route raises OverflowError (its steepest
    init pads with an int64 fill that int32 cannot hold, x64 off; a
    reference fault, ROADMAP Queue 3), the port cuts the field to int32 and
    gives JAX's labels on the field cast to int32."""
    with pytest.raises(OverflowError):
        jtop.submit(jtop.TopologyRequest(query, order=ORDER_60.astype(
            np.int64)))
    got = topology.submit(topology.TopologyRequest(
        query, order=ORDER_60.astype(np.int64)), device="cpu")
    want = jtop.submit(jtop.TopologyRequest(query, order=ORDER_60.astype(
        np.int32)))
    for field in ("labels", "ascending", "descending", "segmentation"):
        if getattr(want, field) is not None:
            _equal(getattr(got, field), getattr(want, field))


@pytest.mark.parametrize("seed,origin", [(7, None), (0, (3, 0, 5))])
def test_perlin_matches_numpy_exactly(seed, origin, monkeypatch):
    """The same float64 operations in the same order as the numpy reference,
    with the lattice gradients from its own numpy code: exact on the CPU
    (and slab by slab: 500 points make 3 x-planes a slab here)."""
    monkeypatch.setattr(perlin_mod, "SLAB_POINTS", 500)
    want = np_perlin(SHAPE, frequency=0.1, seed=seed, origin=origin)
    got = perlin_noise(SHAPE, frequency=0.1, seed=seed, origin=origin,
                       device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,qs", [(1, (0.0, 0.9)), (7, (0.0, 0.1, 0.5, 1.0)),
                                  (1000, (0.1, 0.5, 0.9, 1.0)),
                                  (2**24 + 5, (0.9,))])
def test_quantile_matches_numpy(n, qs):
    """np.quantile(x, q) to the bit, including above torch.quantile's 2**24
    limit, where numpy's float32 virtual index is already rounded."""
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    for q in qs:
        want = np.quantile(x, q)
        got = quantile(torch.from_numpy(x), q)
        assert type(got) is type(want) and got == want


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    files = [os.path.join(d, f)
             for d, _, fs in os.walk(os.path.join(_ROOT, "src", "repro_torch"))
             for f in fs if f.endswith(".py")]
    files.append(os.path.join(_ROOT, "chip_smoke.py"))
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)

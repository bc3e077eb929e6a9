"""The port's graph domain against the JAX package: graph init, graph MS and
CC and the three `domain="graph"` routes of `topology.submit` on the seeded
ragged multigraphs of `oracles.ragged_graph_case` (a fixed list of seeds:
each new vertex count compiles JAX again), JAX's index rules on ids out of
range, empty graphs, the graph inputs (`grid_edge_list`, `random_csr`), and
the tet mesh of a ragged grid against the grid path.  Every label, dtype and
count is held exactly.  Runs on the CPU (`device="cpu"`)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from oracles import GRAPH_SEED_CORPUS, oracle_components_graph, \
    ragged_graph_case

from repro import topology as jtop
from repro.core.connected_components import \
    connected_components_graph as j_cc_graph
from repro.core.ms_segmentation import ms_segmentation_graph as j_ms_graph
from repro.core.steepest import (graph_mask_argmax as j_mask_argmax,
                                 graph_steepest as j_steepest)
from repro.data.graphs import grid_edge_list as j_grid_edge_list, \
    random_csr as j_random_csr
from repro_torch import topology
from repro_torch.core.connected_components import connected_components_graph
from repro_torch.core.ms_segmentation import ms_segmentation_graph
from repro_torch.core.steepest import graph_mask_argmax, graph_steepest
from repro_torch.data import grid_edge_list, random_csr
from repro_torch.interop import canonical_tensor, to_numpy

MS_FIELDS = ("ascending", "descending", "segmentation", "n_iter_asc",
             "n_iter_desc")


def _equal(got, want):
    got, want = to_numpy(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _t(a):
    return canonical_tensor(a, "cpu")


@pytest.fixture(scope="module", params=GRAPH_SEED_CORPUS)
def case(request):
    """(mask, order, senders, receivers, ghost) of one corpus seed."""
    n, senders, receivers, _, part, mask = ragged_graph_case(request.param)
    rng = np.random.default_rng(request.param)
    order = rng.permutation(n).astype(np.int32)
    ghost = part == 0
    return mask, order, senders, receivers, ghost


def test_graph_init(case):
    mask, order, s, r, ghost = case
    js, jr = jnp.asarray(s), jnp.asarray(r)
    for desc in (True, False):
        _equal(graph_steepest(_t(order), _t(s), _t(r), desc),
               j_steepest(jnp.asarray(order), js, jr, desc))
    for g in (None, ghost):
        _equal(graph_mask_argmax(_t(mask), _t(s), _t(r),
                                 None if g is None else _t(g)),
               j_mask_argmax(jnp.asarray(mask), js, jr,
                             None if g is None else jnp.asarray(g)))


def test_ms_segmentation_graph(case):
    _, order, s, r, _ = case
    got = ms_segmentation_graph(_t(order), _t(s), _t(r))
    want = j_ms_graph(jnp.asarray(order), jnp.asarray(s), jnp.asarray(r))
    for f in MS_FIELDS[:3]:
        _equal(getattr(got, f), getattr(want, f))
    assert (got.n_iter_asc, got.n_iter_desc) == (int(want.n_iter_asc),
                                                 int(want.n_iter_desc))


def test_connected_components_graph(case):
    mask, _, s, r, _ = case
    got = connected_components_graph(_t(mask), _t(s), _t(r))
    want = j_cc_graph(jnp.asarray(mask), jnp.asarray(s), jnp.asarray(r))
    _equal(got.labels, want.labels)
    assert (got.n_rounds, got.n_compress_iter) == (
        int(want.n_rounds), int(want.n_compress_iter))
    _equal(got.labels, oracle_components_graph(mask, s, r).astype(np.int32))


def _routes(mask, order, s, r, field):
    """The three graph routes' requests, each as (port kwargs)."""
    edges = dict(domain="graph", senders=s, receivers=r)
    thr = np.array([0.3, 0.7], np.float32)
    return [("cc", dict(mask=mask, **edges)),
            ("ms", dict(order=order, **edges)),
            ("threshold_sweep", dict(field=field, thresholds=thr, **edges))]


def _jax_submit(query, **kw):
    """`repro.topology.submit` on jnp payloads: its unjitted ms route would
    index a numpy order with numpy's rules, not JAX's."""
    kw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
          for k, v in kw.items()}
    return jtop.submit(jtop.TopologyRequest(query, **kw))


def _same_result(got, want):
    got = to_numpy(got)
    assert (got.query, got.tag, got.stats) == (want.query, want.tag,
                                               want.stats)
    for f in ("labels", "ascending", "descending", "segmentation"):
        if getattr(want, f) is None:
            assert getattr(got, f) is None
        else:
            _equal(getattr(got, f), getattr(want, f))
    assert got.meta == {k: int(v) for k, v in want.meta.items()}


def test_graph_routes(case):
    mask, order, s, r, _ = case
    field = np.random.default_rng(len(mask)).random(len(mask)).astype(
        np.float32)
    for query, kw in _routes(mask, order, s, r, field):
        _same_result(topology.submit(topology.TopologyRequest(
            query, tag=query, **kw), device="cpu"),
            _jax_submit(query, tag=query, **kw))


# --- JAX's index rules, empty graphs ---------------------------------------

OUT_OF_RANGE = dict(mask=np.array([1, 1, 0, 1, 1], bool),
                    order=np.array([2, 4, 3, 0, 1], np.int32),
                    senders=np.array([0, -1, 7, -6, 3]),
                    receivers=np.array([-1, 9, 2, 1, -7]))


@pytest.mark.parametrize("case_name", ["out_of_range", "no_vertices",
                                       "no_edges", "int_mask"])
def test_edge_cases_against_jax(case_name):
    """Ids out of range (a gather wraps a negative id once and clamps; the
    segment max drops a sender outside [0, n)), n = 0, zero edges, and an
    integer mask whose values 1 and 2 JAX's bitwise and does not join in
    the pointer init but its bool stitch does: every route, every count."""
    c = dict(OUT_OF_RANGE)
    if case_name == "no_vertices":
        c = dict(mask=np.zeros(0, bool), order=np.zeros(0, np.int32),
                 senders=np.zeros(0, int), receivers=np.zeros(0, int))
    elif case_name == "no_edges":
        c.update(senders=np.zeros(0, int), receivers=np.zeros(0, int))
    elif case_name == "int_mask":
        c = dict(mask=np.array([1, 2, 0], np.int32),
                 order=np.array([2, 0, 1], np.int32),
                 senders=np.array([0, 1, 1, 2]),
                 receivers=np.array([1, 0, 2, 1]))
    n = len(c["mask"])
    field = np.linspace(0, 1, n, dtype=np.float32)
    for query, kw in _routes(c["mask"], c["order"], c["senders"],
                             c["receivers"], field):
        _same_result(topology.submit(topology.TopologyRequest(query, **kw),
                                     device="cpu"),
                     _jax_submit(query, **kw))
    if case_name == "out_of_range":
        js = jnp.asarray(c["senders"]), jnp.asarray(c["receivers"])
        ts = _t(c["senders"]), _t(c["receivers"])
        for desc in (True, False):
            _equal(graph_steepest(_t(c["order"]), *ts, desc),
                   j_steepest(jnp.asarray(c["order"]), *js, desc))
        _equal(graph_mask_argmax(_t(c["mask"]), *ts),
               j_mask_argmax(jnp.asarray(c["mask"]), *js))


def test_ids_out_of_range_measured_figures():
    """n = 5, mask [1,1,0,1,1], senders [0,-1,7], receivers [-1,9,2]:
    labels [4,1,-1,3,4] in 1 stitch round and 2 compress iterations, the
    same labels from the mask argmax, and with order [2,4,3,0,1] every
    vertex its own steepest target (as measured with JAX)."""
    m, s, r = (_t(np.array(v)) for v in ([1, 1, 0, 1, 1], [0, -1, 7],
                                         [-1, 9, 2]))
    m = m.bool()
    res = connected_components_graph(m, s, r)
    assert res.labels.tolist() == [4, 1, -1, 3, 4]
    assert (res.n_rounds, res.n_compress_iter) == (1, 2)
    assert graph_mask_argmax(m, s, r).tolist() == [4, 1, -1, 3, 4]
    order = _t(np.array([2, 4, 3, 0, 1], np.int32))
    assert graph_steepest(order, s, r).tolist() == [0, 1, 2, 3, 4]


def test_what_jax_refuses_the_port_refuses():
    """A floating mask (JAX's bitwise and raises TypeError) and edges on a
    graph of 0 vertices (JAX's gather from an empty axis raises)."""
    s, r = np.array([0, 1]), np.array([1, 0])
    fmask = np.ones(2, np.float32)
    with pytest.raises(TypeError):
        j_cc_graph(jnp.asarray(fmask), jnp.asarray(s), jnp.asarray(r))
    with pytest.raises(TypeError, match="bool or integer mask"):
        connected_components_graph(_t(fmask), _t(s), _t(r))
    with pytest.raises(TypeError):
        j_ms_graph(jnp.zeros(0, jnp.int32), jnp.asarray(s), jnp.asarray(r))
    with pytest.raises(ValueError, match="0 vertices"):
        ms_segmentation_graph(_t(np.zeros(0, np.int32)), _t(s), _t(r))


# --- inputs -----------------------------------------------------------------


@pytest.mark.parametrize("shape,conn", [
    ((7,), 2), ((5, 3), 4), ((4, 6), 6), ((4, 3, 5), 6), ((4, 3, 5), 14),
    ((3, 5, 4), 18), ((3, 4, 5), 26), ((1, 3, 2), 14)])
def test_grid_edge_list(shape, conn):
    want = j_grid_edge_list(shape, conn)
    got = grid_edge_list(shape, conn, device="cpu")
    for g, w in zip(got, want):
        _equal(g, w)


@pytest.mark.parametrize("n,deg,seed", [(1, 4, 0), (97, 6, 3),
                                        (4096, 8, 0)])
def test_random_csr(n, deg, seed):
    for g, w in zip(random_csr(n, deg, seed), j_random_csr(n, deg, seed)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_tet_mesh_graph_equals_grid_path():
    """The Freudenthal edge list of a ragged 9x7x5 grid: graph ms and cc
    equal the grid path's at connectivity 14, raveled."""
    shape = (9, 7, 5)
    rng = np.random.default_rng(11)
    order = rng.permutation(int(np.prod(shape))).astype(np.int32).reshape(
        shape)
    mask = rng.random(shape) < 0.4
    edges = dict(zip(("senders", "receivers"),
                     grid_edge_list(shape, 14, device="cpu")))
    for query, kw in (("ms", dict(order=order)), ("cc", dict(mask=mask))):
        grid = topology.submit(topology.TopologyRequest(
            query, connectivity=14, **kw), device="cpu")
        flat = {k: v.reshape(-1) for k, v in kw.items()}
        graph = topology.submit(topology.TopologyRequest(
            query, domain="graph", **flat, **edges), device="cpu")
        for f in ("labels", "ascending", "descending", "segmentation"):
            if getattr(grid, f) is not None:
                assert torch.equal(getattr(graph, f),
                                   getattr(grid, f).reshape(-1)), f


# --- the facade ---------------------------------------------------------------


def test_graph_manifold_raises_jax_error():
    kw = dict(domain="graph", order=np.arange(3, dtype=np.int32),
              senders=np.zeros(1, int), receivers=np.zeros(1, int))
    with pytest.raises(NotImplementedError) as want:
        jtop.submit(jtop.TopologyRequest("manifold", **kw))
    with pytest.raises(NotImplementedError) as got:
        topology.submit(topology.TopologyRequest("manifold", **kw),
                        device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("payloads", [("mask",), ("order",), ("field",),
                                      ("order", "field"),
                                      ("mask", "order", "field"), ()])
def test_request_shape(payloads):
    """The first payload of mask, order, field gives the shape; none
    raises, as in JAX."""
    kw = {p: np.zeros((4 + i, 3), np.int32) for i, p in enumerate(payloads)}
    reqs = (topology.TopologyRequest("cc", **kw),
            jtop.TopologyRequest("cc", **kw))
    if not payloads:
        for req in reqs:
            with pytest.raises(ValueError, match="carries no payload"):
                req.shape()
    else:
        assert reqs[0].shape() == reqs[1].shape() == (4, 3)

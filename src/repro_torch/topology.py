"""Unified topology query API (port of `repro/topology.py`).

Callers describe WHAT they want in a `TopologyRequest` (query kind, domain,
backend, payload) and `submit(request, device=...)` routes it:

    cc,  grid,  pure          core.connected_components.connected_components_grid
    cc,  graph, pure          core.connected_components.connected_components_graph
    cc,  grid,  distributed   core.distributed.distributed_connected_components
    cc,  graph, distributed   core.distributed_graph.distributed_connected_components_graph
    ms,  grid,  pure          core.ms_segmentation.ms_segmentation
    ms,  graph, pure          core.ms_segmentation.ms_segmentation_graph
    ms,  grid,  distributed   two core.distributed.distributed_manifold runs + the pair hash
    manifold, grid, pure      core.ms_segmentation.descending/ascending_manifold
    manifold, grid, distributed  core.distributed.distributed_manifold
    threshold_sweep, *, pure  cc over `field > thresholds[k]`, stacked
    threshold_sweep, *, distributed  one batched call over the K masks

Payloads may be numpy arrays (JAX arrays read back as numpy) or tensors; they
are moved to the device under JAX's x32 canonicalisation
(`interop.canonical_tensor`): int64 edge lists become int32.  The device
defaults to ``"cuda"``; without CUDA the call raises unless
``device="cpu"`` is passed.  A distributed request runs on `mesh.device`.

The distributed backend is rank-local where JAX's facade is global, as the
port's distributed functions are (one process per block or partition):

  * grid: `mask`, `order` and `field` carry this rank's block of the global
    array (`BlockDecomp.block_slices(mesh.coords)`) and `grid_shape` the
    global extent, which `validate()` requires and `shape()` returns (the
    bucketing key stays the global extent, as in JAX).  `labels`,
    `ascending`, `descending` and `segmentation` come back as this rank's
    block; the `ms` pair hash takes the global vertex count.
  * graph: every rank passes the global (n,) mask or field and the global
    edge list (ghost mask values are read from the input, deviation (g1) in
    DESIGN.md) and gets back its own labels, (owned_counts[p],) in the order
    of `decomp.owned_gid[p]` (`assemble_graph_labels` puts them together).
  * `stats` equal JAX's `as_dict()` on every rank.

Validation and its messages, result fields and `meta` keys are the JAX
facade's, and so are the NotImplementedError gaps of the graph domain
(manifolds; MS on distributed graphs).

Order dtypes on the grid `ms` / `manifold` routes: a floating order field
raises JAX's ValueError ("Invalid integer data type 'f'.").  An int64 order
field is cut to int32, as every int64 payload is; JAX's own route raises
OverflowError there (its steepest init pads with an int64 fill that int32
cannot hold, with x64 off), a reference fault that the port does not copy:
its labels equal JAX's on the same field cast to int32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from ._device import resolve_device
from .core._table import check_table_mode
from .core.connected_components import (connected_components_graph,
                                        connected_components_grid)
from .core.distributed import (distributed_connected_components,
                               distributed_connected_components_batch,
                               distributed_manifold)
from .core.distributed_graph import (
    distributed_connected_components_graph,
    distributed_connected_components_graph_batch)
from .core.ms_segmentation import (ms_segmentation, ms_segmentation_graph,
                                   descending_manifold, ascending_manifold,
                                   _pair_hash)
from .interop import canonical_tensor

QUERIES = ("cc", "ms", "manifold", "threshold_sweep")
DOMAINS = ("grid", "graph")
BACKENDS = ("pure", "distributed")


@dataclasses.dataclass(frozen=True)
class TopologyRequest:
    """One topology query.  Payload fields by query kind:

    cc               mask       (grid: bool array of any extent;
                                 graph: (n,) bool + senders/receivers)
    ms / manifold    order      (int order field, as `core.compute_order`
                                 produces; `descending` picks the manifold
                                 direction)
    threshold_sweep  field + thresholds (labels CC of `field > t` per t)

    Graph requests carry both directions of every undirected edge in
    `senders`/`receivers`.  Distributed requests carry `mesh` (a
    `core.DPCMesh`) and, on grids, `grid_shape` (the global extent; the
    payload is this rank's block), on graphs `decomp` (a
    `core.GraphDecomp`); see the module docstring.  `tag` is an opaque
    caller id, round-tripped onto the result.
    """
    query: str
    domain: str = "grid"
    backend: str = "pure"
    # payloads (query-dependent; unused fields stay None)
    mask: Any = None
    order: Any = None
    field: Any = None
    thresholds: Any = None
    senders: Any = None
    receivers: Any = None
    # knobs
    connectivity: int = 6
    descending: bool = True
    gather_mask: bool = True
    table_mode: str = "replicated"
    table_max_iter: int = 64
    # distributed plumbing
    mesh: Any = None
    decomp: Any = None
    grid_shape: Any = None
    tag: Any = None

    def validate(self) -> None:
        if self.query not in QUERIES:
            raise ValueError(f"query {self.query!r} not in {QUERIES}")
        if self.domain not in DOMAINS:
            raise ValueError(f"domain {self.domain!r} not in {DOMAINS}")
        if self.backend not in BACKENDS:
            raise ValueError(f"backend {self.backend!r} not in {BACKENDS}")
        need = {"cc": ("mask",), "ms": ("order",), "manifold": ("order",),
                "threshold_sweep": ("field", "thresholds")}[self.query]
        for f in need:
            if getattr(self, f) is None:
                raise ValueError(f"{self.query} request needs {f}=")
        if self.domain == "graph" and (self.senders is None
                                       or self.receivers is None):
            raise ValueError("graph requests need senders= and receivers=")
        check_table_mode(self.table_mode)
        if self.table_mode != "replicated" and self.backend != "distributed":
            raise ValueError("table_mode='sharded' needs "
                             "backend='distributed' (the pure backends "
                             "have no boundary table)")
        if self.backend == "distributed":
            if self.mesh is None:
                raise ValueError("distributed requests need mesh=")
            if self.domain == "graph" and self.decomp is None:
                raise ValueError("distributed graph requests need decomp= "
                                 "(a core.GraphDecomp)")
            if self.domain == "grid" and self.grid_shape is None:
                raise ValueError("distributed grid requests need "
                                 "grid_shape= (the global extent; the "
                                 "payload is this rank's block)")

    def shape(self):
        """Extent of the request's payload (the bucketing key input): the
        global extent of a distributed grid request."""
        if self.backend == "distributed" and self.grid_shape is not None:
            return tuple(int(x) for x in self.grid_shape)
        for f in ("mask", "order", "field"):
            v = getattr(self, f)
            if v is not None:
                return tuple(v.shape)
        raise ValueError("request carries no payload")


@dataclasses.dataclass
class TopologyResult:
    """Facade result.  `labels` carries the query's label array (cc and
    manifold: one array shaped like the input; threshold_sweep: a leading
    (K,) thresholds dim); `ascending`/`descending`/`segmentation` are set
    for ms queries.  `stats` is the distributed backend's DPCStats /
    GraphDPCStats as a dict (`as_dict()`; ms: one a direction); `meta`
    holds the pure backend's counters (rounds/iters) as ints.  Distributed
    labels are rank-local (module docstring).
    """
    query: str
    labels: Any = None
    ascending: Any = None
    descending: Any = None
    segmentation: Any = None
    stats: dict | None = None
    meta: dict = dataclasses.field(default_factory=dict)
    tag: Any = None


def _unported(req: TopologyRequest) -> None:
    """JAX's own graph gaps, with its messages."""
    if req.domain == "graph" and req.query == "manifold":
        raise NotImplementedError(
            "manifolds on distributed graphs need an order-field halo "
            "through GraphDecomp's ghost layer (ROADMAP carried item); "
            "for single-device graphs use query='ms'")
    if (req.domain, req.query, req.backend) == ("graph", "ms",
                                                "distributed"):
        raise NotImplementedError(
            "MS on distributed graphs needs the order-field halo "
            "(ROADMAP carried item)")


def _edges(req, device):
    """(senders, receivers) on the device for a pure graph request, else
    None (the distributed graph backend reads its `decomp`)."""
    if req.domain != "graph" or req.backend == "distributed":
        return None
    return (canonical_tensor(req.senders, device),
            canonical_tensor(req.receivers, device))


def _grid_order(req, device):
    """The order field of a grid ms / manifold request.  A floating one
    raises the ValueError JAX's steepest init raises (`np.iinfo` of its
    dtype); an int64 one is cut to int32 (module docstring)."""
    order = canonical_tensor(req.order, device)
    if order.is_floating_point():
        np.iinfo(np.dtype(str(order.dtype).removeprefix("torch.")))
    return order


def _dist(req):
    """The distributed knobs shared by every distributed call."""
    return dict(table_mode=req.table_mode, table_max_iter=req.table_max_iter)


def _submit_cc(req, device) -> TopologyResult:
    mask, edges = canonical_tensor(req.mask, device), _edges(req, device)
    if req.backend == "distributed":
        if req.domain == "graph":
            labels, st = distributed_connected_components_graph(
                mask, req.decomp, req.mesh, req.gather_mask, **_dist(req))
        else:
            labels, st = distributed_connected_components(
                mask, req.mesh, req.grid_shape, req.connectivity,
                req.gather_mask, **_dist(req))
        return TopologyResult("cc", labels=labels, stats=st.as_dict(),
                              tag=req.tag)
    res = (connected_components_graph(mask, *edges) if edges is not None
           else connected_components_grid(mask, req.connectivity))
    return TopologyResult("cc", labels=res.labels, tag=req.tag,
                          meta={"n_rounds": res.n_rounds,
                                "n_compress_iter": res.n_compress_iter})


def _submit_manifold(req, device) -> TopologyResult:
    order = _grid_order(req, device)
    if req.backend == "distributed":
        labels, st = distributed_manifold(
            order, req.mesh, req.grid_shape, req.connectivity,
            req.descending, **_dist(req))
        return TopologyResult("manifold", labels=labels, stats=st.as_dict(),
                              tag=req.tag)
    fn = descending_manifold if req.descending else ascending_manifold
    labels, it = fn(order, req.connectivity)
    return TopologyResult("manifold", labels=labels.reshape(order.shape),
                          meta={"n_iter": it}, tag=req.tag)


def _submit_ms(req, device) -> TopologyResult:
    edges = _edges(req, device)
    if edges is not None:
        res = ms_segmentation_graph(canonical_tensor(req.order, device),
                                    *edges)
    elif req.backend == "pure":
        res = ms_segmentation(_grid_order(req, device), req.connectivity)
    else:
        # both manifold directions + the (desc, asc) pair hash, with the
        # GLOBAL vertex count (JAX hashes with the global array's size)
        order = _grid_order(req, device)
        desc, st_d = distributed_manifold(
            order, req.mesh, req.grid_shape, req.connectivity,
            descending=True, **_dist(req))
        asc, st_a = distributed_manifold(
            order, req.mesh, req.grid_shape, req.connectivity,
            descending=False, **_dist(req))
        seg = _pair_hash(desc, asc, math.prod(req.grid_shape))
        return TopologyResult("ms", ascending=asc, descending=desc,
                              segmentation=seg,
                              stats={"descending": st_d.as_dict(),
                                     "ascending": st_a.as_dict()},
                              tag=req.tag)
    return TopologyResult("ms", ascending=res.ascending,
                          descending=res.descending,
                          segmentation=res.segmentation,
                          meta={"n_iter_asc": res.n_iter_asc,
                                "n_iter_desc": res.n_iter_desc},
                          tag=req.tag)


def _submit_sweep(req, device) -> TopologyResult:
    """CC of `field > t` for every threshold t, one field, on either domain;
    the pure route loops and stacks (the JAX facade vmaps), the distributed
    route makes one batched call over the K masks.  No threshold gives int32
    labels of shape (0, *labels) and runs no CC, as JAX's vmap over zero
    rows does (labels: the field's shape, or this rank's owned count on a
    distributed graph)."""
    thr = canonical_tensor(req.thresholds, device).reshape(-1)
    field = canonical_tensor(req.field, device)
    edges = _edges(req, device)
    if thr.numel() == 0:
        shape = field.shape
        if (req.backend, req.domain) == ("distributed", "graph"):
            shape = (int(req.decomp.owned_counts[req.mesh.rank]),)
        empty = torch.empty((0, *shape), dtype=torch.int32, device=device)
        return TopologyResult("threshold_sweep", labels=empty, tag=req.tag)
    if req.backend == "distributed":
        masks = field[None] > thr.reshape((-1,) + (1,) * field.dim())
        if req.domain == "graph":
            labels, st = distributed_connected_components_graph_batch(
                masks, req.decomp, req.mesh, req.gather_mask, **_dist(req))
        else:
            labels, st = distributed_connected_components_batch(
                masks, req.mesh, req.grid_shape, req.connectivity,
                req.gather_mask, **_dist(req))
        return TopologyResult("threshold_sweep", labels=labels,
                              stats=st.as_dict(), tag=req.tag)
    labels = torch.stack([
        (connected_components_graph(field > t, *edges) if edges is not None
         else connected_components_grid(field > t, req.connectivity)).labels
        for t in thr])
    return TopologyResult("threshold_sweep", labels=labels, tag=req.tag)


_ROUTES = {"cc": _submit_cc, "ms": _submit_ms, "manifold": _submit_manifold,
           "threshold_sweep": _submit_sweep}


def submit(request: TopologyRequest, device=None) -> TopologyResult:
    """Route one request to its implementation on `device` (default
    ``"cuda"``; raises without CUDA unless ``device="cpu"``); a distributed
    request runs on its mesh's device."""
    request.validate()
    _unported(request)
    if request.backend == "distributed":
        device = request.mesh.device
    return _ROUTES[request.query](request, resolve_device(device))


def submit_many(requests, device=None) -> list:
    """Sequential reference path: one `submit` per request."""
    return [submit(r, device) for r in requests]


__all__ = ["TopologyRequest", "TopologyResult", "submit", "submit_many",
           "QUERIES", "DOMAINS", "BACKENDS"]

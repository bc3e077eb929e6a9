"""Unified topology query API (port of `repro/topology.py`).

Callers describe WHAT they want in a `TopologyRequest` (query kind, domain,
backend, payload) and `submit(request, device=...)` routes it:

    cc,  grid,  pure          core.connected_components.connected_components_grid
    cc,  graph, pure          core.connected_components.connected_components_graph
    ms,  grid,  pure          core.ms_segmentation.ms_segmentation
    ms,  graph, pure          core.ms_segmentation.ms_segmentation_graph
    manifold, grid, pure      core.ms_segmentation.descending/ascending_manifold
    threshold_sweep, *, pure  cc over `field > thresholds[k]`, stacked

Payloads may be numpy arrays (JAX arrays read back as numpy) or tensors; they
are moved to the device under JAX's x32 canonicalisation
(`interop.canonical_tensor`): int64 edge lists become int32.  The device
defaults to ``"cuda"``; without CUDA the call raises unless
``device="cpu"`` is passed.

Validation and its messages, result fields and `meta` keys are the JAX
facade's, and so are the NotImplementedError gaps of the graph domain
(manifolds; MS on distributed graphs).  The distributed backend comes in a
later slice of the port and raises NotImplementedError here.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ._device import resolve_device
from .core._table import check_table_mode
from .core.connected_components import (connected_components_graph,
                                        connected_components_grid)
from .core.ms_segmentation import (ms_segmentation, ms_segmentation_graph,
                                   descending_manifold, ascending_manifold)
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
    `senders`/`receivers`.  `tag` is an opaque caller id, round-tripped onto
    the result.  The distributed fields are validated as in JAX; that
    backend comes in a later slice.
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

    def shape(self):
        """Extent of the request's payload (the bucketing key input)."""
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
    for ms queries.  `stats` belongs to the distributed backend; `meta`
    holds counters (rounds/iters) as ints.
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
    """The routes that raise: JAX's own graph gaps, with its messages, then
    the distributed backend, not yet ported."""
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
    if req.backend == "distributed":
        raise NotImplementedError(
            "the distributed backend comes with the port's distributed "
            "slice (ROADMAP Queue 1: core/distributed.py over "
            "torch.distributed); repro_torch runs backend='pure'")


def _edges(req, device):
    """(senders, receivers) on the device for a graph request, else None."""
    if req.domain != "graph":
        return None
    return (canonical_tensor(req.senders, device),
            canonical_tensor(req.receivers, device))


def _cc(req, mask, edges):
    if edges is not None:
        return connected_components_graph(mask, *edges)
    return connected_components_grid(mask, req.connectivity)


def _submit_cc(req, device) -> TopologyResult:
    res = _cc(req, canonical_tensor(req.mask, device), _edges(req, device))
    return TopologyResult("cc", labels=res.labels, tag=req.tag,
                          meta={"n_rounds": res.n_rounds,
                                "n_compress_iter": res.n_compress_iter})


def _submit_manifold(req, device) -> TopologyResult:
    order = canonical_tensor(req.order, device)
    fn = descending_manifold if req.descending else ascending_manifold
    labels, it = fn(order, req.connectivity)
    return TopologyResult("manifold", labels=labels.reshape(order.shape),
                          meta={"n_iter": it}, tag=req.tag)


def _submit_ms(req, device) -> TopologyResult:
    order, edges = canonical_tensor(req.order, device), _edges(req, device)
    if edges is not None:
        res = ms_segmentation_graph(order, *edges)
    else:
        res = ms_segmentation(order, req.connectivity)
    return TopologyResult("ms", ascending=res.ascending,
                          descending=res.descending,
                          segmentation=res.segmentation,
                          meta={"n_iter_asc": res.n_iter_asc,
                                "n_iter_desc": res.n_iter_desc},
                          tag=req.tag)


def _submit_sweep(req, device) -> TopologyResult:
    """CC of `field > t` for every threshold t, one field, on either domain;
    the JAX facade vmaps over thresholds, the port loops and stacks.  No
    threshold gives int32 labels of shape (0, *field.shape) and runs no CC,
    as JAX's vmap over zero rows does."""
    thr = canonical_tensor(req.thresholds, device).reshape(-1)
    field = canonical_tensor(req.field, device)
    if thr.numel() == 0:
        empty = torch.empty((0, *field.shape), dtype=torch.int32,
                            device=device)
        return TopologyResult("threshold_sweep", labels=empty, tag=req.tag)
    edges = _edges(req, device)
    labels = torch.stack([_cc(req, field > t, edges).labels for t in thr])
    return TopologyResult("threshold_sweep", labels=labels, tag=req.tag)


_ROUTES = {"cc": _submit_cc, "ms": _submit_ms, "manifold": _submit_manifold,
           "threshold_sweep": _submit_sweep}


def submit(request: TopologyRequest, device=None) -> TopologyResult:
    """Route one request to its implementation on `device` (default
    ``"cuda"``; raises without CUDA unless ``device="cpu"``)."""
    request.validate()
    _unported(request)
    return _ROUTES[request.query](request, resolve_device(device))


def submit_many(requests, device=None) -> list:
    """Sequential reference path: one `submit` per request."""
    return [submit(r, device) for r in requests]


__all__ = ["TopologyRequest", "TopologyResult", "submit", "submit_many",
           "QUERIES", "DOMAINS", "BACKENDS"]

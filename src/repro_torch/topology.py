"""Unified topology query API (port of `repro/topology.py`).

Callers describe WHAT they want in a `TopologyRequest` (query kind, domain,
backend, payload) and `submit(request, device=...)` routes it:

    cc,  grid,  pure          core.connected_components.connected_components_grid
    ms,  grid,  pure          core.ms_segmentation.ms_segmentation
    manifold, grid, pure      core.ms_segmentation.descending/ascending_manifold
    threshold_sweep, grid, pure   cc over `field > thresholds[k]`, stacked

Payloads may be numpy arrays (JAX arrays read back as numpy) or tensors; they
are moved to the device under JAX's x32 canonicalisation
(`interop.canonical_tensor`).  The device defaults to ``"cuda"``; without
CUDA the call raises unless ``device="cpu"`` is passed.

Validation and its messages, result fields and `meta` keys are the JAX
facade's.  The graph domain and the distributed backend come in later
slices of the port and raise NotImplementedError here.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ._device import resolve_device
from .core.connected_components import connected_components_grid
from .core.ms_segmentation import (ms_segmentation, descending_manifold,
                                   ascending_manifold)
from .interop import canonical_tensor

QUERIES = ("cc", "ms", "manifold", "threshold_sweep")
DOMAINS = ("grid", "graph")
BACKENDS = ("pure", "distributed")
TABLE_MODES = ("replicated", "sharded")


def check_table_mode(table_mode: str) -> None:
    if table_mode not in TABLE_MODES:
        raise ValueError(
            f"table_mode must be one of {TABLE_MODES}, got {table_mode!r}")


@dataclasses.dataclass(frozen=True)
class TopologyRequest:
    """One topology query.  Payload fields by query kind:

    cc               mask       (grid: bool array of any extent)
    ms / manifold    order      (int order field, as `core.compute_order`
                                 produces; `descending` picks the manifold
                                 direction)
    threshold_sweep  field + thresholds (labels CC of `field > t` per t)

    `tag` is an opaque caller id, round-tripped onto the result.  The graph
    and distributed fields are validated as in JAX; their routes come in
    later slices.
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
    if req.domain == "graph":
        raise NotImplementedError(
            "graph-domain queries come with the port's graph slice "
            "(ROADMAP Queue 1: graph init/CC); repro_torch runs grid queries")
    if req.backend == "distributed":
        raise NotImplementedError(
            "the distributed backend comes with the port's distributed "
            "slice (ROADMAP Queue 1: core/distributed.py over "
            "torch.distributed); repro_torch runs backend='pure'")


def _submit_cc(req, device) -> TopologyResult:
    res = connected_components_grid(canonical_tensor(req.mask, device),
                                    req.connectivity)
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
    res = ms_segmentation(canonical_tensor(req.order, device),
                          req.connectivity)
    return TopologyResult("ms", ascending=res.ascending,
                          descending=res.descending,
                          segmentation=res.segmentation,
                          meta={"n_iter_asc": res.n_iter_asc,
                                "n_iter_desc": res.n_iter_desc},
                          tag=req.tag)


def _submit_sweep(req, device) -> TopologyResult:
    """CC of `field > t` for every threshold t, one field; the JAX facade
    vmaps over thresholds, the port loops and stacks.  No threshold gives
    int32 labels of shape (0, *field.shape) and runs no CC, as JAX's vmap
    over zero rows does."""
    thr = canonical_tensor(req.thresholds, device).reshape(-1)
    field = canonical_tensor(req.field, device)
    if thr.numel() == 0:
        empty = torch.empty((0, *field.shape), dtype=torch.int32,
                            device=device)
        return TopologyResult("threshold_sweep", labels=empty, tag=req.tag)
    labels = torch.stack([
        connected_components_grid(field > t, req.connectivity).labels
        for t in thr])
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

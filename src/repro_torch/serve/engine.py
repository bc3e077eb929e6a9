"""Batched multi-tenant topology query engine (port of
`repro/serve/engine.py`, DESIGN.md §Serve) and the async deadline-aware
serving plane on top of it (DESIGN.md §Serve-v2, §Serve-v3).

`TopologyEngine.submit_batch` takes heterogeneous `TopologyRequest`s (mixed
shapes, mixed query kinds) and serves them through a handful of cached
executables, with the JAX engine's plan step for step:

  expand   every request unbundles into uniform work items: an MS request
           becomes its two manifold directions, a threshold sweep becomes
           one CC item per threshold (the K masks come from ONE broadcast
           compare against the single field), ascending manifolds are
           flipped (``n - 1 - order``, n the GLOBAL vertex count) so every
           manifold item runs the descending program;
  bucket   items group by padded layout — extents round up to the next
           power of two (`serve.bucketing`), so arbitrary request shapes
           collapse onto few layouts; graph items group by their mesh
           geometry; adjacent layouts can merge under a cost model
           (`slot_cost_cells`, `bucketing.merge_adjacent_layouts`);
  execute  one cached batched callable per bucket chunk, at a pow2 batch
           capacity whose slack is filled with inert dummy slots; the
           callables live in a bounded LRU (`SharedExecutableCache`) with
           hit/miss/eviction counters;
  restore  labels slice back to each request's real extent and label VALUES
           remap from padded-shape flat ids to real-shape flat ids, which
           makes every engine result BIT-IDENTICAL to the sequential
           `repro_torch.topology.submit` path.

The port runs eagerly, so the JAX engine's compiled executable becomes a
batched callable built once per executable key (`_build_executable`): a
pure grid bucket runs `connected_components_grid` or `descending_manifold`
on each slot of the stacked padded batch (the fused kernel launches once a
slot, dummy slots included), a pure graph bucket `connected_components_graph`
or `path_compress(graph_steepest(...))` a slot, and a distributed bucket
makes ONE call to the batched distributed function, whose collectives fire
once for the batch.  A build is counted where JAX counts a compile, so on
the same pure request stream `stats.as_dict()` and `cache_info()` equal the
JAX engine's.  The pow2 layouts and dummy slots are kept although eager
execution does not need them.  Payloads, stacks and labels stay on the
engine's device (``"cuda"`` unless the caller names another; a distributed
request runs on `mesh.device`): stacking, padding and remapping are tensor
ops there, and results are `topology.TopologyResult`s of device tensors.
Every payload passes through `interop.canonical_tensor`, as
`topology.submit` does, so a float64 numpy field is compared in float32
and engine == facade holds for it.

Deviations from the JAX engine, all in batching and counters, never in
labels:
  * A distributed grid request holds this rank's block and `grid_shape`
    (the facade's contract).  A rank cannot pad the global grid to a pow2
    layout (the padded grid would cut into other blocks), so distributed
    grid items bucket by the EXACT global `grid_shape` and are not
    layout-padded; their capacity dummy slots are inert blocks of the
    rank's block shape.  `pad_waste` counts the global extent times the
    capacity, and such buckets never take part in the cost-model merge.
    The mesh part of a bucket key is `(mesh.names, mesh.layout, id(mesh))`.
  * The batched distributed functions check convergence eagerly over all
    slots and raise (`core._table.check_converged`), where the JAX engine
    re-checks the real slots after the call; split-retry then isolates the
    request that did not converge, as in JAX.
  * Collectives hang unless every rank flushes the same buckets in the same
    order.  `AsyncTopologyEngine.submit` therefore raises ValueError for a
    distributed request on a mesh of more than one rank unless the clock is
    a `VirtualClock` and execution time is not charged to it (wall-clock
    reads differ between ranks).

`AsyncTopologyEngine` adds the request plane: `submit()` returns a
`TopologyHandle` future, work items queue in a `FlushScheduler` and execute
when a bucket fills its pow2 capacity, when an admission deadline would
otherwise be missed, or on `drain()`; a failed bucket execution retries by
splitting in half so one poisoned request cannot sink its cohort; and
idempotency-key replays are served from a small result cache.  Admission
budgets (`max_queue_depth` / `max_inflight_cells`) refuse work with a typed
`Overloaded` error on the handle, a `shed_policy` drops queued requests
whose deadline is unmeetable with a typed `DeadlineShed` error, deadline
flushes run in slack order, and a `SharedExecutableCache` lets engines
share builds.  Typed plane errors surface on handles — never as exceptions
out of `submit()` / `poll()` / `drain()`.

`EngineStats` aggregates requests/items/batches, executable-cache hits,
misses and evictions, pad waste, flush reasons (each bucket execution is
counted under exactly one reason, so the four flush counters always sum to
`batches`), queue depth, rejections/sheds, retries/failures, deadline hits,
and per-request latency sums.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import math
import time
from typing import Any

import numpy as np
import torch

from .._device import resolve_device
from ..core.connected_components import (connected_components_graph,
                                         connected_components_grid)
from ..core.distributed import (distributed_connected_components_batch,
                                distributed_manifold_batch)
from ..core.distributed_graph import (
    distributed_connected_components_graph_batch)
from ..core.ms_segmentation import _pair_hash, descending_manifold
from ..core.pathcompress import path_compress
from ..core.steepest import graph_steepest
from ..interop import canonical_tensor
from ..topology import TopologyRequest, TopologyResult, _grid_order
from .bucketing import (batch_capacity, bucket_shape, merge_adjacent_layouts,
                        pad_to, pad_waste, remap_flat_labels)
from .compile_cache import SharedExecutableCache
from .scheduler import (FlushScheduler, MonotonicClock, VirtualClock,
                        check_shed_policy)


class PlaneError(Exception):
    """Base of the typed serving-plane errors.  These surface on handles
    (`TopologyHandle.exception()`), never as exceptions escaping `submit()`
    / `poll()` / `drain()` — callers distinguish plane decisions from real
    execution failures by this type."""


class Overloaded(PlaneError):
    """Admission refused: a budget (`max_queue_depth` /
    `max_inflight_cells`) would be exceeded.  Nothing was queued; the
    caller may retry later."""


class DeadlineShed(PlaneError):
    """The request was admitted but dropped by the shed policy because its
    deadline became unmeetable before it executed."""


@dataclasses.dataclass
class EngineStats:
    """Aggregate serving counters (host-side, monotonically increasing)."""
    requests: int = 0
    items: int = 0          # work items after expansion (ms=2, sweep=K)
    batches: int = 0        # bucket-chunk executions
    cache_hits: int = 0     # executable reused for a bucket execution
    cache_misses: int = 0   # executable built for a new layout key
    cache_evictions: int = 0  # executables dropped by the LRU bound
    real_cells: int = 0     # payload cells actually requested
    padded_cells: int = 0   # cells executed after layout + batch padding
    # why each bucket execution ran (exactly one reason per execution, so
    # these four always sum to `batches`)
    flush_capacity: int = 0   # bucket filled its pow2 batch capacity
    flush_deadline: int = 0   # earliest deadline would otherwise be missed
    flush_drain: int = 0      # explicit drain (sync submit_batch flushes
                              # count here: every submit_batch is an
                              # immediate drain of its own buckets)
    flush_retry: int = 0      # re-execution of a split half after a failure
    # async request plane
    retries: int = 0        # failed executions that were split and retried
    completed: int = 0      # handles resolved with a result
    failures: int = 0       # handles resolved with an exception
    dedup_hits: int = 0     # idempotency-key replays served without work
    # overload plane (DESIGN.md §Serve-v3).  `requests`/`items` count only
    # ADMITTED work, so after a drain: completed + failures + shed ==
    # requests, while rejected tracks refused submissions separately.
    rejected: int = 0       # submissions refused at admission (Overloaded)
    shed: int = 0           # admitted requests dropped by the shed policy
    queue_depth_limit: int = 0  # rejections charged to max_queue_depth
                                # (the rest hit max_inflight_cells)
    deadline_hits: int = 0     # requests completed at or before deadline
    deadline_misses: int = 0   # requests completed after their deadline
    queue_depth_peak: int = 0  # max items queued in the scheduler at once
    latency_count: int = 0     # requests with a recorded latency
    latency_sum: float = 0.0   # sum of completion - submission (clock units)

    @property
    def hit_rate(self) -> float:
        total = self.cache_hits + self.cache_misses
        return self.cache_hits / total if total else 0.0

    @property
    def pad_fraction(self) -> float:
        return (1.0 - self.real_cells / self.padded_cells
                if self.padded_cells else 0.0)

    @property
    def deadline_hit_rate(self) -> float:
        total = self.deadline_hits + self.deadline_misses
        return self.deadline_hits / total if total else 1.0

    @property
    def latency_mean(self) -> float:
        return self.latency_sum / self.latency_count if self.latency_count \
            else 0.0

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["hit_rate"] = self.hit_rate
        d["pad_fraction"] = self.pad_fraction
        d["deadline_hit_rate"] = self.deadline_hit_rate
        d["latency_mean"] = self.latency_mean
        return d


@dataclasses.dataclass
class _WorkItem:
    """One uniform unit of work after request expansion."""
    kind: str               # "cc" | "manifold" (ms and sweeps are expanded)
    domain: str
    backend: str
    payload: torch.Tensor   # real-extent mask (bool) / order field (int;
                            # ascending already flipped), on the device; a
                            # distributed grid item: this rank's block
    shape: tuple            # the request's extent (`TopologyRequest.shape`:
                            # the global extent of a distributed grid)
    connectivity: int
    gather_mask: bool
    table_mode: str         # boundary/cut table layout (deviation (s))
    table_max_iter: int
    mesh: Any               # distributed only
    decomp: Any             # distributed graph only
    senders: Any            # graph only (as the request holds them)
    receivers: Any          # graph only
    req_idx: int
    role: tuple             # ("labels",) | ("desc",) | ("asc",) |
                            # ("sweep", k)

    @property
    def cells(self) -> int:
        """Payload cells of the request's extent (global on a distributed
        grid, so that every rank counts alike)."""
        return math.prod(self.shape)


# position of the padded layout inside a grid bucket key (see _bucket_key);
# merged buckets execute every member under the layout IN THE KEY, which may
# dominate the member's own next-pow2 layout
_GRID_LAYOUT_SLOT = 5

_FLUSH_FIELDS = {"capacity": "flush_capacity", "deadline": "flush_deadline",
                 "drain": "flush_drain", "retry": "flush_retry"}


def _dtype_name(t: torch.Tensor) -> str:
    """A tensor dtype under numpy's name ("bool", "int32"), as the JAX
    engine writes it into an executable key."""
    return str(t.dtype).removeprefix("torch.")


class TopologyEngine:
    """Batched serving front-end for `TopologyRequest`s.

    min_extent:      smallest padded grid extent (bucket floor).
    max_batch:       largest batch capacity per execution; bucket
                     occupancies beyond it run in chunks.
    cache_capacity:  bound on live executables (LRU eviction; None
                     disables the bound).  The default is sized so
                     repeated-layout workloads never evict — replaying a
                     workload still builds nothing.
    slot_cost_cells: cost model for merging adjacent pow2 layouts — a
                     smaller layout folds into a dominating one when its
                     modeled extra pad cells stay below this many cells
                     (None/0 disables merging; DESIGN.md §Serve-v2).
    compile_cache:   a `SharedExecutableCache` to attach to; multiple
                     engines sharing one build each executable exactly
                     once between them (DESIGN.md §Serve-v3).  None builds
                     a private cache of `cache_capacity` (when a shared
                     cache is passed, its own capacity governs and
                     `cache_capacity` is ignored).
    name:            owner tag for per-engine hit/miss attribution in the
                     shared cache (auto-numbered when None).
    device:          where pure requests run: ``"cuda"`` unless given;
                     raises without CUDA unless ``device="cpu"``
                     (`_device.resolve_device`).  Distributed requests run
                     on their mesh's device.
    """

    def __init__(self, min_extent: int = 8, max_batch: int = 64,
                 cache_capacity: int | None = 64,
                 slot_cost_cells: int | None = None,
                 compile_cache: SharedExecutableCache | None = None,
                 name: str | None = None, device=None):
        self.device = resolve_device(device)
        self.min_extent = int(min_extent)
        self.max_batch = int(max_batch)
        self.slot_cost_cells = slot_cost_cells
        self.stats = EngineStats()
        self.cache = (compile_cache if compile_cache is not None
                      else SharedExecutableCache(capacity=cache_capacity))
        self.cache_capacity = self.cache.capacity
        self._owner = self.cache.attach(name)
        self._bucket_runs: dict = {}   # exec key -> executions served

    @property
    def _exec(self):
        """The (possibly shared) executable store, exec key -> (fn,
        has_stats)."""
        return self.cache._store

    # --- public API -----------------------------------------------------------

    def submit(self, request: TopologyRequest) -> TopologyResult:
        return self.submit_batch([request])[0]

    def submit_batch(self, requests) -> list:
        """Serve a batch of requests; results keep submission order and are
        bit-identical to `repro_torch.topology.submit` per request."""
        for r in requests:
            r.validate()
        items = []
        for idx, req in enumerate(requests):
            items.extend(self._expand(idx, req))
        self.stats.requests += len(requests)
        self.stats.items += len(items)

        buckets: dict = {}
        for it in items:
            buckets.setdefault(self._bucket_key(it), []).append(it)
        buckets = self._merge_grid_buckets(buckets)

        outputs: dict = {}   # (req_idx, role) -> (labels, stats or None)
        for key, group in buckets.items():
            for lo in range(0, len(group), self.max_batch):
                self._run_bucket(key, group[lo:lo + self.max_batch], outputs,
                                 reason="drain")

        return [self._assemble(idx, req, outputs)
                for idx, req in enumerate(requests)]

    def cache_info(self) -> dict:
        return {"hits": self.stats.cache_hits,
                "misses": self.stats.cache_misses,
                "evictions": self.stats.cache_evictions,
                "size": len(self._exec),
                "capacity": self.cache_capacity,
                "hit_rate": self.stats.hit_rate,
                "runs_per_executable": dict(self._bucket_runs),
                "owner": self._owner,
                "shared": self.cache.info()}

    # --- request expansion ----------------------------------------------------

    def _expand(self, idx: int, req: TopologyRequest) -> list:
        dev = req.mesh.device if req.backend == "distributed" \
            else self.device

        def item(kind, payload, role):
            return _WorkItem(kind=kind, domain=req.domain,
                             backend=req.backend, payload=payload,
                             shape=req.shape(),
                             connectivity=req.connectivity,
                             gather_mask=req.gather_mask,
                             table_mode=req.table_mode,
                             table_max_iter=req.table_max_iter,
                             mesh=req.mesh, decomp=req.decomp,
                             senders=req.senders, receivers=req.receivers,
                             req_idx=idx, role=role)

        if req.query in ("manifold", "ms") and (
                req.domain == "graph" and req.backend == "distributed"):
            raise NotImplementedError(
                "manifold/MS on distributed graphs needs the order-field "
                "halo through GraphDecomp's ghost layer (ROADMAP carried "
                "item)")

        if req.query == "cc":
            return [item("cc", canonical_tensor(req.mask, dev).bool(),
                         ("labels",))]
        if req.query in ("manifold", "ms"):
            order = (_grid_order(req, dev) if req.domain == "grid"
                     else canonical_tensor(req.order, dev))
            if req.query == "manifold" and req.descending:
                return [item("manifold", order, ("labels",))]
            # the flip takes the global vertex count: a rank's block of a
            # distributed grid flips as `distributed_manifold` does
            flipped = math.prod(req.shape()) - 1 - order
            if req.query == "manifold":
                return [item("manifold", flipped, ("labels",))]
            return [item("manifold", order, ("desc",)),
                    item("manifold", flipped, ("asc",))]
        # threshold_sweep: K masks from ONE broadcast compare of the single
        # field; each enters the shared cc bucket of its layout
        field = canonical_tensor(req.field, dev)
        thr = canonical_tensor(req.thresholds, dev).reshape(-1)
        masks = field[None] > thr.reshape((-1,) + (1,) * field.dim())
        return [item("cc", masks[k], ("sweep", k))
                for k in range(thr.numel())]

    # --- bucketing / executables ----------------------------------------------

    def _bucket_key(self, it: _WorkItem) -> tuple:
        if it.domain == "grid":
            if it.backend == "pure":
                mesh_key = None
                layout = bucket_shape(it.shape, self.min_extent)
            else:
                # the exact global extent: a rank cannot pad the global grid
                # (module docstring)
                mesh_key = (it.mesh.names, it.mesh.layout, id(it.mesh))
                layout = tuple(it.shape)
            # the layout sits at _GRID_LAYOUT_SLOT — _run_bucket pads to the
            # key's layout, not the item's, so merged buckets stay coherent
            return ("grid", it.backend, it.kind, it.connectivity,
                    it.gather_mask, layout, mesh_key, it.table_mode,
                    it.table_max_iter)
        if it.backend == "pure":
            # same-geometry masks batch together; the executable is
            # nonetheless shared across graphs of equal (n, m) because the
            # edge lists are arguments of the call (see _exec_key)
            graph_key = (it.payload.shape[0], _numel(it.senders),
                         id(it.senders), id(it.receivers))
        else:
            graph_key = (id(it.decomp), it.gather_mask, it.table_mode,
                         it.table_max_iter)
        return ("graph", it.backend, it.kind, graph_key)

    def _merge_grid_buckets(self, buckets: dict) -> dict:
        """Apply the cost-model merge plan: pure grid buckets that differ
        ONLY in layout fold into an adjacent dominating layout when the
        modeled pad waste is cheaper than an executable slot (bit-identical
        either way — restore remaps label values from whatever layout
        actually ran).  Distributed grid buckets keep their exact extent."""
        if not self.slot_cost_cells:
            return buckets
        families: dict = {}   # key minus layout -> [full keys]
        for key in buckets:
            if key[:2] == ("grid", "pure"):
                fam = key[:_GRID_LAYOUT_SLOT] + key[_GRID_LAYOUT_SLOT + 1:]
                families.setdefault(fam, []).append(key)
        for keys in families.values():
            if len(keys) < 2:
                continue
            plan = merge_adjacent_layouts(
                {k[_GRID_LAYOUT_SLOT]: len(buckets[k]) for k in keys},
                self.slot_cost_cells)
            for k in keys:
                tgt_layout = plan[k[_GRID_LAYOUT_SLOT]]
                if tgt_layout != k[_GRID_LAYOUT_SLOT]:
                    tgt = (k[:_GRID_LAYOUT_SLOT] + (tgt_layout,)
                           + k[_GRID_LAYOUT_SLOT + 1:])
                    buckets.setdefault(tgt, []).extend(buckets.pop(k))
        return buckets

    def _exec_key(self, bkey: tuple, it: _WorkItem, capacity: int) -> tuple:
        if bkey[:2] == ("graph", "pure"):
            # drop the edge-list identity: (n, m) + dtypes determine the
            # executable, so equal-shape graphs share one
            bkey = bkey[:3] + ((it.payload.shape[0], _numel(it.senders)),)
        return bkey + (capacity, _dtype_name(it.payload))

    def _get_executable(self, ekey: tuple, it0: _WorkItem):
        """Lookup-or-build through the (possibly shared) LRU cache; it
        never holds more than its capacity (evictions are counted, and an
        evicted layout is simply built again on its next use —
        bit-identical).  Hits/misses land both on this engine's stats and
        on its attribution row in the cache."""
        built, hit, evicted = self.cache.lookup(
            ekey, lambda: self._build_executable(it0), self._owner)
        if hit:
            self.stats.cache_hits += 1
        else:
            self.stats.cache_misses += 1
        self.stats.cache_evictions += evicted
        return built

    def _build_executable(self, it: _WorkItem):
        """(callable, has_stats) for one executable key.  The callable takes
        the stacked padded payload (plus edge lists for pure graphs) and
        returns labels indexable by slot (and, distributed, the batched
        stats)."""
        conn, gm = it.connectivity, it.gather_mask
        tm, tmi = it.table_mode, it.table_max_iter
        if it.domain == "grid":
            if it.backend == "pure":
                if it.kind == "cc":
                    one = lambda m: connected_components_grid(
                        m, conn).labels
                else:
                    one = lambda o: descending_manifold(
                        o, conn)[0].reshape(o.shape)
                return (lambda stack: [one(x) for x in stack]), False
            mesh, shape = it.mesh, tuple(it.shape)
            if it.kind == "cc":
                fn = lambda b: distributed_connected_components_batch(
                    b, mesh, shape, conn, gm, table_mode=tm,
                    table_max_iter=tmi)
            else:
                fn = lambda b: distributed_manifold_batch(
                    b, mesh, shape, conn, descending=True, table_mode=tm,
                    table_max_iter=tmi)
            return fn, True
        if it.backend == "pure":
            if it.kind == "cc":
                one = lambda m, s, r: connected_components_graph(
                    m, s, r).labels
            else:
                one = lambda o, s, r: path_compress(
                    graph_steepest(o, s, r, descending=True))[0]
            return (lambda stack, s, r: [one(x, s, r) for x in stack]), False
        decomp, mesh = it.decomp, it.mesh
        fn = lambda b: distributed_connected_components_graph_batch(
            b, decomp, mesh, gm, table_mode=tm, table_max_iter=tmi)
        return fn, True

    # --- execution ------------------------------------------------------------

    def _execute(self, fn, group, args):
        """The execution seam: every executable invocation funnels through
        here so fault-injection tests can monkeypatch it (group is passed
        for observability — chosen-request poisoning)."""
        return fn(*args)

    def _run_bucket(self, bkey: tuple, group: list, outputs: dict,
                    reason: str = "drain") -> None:
        it0 = group[0]
        capacity = batch_capacity(len(group), self.max_batch)
        ekey = self._exec_key(bkey, it0, capacity)
        fn, has_stats = self._get_executable(ekey, it0)
        self._bucket_runs[ekey] = self._bucket_runs.get(ekey, 0) + 1
        self.stats.batches += 1
        # exactly one flush reason per execution (counted BEFORE the call,
        # so the reason sum tracks `batches` even when the execution fails)
        field = _FLUSH_FIELDS[reason]
        setattr(self.stats, field, getattr(self.stats, field) + 1)

        # pure grids pad to the key's layout; distributed grid blocks and
        # graphs never pad the extent
        padded = (bkey[_GRID_LAYOUT_SLOT] if bkey[:2] == ("grid", "pure")
                  else tuple(it0.payload.shape))
        fill = False if it0.kind == "cc" else -1
        # one stack on the device: each real payload padded into its slot,
        # the capacity slack left as all-inert dummy slots
        stack = it0.payload.new_empty((capacity,) + tuple(padded))
        for pos, g in enumerate(group):
            pad_to(g.payload, padded, fill, out=stack[pos])
        stack[len(group):] = fill
        real, padded_cells = pad_waste(
            [g.shape for g in group],
            bkey[_GRID_LAYOUT_SLOT] if it0.domain == "grid" else padded,
            capacity)
        self.stats.real_cells += real
        self.stats.padded_cells += padded_cells

        if (it0.domain, it0.backend) == ("graph", "pure"):
            dev = stack.device
            out = self._execute(fn, group,
                                (stack, canonical_tensor(it0.senders, dev),
                                 canonical_tensor(it0.receivers, dev)))
        else:
            out = self._execute(fn, group, (stack,))
        labels, stats = out if has_stats else (out, None)
        del stack

        # a batched (distributed) output is one tensor: a real slot is
        # cloned out of it when dummy slots follow, so that a held result
        # does not keep them alive
        own = has_stats and capacity > len(group)
        for pos, g in enumerate(group):
            lab = (remap_flat_labels(labels[pos], padded, g.payload.shape)
                   if (g.domain, g.backend) == ("grid", "pure")
                   else labels[pos].clone() if own else labels[pos])
            st = (None if stats is None else
                  {f: v[pos].item() for f, v in zip(stats._fields, stats)})
            outputs[(g.req_idx, g.role)] = (lab, st)

    # --- result assembly ------------------------------------------------------

    def _assemble(self, idx: int, req: TopologyRequest,
                  outputs: dict) -> TopologyResult:
        if req.query in ("cc", "manifold"):
            lab, st = outputs[(idx, ("labels",))]
            return TopologyResult(req.query, labels=lab, stats=st,
                                  tag=req.tag)
        if req.query == "ms":
            desc, st_d = outputs[(idx, ("desc",))]
            asc, st_a = outputs[(idx, ("asc",))]
            # the pair hash over the global vertex count, wrapping in int32
            # as the JAX engine's numpy int32 product does
            seg = _pair_hash(desc, asc, math.prod(req.shape()))
            stats = (None if st_d is None
                     else {"descending": st_d, "ascending": st_a})
            return TopologyResult("ms", ascending=asc, descending=desc,
                                  segmentation=seg, stats=stats, tag=req.tag)
        # threshold_sweep
        labs, sts = [], []
        for k in range(_numel(req.thresholds)):
            lab, st = outputs[(idx, ("sweep", k))]
            labs.append(lab)
            sts.append(st)
        stats = (None if sts[0] is None else
                 {f: [s[f] for s in sts] for f in sts[0]})
        return TopologyResult("threshold_sweep", labels=torch.stack(labs),
                              stats=stats, tag=req.tag)


def _numel(a) -> int:
    """Element count of a tensor or anything numpy reads (edge lists and
    thresholds as the request holds them)."""
    return a.numel() if isinstance(a, torch.Tensor) else int(np.size(a))


# --- async request plane (DESIGN.md §Serve-v2) --------------------------------


class TopologyHandle:
    """Future-like handle for one async request.

    The serving plane is cooperative (single-threaded): `result()` on a
    pending handle drains the engine — deterministic, and bit-identical to
    whatever a later flush would have produced anyway."""

    __slots__ = ("request", "deadline", "idempotency_key", "submitted_at",
                 "completed_at", "_engine", "_result", "_exc", "_done")

    def __init__(self, engine, request, deadline=None, idempotency_key=None):
        self.request = request
        self.deadline = deadline
        self.idempotency_key = idempotency_key
        self.submitted_at = None
        self.completed_at = None
        self._engine = engine
        self._result = None
        self._exc = None
        self._done = False

    def done(self) -> bool:
        return self._done

    def exception(self):
        """The exception this handle surfaced, or None (does not force a
        flush; pending handles return None)."""
        return self._exc

    def result(self) -> TopologyResult:
        if not self._done:
            self._engine.drain()
        if self._exc is not None:
            raise self._exc
        return self._result


@dataclasses.dataclass
class _Pending:
    """Book-keeping for one in-flight async request."""
    handle: TopologyHandle
    request: TopologyRequest
    need: set               # roles still expected in the outputs dict


class AsyncTopologyEngine(TopologyEngine):
    """Deadline-aware async front-end over the batched engine.

    `submit()` enqueues and returns a `TopologyHandle`; buckets flush when
    they fill their pow2 capacity, when `poll()`/`advance()` finds an
    admission deadline that would otherwise be missed (deadline minus the
    scheduler's measured per-layout execute estimate), or on `drain()`.
    Results are bit-identical to sequential `repro_torch.topology.submit`
    regardless of arrival order, flush timing, retries, or cache evictions.

    clock:  time source for deadlines/latencies — `MonotonicClock` by
            default, a `VirtualClock` for deterministic tests.  A
            distributed request on a mesh of more than one rank needs a
            `VirtualClock` without `charge_execution_time` (module
            docstring); otherwise `submit` raises ValueError.
    default_estimate:  cold-start execute estimate for never-measured
            buckets; None picks `scheduler.COLD_START_ESTIMATE` (an
            explicit 0.0 restores "flush exactly at the deadline").
    charge_execution_time:  advance a virtual clock by the measured wall
            duration of each execution (virtual-time open-loop runs).
    result_cache_capacity:  LRU bound on cached idempotency-key results.
    max_queue_depth:  admission budget on queued work items; a submission
            that would exceed it returns a rejected handle with a typed
            `Overloaded` error (None = unbounded).
    max_inflight_cells:  admission budget on queued payload cells (the
            memory-shaped analogue of queue depth; None = unbounded).
    shed_policy:  "never" (default) keeps every admitted request;
            "late" sheds queued requests whose deadline already passed;
            "hopeless" also sheds those the execute estimate says cannot
            finish in time.  Shed handles fail with `DeadlineShed`.
    """

    def __init__(self, min_extent: int = 8, max_batch: int = 64,
                 cache_capacity: int | None = 64,
                 slot_cost_cells: int | None = None, clock=None,
                 default_estimate: float | None = None,
                 charge_execution_time: bool = False,
                 result_cache_capacity: int = 256,
                 max_queue_depth: int | None = None,
                 max_inflight_cells: int | None = None,
                 shed_policy: str = "never",
                 compile_cache: SharedExecutableCache | None = None,
                 name: str | None = None, device=None):
        super().__init__(min_extent=min_extent, max_batch=max_batch,
                         cache_capacity=cache_capacity,
                         slot_cost_cells=slot_cost_cells,
                         compile_cache=compile_cache, name=name,
                         device=device)
        self.clock = clock if clock is not None else MonotonicClock()
        self.scheduler = FlushScheduler(capacity=self.max_batch,
                                        clock=self.clock,
                                        default_estimate=default_estimate)
        self._charge = (bool(charge_execution_time)
                        and hasattr(self.clock, "advance"))
        self.result_cache_capacity = int(result_cache_capacity)
        self.max_queue_depth = (None if max_queue_depth is None
                                else int(max_queue_depth))
        self.max_inflight_cells = (None if max_inflight_cells is None
                                   else int(max_inflight_cells))
        self.shed_policy = check_shed_policy(shed_policy)
        self._inflight_cells = 0    # payload cells currently queued
        self._rid = itertools.count()
        self._pending: dict = {}    # rid -> _Pending
        self._outputs: dict = {}    # (rid, role) -> (labels, stats)
        self._inflight: dict = {}   # idempotency key -> pending handle
        self._results = collections.OrderedDict()  # idem key -> result (LRU)
        self.latencies: list = []   # per-request latency, clock units

    # --- admission ------------------------------------------------------------

    def _check_ranks_agree(self, request: TopologyRequest) -> None:
        """Every rank of a mesh must flush the same buckets in the same
        order, or a collective hangs; only a virtual clock that no wall
        time is charged to makes the flush decisions the same on every
        rank."""
        if (request.backend == "distributed" and request.mesh.size > 1
                and (not isinstance(self.clock, VirtualClock)
                     or self._charge)):
            raise ValueError(
                f"a distributed request on a mesh of {request.mesh.size} "
                f"ranks needs a VirtualClock without charge_execution_time:"
                f" flush decisions read from a wall clock differ between "
                f"ranks and the collectives would hang (clock "
                f"{type(self.clock).__name__}, charge_execution_time="
                f"{self._charge})")

    def submit(self, request: TopologyRequest, deadline: float | None = None,
               idempotency_key=None) -> TopologyHandle:
        """Enqueue one request; returns a handle (NOT a result — use
        `submit_batch` for the synchronous path).  `deadline` is an absolute
        clock time the request should complete by; `idempotency_key` replays
        are deduplicated against in-flight requests and a bounded result
        cache without executing anything.  Past an admission budget the
        handle comes back already failed with `Overloaded` — submit never
        raises for overload (typed plane errors stay on handles)."""
        request.validate()
        self._check_ranks_agree(request)
        if idempotency_key is not None:
            # dedup before admission: replays cost no queue space, so they
            # are served even when the plane is refusing new work
            cached = self._results.get(idempotency_key)
            if cached is not None:
                self.stats.dedup_hits += 1
                self._results.move_to_end(idempotency_key)
                h = TopologyHandle(self, request, deadline, idempotency_key)
                h.submitted_at = h.completed_at = self.clock.now()
                h._result, h._done = cached, True
                return h
            if idempotency_key in self._inflight:
                self.stats.dedup_hits += 1
                return self._inflight[idempotency_key]

        rid = next(self._rid)
        items = self._expand(rid, request)
        refusal = self._admission_error(items)
        if refusal is not None:
            # rejected: nothing queued, no rid book-keeping, not counted
            # in requests/items — the handle carries the typed error
            self.stats.rejected += 1
            h = TopologyHandle(self, request, deadline, idempotency_key)
            h.submitted_at = h.completed_at = self.clock.now()
            h._exc, h._done = refusal, True
            return h

        handle = TopologyHandle(self, request, deadline, idempotency_key)
        handle.submitted_at = self.clock.now()
        self.stats.requests += 1
        self.stats.items += len(items)
        self._pending[rid] = _Pending(handle, request,
                                      {it.role for it in items})
        if idempotency_key is not None:
            self._inflight[idempotency_key] = handle
        for it in items:
            self.scheduler.enqueue(self._bucket_key(it), it, deadline)
            self._inflight_cells += it.cells
        self.stats.queue_depth_peak = max(self.stats.queue_depth_peak,
                                          self.scheduler.depth())
        self._shed_pass()   # a hopeless submission sheds before any flush
        for key in self.scheduler.full():
            self._flush(key, "capacity")
        self.poll()
        return handle

    def _admission_error(self, items) -> Overloaded | None:
        """The typed refusal this submission would get, or None to admit."""
        if self.max_queue_depth is not None:
            depth = self.scheduler.depth()
            if depth + len(items) > self.max_queue_depth:
                self.stats.queue_depth_limit += 1
                return Overloaded(
                    f"queue depth {depth} + {len(items)} items would exceed "
                    f"max_queue_depth={self.max_queue_depth}")
        if self.max_inflight_cells is not None:
            cells = sum(it.cells for it in items)
            if self._inflight_cells + cells > self.max_inflight_cells:
                return Overloaded(
                    f"queued payload {self._inflight_cells} + {cells} cells "
                    f"would exceed max_inflight_cells="
                    f"{self.max_inflight_cells}")
        return None

    # --- flush triggers -------------------------------------------------------

    def poll(self) -> int:
        """Shed what the policy says is unmeetable, then flush every bucket
        whose earliest deadline would be missed by waiting longer (in slack
        order — most overdue first); returns the number of buckets flushed.
        Call after time passes (a `VirtualClock` advance, or periodically
        on a real clock)."""
        self._shed_pass()
        flushed = 0
        for key in self.scheduler.due():
            self._flush(key, "deadline")
            flushed += 1
        return flushed

    def advance(self, dt: float) -> int:
        """Virtual-clock convenience: advance time, then poll."""
        self.clock.advance(dt)
        return self.poll()

    def drain(self) -> None:
        """Flush everything queued (end of a burst / shutdown).  Drain is
        the one flush with a global view, so the cost-model layout merge
        applies here (capacity/deadline flushes act on single buckets)."""
        self._shed_pass()
        popped = self.scheduler.pop_all()
        self._uncharge(e for v in popped.values() for e in v)
        buckets = {k: [e.item for e in v] for k, v in popped.items()}
        buckets = self._merge_grid_buckets(buckets)
        for key, group in buckets.items():
            self._execute_group(key, group, "drain")

    def pending(self) -> int:
        """Requests admitted but not yet resolved."""
        return len(self._pending)

    # --- load shedding --------------------------------------------------------

    def _uncharge(self, entries) -> None:
        """Release the inflight-cells admission budget for entries leaving
        the queue (flush, drain, shed, or sibling purge)."""
        for e in entries:
            self._inflight_cells -= e.item.cells

    def _shed_pass(self) -> int:
        """Apply the shed policy: drop queued entries whose deadline is
        unmeetable, fail their requests with a typed `DeadlineShed`, and
        purge each shed request's sibling items from other buckets so no
        execution is wasted on a request that can no longer succeed.
        Returns the number of requests shed."""
        if self.shed_policy == "never":
            return 0
        dropped = self.scheduler.shed(self.shed_policy)
        if not dropped:
            return 0
        self._uncharge(e for _, e in dropped)
        now = self.clock.now()
        by_rid: dict = {}
        for key, e in dropped:
            by_rid.setdefault(e.item.req_idx, (key, e))
        n = 0
        for rid in sorted(by_rid):
            key, e = by_rid[rid]
            self._uncharge(self.scheduler.purge(
                lambda it, rid=rid: it.req_idx == rid))
            exc = DeadlineShed(
                f"deadline {e.deadline:.6f} unmeetable at t={now:.6f} "
                f"(bucket estimate {self.scheduler.estimate(key):.6f}s, "
                f"shed_policy={self.shed_policy!r})")
            self._fail_request(rid, exc, counter="shed")
            n += 1
        return n

    # --- execution with split-retry -------------------------------------------

    def _flush(self, key, reason: str) -> None:
        entries = self.scheduler.pop(key)
        self._uncharge(entries)
        group = [e.item for e in entries]
        if group:
            self._execute_group(key, group, reason)

    def _execute_group(self, key, group: list, reason: str) -> None:
        for lo in range(0, len(group), self.max_batch):
            self._run_resilient(key, group[lo:lo + self.max_batch], reason)
        self._settle(group)

    def _run_resilient(self, key, chunk: list, reason: str) -> None:
        """Run one bucket chunk; on failure retry by splitting in half, so
        a poisoned request bisects down to a singleton and surfaces its
        exception on its own handle while every cohort member re-batches
        and completes."""
        t0 = self.clock.now()
        w0 = time.perf_counter()
        try:
            self._run_bucket(key, chunk, self._outputs, reason)
        except Exception as exc:                       # noqa: BLE001
            if len(chunk) == 1:
                self._fail(chunk[0], exc)
                return
            self.stats.retries += 1
            half = len(chunk) // 2
            self._run_resilient(key, chunk[:half], "retry")
            self._run_resilient(key, chunk[half:], "retry")
            return
        if self._charge:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()    # the work queued on the card
            self.clock.advance(time.perf_counter() - w0)
        self.scheduler.observe(key, self.clock.now() - t0)

    # --- completion -----------------------------------------------------------

    def _settle(self, group: list) -> None:
        """Resolve every request whose outputs are now complete; outputs of
        already-resolved (failed) requests are dropped."""
        for rid in sorted({it.req_idx for it in group}):
            rec = self._pending.get(rid)
            if rec is None:
                for it in group:
                    if it.req_idx == rid:
                        self._outputs.pop((rid, it.role), None)
                continue
            if all((rid, role) in self._outputs for role in rec.need):
                result = self._assemble(rid, rec.request, self._outputs)
                for role in rec.need:
                    del self._outputs[(rid, role)]
                del self._pending[rid]
                self._resolve(rec.handle, result)

    def _resolve(self, handle: TopologyHandle, result: TopologyResult):
        now = self.clock.now()
        handle._result, handle._done = result, True
        handle.completed_at = now
        lat = now - handle.submitted_at
        self.latencies.append(lat)
        self.stats.completed += 1
        self.stats.latency_count += 1
        self.stats.latency_sum += lat
        if handle.deadline is not None:
            if now <= handle.deadline:
                self.stats.deadline_hits += 1
            else:
                self.stats.deadline_misses += 1
        if handle.idempotency_key is not None:
            self._inflight.pop(handle.idempotency_key, None)
            self._results[handle.idempotency_key] = result
            self._results.move_to_end(handle.idempotency_key)
            while len(self._results) > self.result_cache_capacity:
                self._results.popitem(last=False)

    def _fail(self, item: _WorkItem, exc: BaseException) -> None:
        self._fail_request(item.req_idx, exc)

    def _fail_request(self, rid: int, exc: BaseException,
                      counter: str = "failures") -> None:
        """Resolve a request's handle with an exception, charged to the
        given stats counter ("failures" for execution errors, "shed" for
        policy drops)."""
        rec = self._pending.pop(rid, None)
        if rec is None or rec.handle._done:
            return
        rec.handle._exc, rec.handle._done = exc, True
        rec.handle.completed_at = self.clock.now()
        setattr(self.stats, counter, getattr(self.stats, counter) + 1)
        for role in rec.need:   # drop any sibling outputs already produced
            self._outputs.pop((rid, role), None)
        if rec.handle.idempotency_key is not None:
            # failures are never cached: a replayed key re-executes
            self._inflight.pop(rec.handle.idempotency_key, None)

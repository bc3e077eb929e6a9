"""Deterministic synthetic request workloads for the topology engine (port
of `repro/serve/workload.py`).

Used by the runnable demo (`examples/serve_topology_torch.py`) and the card
smoke run (`chip_smoke.py`, phase 11): a seeded mix of CC /
MS-segmentation / threshold-sweep requests over a rotating set of grid
extents — the "many small heterogeneous tenants" traffic shape the engine
buckets.  Every request is a pure function of (seed, index), so repeated
workloads exercise the executable cache the way real repeated-layout
traffic does.

Reproducibility contract: `seed` is EXPLICIT (no default — a CI failure
must name the seed that produced it), and a workload is replayable from a
`WorkloadTrace` value alone: the trace records every generation parameter
plus the open-loop arrival/deadline schedule, and `trace.requests()`
regenerates the identical request list anywhere (`trace.as_dict()` is the
JSON-safe form for bug reports and bench artifacts).

The RNG streams are the JAX package's, draw for draw, so a trace gives the
same request contents in both packages: masks are numpy compares of the
float64 draws, order fields `compute_order` of the float32 field, sweep
thresholds float64 quantiles cut to float32, as JAX's x32 arrays hold them.
Payloads are tensors on `device` (``"cuda"`` unless the caller names
another).  A distributed request carries this rank's block of each global
payload (`BlockDecomp.block_slices(mesh.coords)`) and `grid_shape`, on
`mesh.device`; every rank draws the global field from the seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import resolve_device
from ..core.distributed import BlockDecomp
from ..core.ids import compute_order
from ..interop import canonical_tensor
from ..topology import TopologyRequest

_DEFAULT_MIX = (("cc", 0.5), ("ms", 0.2), ("manifold", 0.1),
                ("threshold_sweep", 0.2))


def _block(x, sl):
    """This rank's block of a global payload (`sl` None: the payload)."""
    return x if sl is None else x[sl].contiguous()


def synthetic_requests(n_requests: int, shapes, mix=None, connectivity=6,
                       sweep_k: int = 4, *, seed: int, backend: str = "pure",
                       mesh=None, table_mode: str = "replicated",
                       device=None) -> list:
    """A deterministic list of mixed TopologyRequests.

    shapes: tuple of grid extents to rotate through; mix: tuple of
    (query, weight) over {"cc", "ms", "manifold", "threshold_sweep"};
    seed: required keyword — the single knob that reproduces a workload.
    `table_mode` applies to distributed backends only (sharded boundary
    table, deviation (s)); request contents are independent of it.
    device: where the payloads live (``"cuda"`` unless given; a
    distributed workload lives on `mesh.device`).
    """
    mix = mix or _DEFAULT_MIX
    queries = [q for q, _ in mix]
    weights = np.asarray([w for _, w in mix], dtype=float)
    weights = weights / weights.sum()
    dev = mesh.device if backend == "distributed" else resolve_device(device)
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n_requests):
        shape = shapes[int(rng.integers(len(shapes)))]
        query = queries[int(rng.choice(len(queries), p=weights))]
        field = rng.standard_normal(shape)
        common = dict(connectivity=connectivity, backend=backend, mesh=mesh,
                      tag=i)
        sl = None
        if backend == "distributed":
            common.update(table_mode=table_mode, grid_shape=tuple(shape))
            sl = BlockDecomp(shape, mesh.layout, mesh.names).block_slices(
                mesh.coords)
        if query == "cc":
            mask = torch.from_numpy(field > rng.uniform(-0.5, 0.5)).to(dev)
            reqs.append(TopologyRequest("cc", mask=_block(mask, sl),
                                        **common))
        elif query in ("ms", "manifold"):
            order = compute_order(canonical_tensor(field, dev))
            reqs.append(TopologyRequest(
                query, order=_block(order, sl), descending=bool(i % 2),
                **common))
        else:
            thr = np.quantile(field, np.linspace(0.2, 0.9, sweep_k))
            reqs.append(TopologyRequest(
                "threshold_sweep",
                field=_block(canonical_tensor(field, dev), sl),
                thresholds=canonical_tensor(thr, dev), **common))
    return reqs


def open_loop_arrivals(n_requests: int, rate: float, *, seed: int,
                       deadline_slack: float | None = None) -> tuple:
    """Open-loop (Poisson) arrival schedule: `n_requests` pairs of
    (arrival_time, deadline-or-None) with exponential inter-arrivals at
    `rate` requests per time unit.  Deadlines, when `deadline_slack` is
    set, are `arrival + U(0.5, 1.5) * deadline_slack` — jittered so a
    trace mixes tight and loose deadlines.  Deterministic in `seed`
    (a separate stream from the payload RNG, so arrival timing never
    perturbs request contents)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xA11, 1]))
    t = np.cumsum(rng.exponential(1.0 / rate, size=n_requests))
    if deadline_slack is None:
        return tuple((float(ti), None) for ti in t)
    slack = rng.uniform(0.5, 1.5, size=n_requests) * deadline_slack
    return tuple((float(ti), float(ti + si)) for ti, si in zip(t, slack))


@dataclasses.dataclass(frozen=True)
class WorkloadTrace:
    """A replayable workload: generation parameters + arrival schedule.

    The trace IS the workload — `requests()` regenerates the identical
    request list from the recorded parameters, and `arrivals` carries the
    per-request (arrival_time, deadline) pairs (empty for closed-loop
    traces).  Frozen and JSON-safe so a failing CI run can dump it and a
    local run can replay it verbatim."""
    seed: int
    n_requests: int
    shapes: tuple
    mix: tuple = _DEFAULT_MIX
    connectivity: int = 6
    sweep_k: int = 4
    arrivals: tuple = ()     # ((arrival_time, deadline-or-None), ...) or ()

    def requests(self, backend: str = "pure", mesh=None,
                 table_mode: str = "replicated", device=None) -> list:
        return synthetic_requests(
            self.n_requests, self.shapes, mix=self.mix,
            connectivity=self.connectivity, sweep_k=self.sweep_k,
            seed=self.seed, backend=backend, mesh=mesh,
            table_mode=table_mode, device=device)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["shapes"] = [list(s) for s in self.shapes]
        d["mix"] = [[q, w] for q, w in self.mix]
        d["arrivals"] = [list(a) for a in self.arrivals]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "WorkloadTrace":
        return cls(seed=int(d["seed"]), n_requests=int(d["n_requests"]),
                   shapes=tuple(tuple(s) for s in d["shapes"]),
                   mix=tuple((q, float(w)) for q, w in d["mix"]),
                   connectivity=int(d["connectivity"]),
                   sweep_k=int(d["sweep_k"]),
                   arrivals=tuple(
                       (float(t), None if dl is None else float(dl))
                       for t, dl in d["arrivals"]))


def synthetic_trace(n_requests: int, shapes, mix=None, connectivity=6,
                    sweep_k: int = 4, *, seed: int, rate: float | None = None,
                    deadline_slack: float | None = None) -> WorkloadTrace:
    """Build a replayable trace; `rate` adds an open-loop arrival schedule
    (and `deadline_slack` per-request deadlines) for the async plane."""
    arrivals = (() if rate is None else
                open_loop_arrivals(n_requests, rate, seed=seed,
                                   deadline_slack=deadline_slack))
    return WorkloadTrace(seed=int(seed), n_requests=int(n_requests),
                         shapes=tuple(tuple(s) for s in shapes),
                         mix=tuple(mix or _DEFAULT_MIX),
                         connectivity=int(connectivity),
                         sweep_k=int(sweep_k), arrivals=arrivals)


def overload_trace(n_requests: int, shapes, mix=None, connectivity=6,
                   sweep_k: int = 4, *, seed: int, sustainable_rps: float,
                   factor: float = 4.0,
                   deadline_periods: float = 2.0) -> WorkloadTrace:
    """An oversubscribed open-loop trace for exercising admission control
    and load shedding (DESIGN.md §Serve-v3): Poisson arrivals at `factor`
    times a measured sustainable rate, with deadlines about
    `deadline_periods` mean service periods out — tight enough that a
    `factor`x backlog makes many of them unmeetable.  `sustainable_rps`
    should come from a measurement (e.g. the warm closed-loop rate of
    `chip_smoke.py`'s phase 11a); everything else is deterministic in `seed`,
    so the SAME trace value replays the same overload anywhere."""
    if sustainable_rps <= 0:
        raise ValueError(f"sustainable_rps must be > 0, "
                         f"got {sustainable_rps}")
    return synthetic_trace(
        n_requests, shapes, mix=mix, connectivity=connectivity,
        sweep_k=sweep_k, seed=seed,
        rate=float(factor) * float(sustainable_rps),
        deadline_slack=float(deadline_periods) / float(sustainable_rps))

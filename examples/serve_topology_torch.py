"""Serving topology queries on the PyTorch/CUDA port: the batched
multi-tenant engine (`repro_torch.serve`), the twin of
`examples/serve_topology.py`.

Builds a mixed workload (CC masks, Morse-Smale segmentations, manifold
queries, threshold sweeps, over several ragged grid extents), serves it
through `repro_torch.serve.TopologyEngine`, and checks the contracts from
DESIGN.md §Serve / §Serve-v2:

  1. every batched result is bit-identical to the sequential
     `repro_torch.topology.submit` path,
  2. replaying the same layouts builds nothing new — every bucket is
     served from the executable cache (hit rate > 0), and
  3. the async deadline-aware plane (queueing, capacity/deadline flushes
     on a virtual clock) returns the SAME bits through future-style
     handles, from a workload trace replayable by its seed alone.

Runs on the CUDA card unless `--cpu` is given (without a card and without
`--cpu` it raises):

  PYTHONPATH=src python examples/serve_topology_torch.py [--cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.configs.serve_topology import smoke_config  # noqa: E402
from repro_torch.serve import (AsyncTopologyEngine, TopologyEngine,  # noqa: E402
                               VirtualClock)
from repro_torch.serve.workload import synthetic_trace  # noqa: E402
from repro_torch.topology import submit_many  # noqa: E402

FIELDS = ("labels", "ascending", "descending", "segmentation")


def same(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        assert x is None or (x.dtype == y.dtype and torch.equal(x, y)), f


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA card")
    args = ap.parse_args()
    device = torch.device("cpu" if args.cpu else "cuda")

    cfg = smoke_config()
    # the trace IS the workload: seed + parameters regenerate identical
    # requests anywhere (drop trace.as_dict() in a bug report to replay it)
    trace = synthetic_trace(10, cfg.shapes, mix=cfg.mix,
                            connectivity=cfg.connectivity,
                            sweep_k=cfg.sweep_k, seed=0,
                            rate=cfg.rate, deadline_slack=cfg.deadline_slack)
    reqs = trace.requests(device=device)
    print(f"workload: {len(reqs)} requests over extents "
          f"{sorted({r.shape() for r in reqs})} on {device}")

    eng = TopologyEngine(min_extent=cfg.min_extent, max_batch=cfg.max_batch,
                         device=device)
    t0 = time.perf_counter()
    batched = eng.submit_batch(reqs)
    sync(device)
    t_batched = time.perf_counter() - t0
    s = eng.stats
    print(f"cold pass: {len(reqs)} requests -> {s.items} items -> "
          f"{s.batches} executions in {t_batched * 1e3:.0f}ms "
          f"(pad_fraction={s.pad_fraction:.2f})")

    # contract 1: bit-identical to the sequential facade
    t0 = time.perf_counter()
    sequential = submit_many(reqs, device)
    sync(device)
    t_seq = time.perf_counter() - t0
    for b, q in zip(batched, sequential):
        same(b, q)
    print(f"parity: engine == sequential facade, bit-for-bit "
          f"(sequential pass took {t_seq * 1e3:.0f}ms)")

    # contract 2: replaying the layouts hits the executable cache
    misses = s.cache_misses
    t0 = time.perf_counter()
    eng.submit_batch(reqs)
    sync(device)
    t_warm = time.perf_counter() - t0
    assert s.cache_misses == misses, "replay must not build anything new"
    assert s.cache_hits > 0 and s.hit_rate > 0
    print(f"warm pass: {t_warm * 1e3:.0f}ms "
          f"({len(reqs) / max(t_warm, 1e-9):.0f} req/s); "
          f"cache {s.cache_hits} hits / {s.cache_misses} misses "
          f"(hit_rate={s.hit_rate:.2f})")
    print("engine stats:", eng.stats.as_dict())

    # contract 3: the async plane — open-loop arrivals with deadlines on a
    # virtual clock; handles resolve on capacity/deadline flushes (or the
    # final drain) and carry the same bits as the sequential facade
    aeng = AsyncTopologyEngine(min_extent=cfg.min_extent,
                               max_batch=cfg.max_batch,
                               cache_capacity=cfg.cache_capacity,
                               slot_cost_cells=cfg.slot_cost_cells or None,
                               clock=VirtualClock(), device=device)
    handles = []
    for req, (t_arr, deadline) in zip(trace.requests(device=device),
                                      trace.arrivals):
        if t_arr > aeng.clock.now():
            aeng.advance(t_arr - aeng.clock.now())     # may deadline-flush
        handles.append(aeng.submit(req, deadline=deadline))
    aeng.drain()
    for h, q in zip(handles, sequential):
        assert h.done() and h.exception() is None
        same(h.result(), q)
    sa = aeng.stats
    assert (sa.flush_capacity + sa.flush_deadline + sa.flush_drain
            + sa.flush_retry == sa.batches)
    print(f"async plane: {len(handles)} handles resolved bit-identically; "
          f"flushes capacity={sa.flush_capacity} "
          f"deadline={sa.flush_deadline} drain={sa.flush_drain}; "
          f"deadline_hit_rate={sa.deadline_hit_rate:.2f}; "
          f"virtual latency mean={sa.latency_mean * 1e3:.1f}ms")
    print("OK")


if __name__ == "__main__":
    main()

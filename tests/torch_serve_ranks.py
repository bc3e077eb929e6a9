"""Rank side of `tests/test_torch_serve_distributed.py`: one gloo group of 4
CPU ranks serves distributed requests through the port's engine
(`repro_torch.serve`) and holds every result to the port's facade
(`repro_torch.topology.submit`) on this rank, then writes what it checked
to `<out>/rank<r>.pt`.

    python tests/torch_serve_ranks.py RANK WORLD STORE_FILE OUT_DIR

Imports torch and the port only (no jax).  Every rank builds the global
inputs from the same seeds with numpy and cuts its own block
(`BlockDecomp.block_slices(mesh.coords)`).  Each check is recorded under a
name of `CHECKS` as True or as the text of what went wrong.
"""
import math
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

WORLD = 4
LAYOUT = (2, 2)
MODES = ("replicated", "sharded")
# the engine-vs-facade workload (JAX's `_DIST_WORKER`): three cc masks over
# (9, 7), (9, 7) and (11, 5) (one JAX layout, (16, 8); one bucket each here),
# an ms and a two-threshold sweep over (9, 7), a graph cc over 4 parts
SYNC_TAGS = ("cc0", "cc1", "cc2", "ms", "sw", "gcc")
ASYNC_TAGS = (0, 1, 2)
# the port's synthetic workload over (2, 2): smoke-config extents, both
# table modes
TRACE_SHAPES = ((17, 13, 11), (13, 11, 7), (16, 12, 8))
TRACE_N = 8
# the ragged ascending flip: n - 1 - order with n the GLOBAL vertex count
RAGGED = (13, 11, 7)
RAGGED_SEED = 13
CHECKS = (
    [f"sync/{t}" for t in SYNC_TAGS]
    + ["sync/comm_phases", "sync/buckets_by_exact_extent",
       "sync/pad_waste_counts_global_extent", "sync/replay_builds_nothing"]
    + [f"async/{t}" for t in ASYNC_TAGS]
    + ["async/flush_reasons", "async/not_converged_fails_alone"]
    + [f"trace/{m}/{e}" for m in MODES for e in ("sync", "async")]
    + ["ragged/ascending", "ragged/ms", "ragged/one_bucket",
       "ragged/results_release_the_dummy_slot"]
    + ["guard/monotonic_clock_raises", "guard/charged_clock_raises",
       "guard/virtual_clock_serves", "guard/one_rank_monotonic_serves"])

FIELDS = ("labels", "ascending", "descending", "segmentation")


def same(got, want):
    """'' when two TopologyResults agree (query, tag, every label field
    bit for bit and dtype, stats), else what differs."""
    if (got.query, got.tag) != (want.query, want.tag):
        return f"query/tag {(got.query, got.tag)} != {(want.query, want.tag)}"
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if (a is None) != (b is None):
            return f"{f}: one side is None"
        if a is not None and (a.dtype != b.dtype or not torch.equal(a, b)):
            return f"{f} differs"
    if got.stats != want.stats:
        return f"stats {got.stats} != {want.stats}"
    return ""


def main(rank, world, store, out_dir):
    from repro_torch.core.distributed import BlockDecomp, make_dpc_mesh
    from repro_torch.core.distributed_graph import GraphDecomp
    from repro_torch.core.ids import compute_order
    from repro_torch.serve import (AsyncTopologyEngine, MonotonicClock,
                                   TopologyEngine, VirtualClock)
    from repro_torch.serve.workload import synthetic_trace
    from repro_torch.topology import TopologyRequest, submit, submit_many

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    one = dist.new_group([0])       # every rank creates it, in this order
    checks = {name: "not run" for name in CHECKS}
    out = {"checks": checks}

    def check(name, ok, what=""):
        checks[name] = True if ok else (what or "failed")

    mesh = make_dpc_mesh(LAYOUT, device="cpu")
    gmesh = make_dpc_mesh(WORLD, device="cpu")

    def block(x, shape):
        sl = BlockDecomp(shape, mesh.layout, mesh.names).block_slices(
            mesh.coords)
        return x[sl].copy()

    def order_of(field):
        return compute_order(torch.from_numpy(field.astype(np.float32))
                             ).numpy()

    # 1. the sync engine == the facade (JAX's engine-vs-facade workload) ---
    rng = np.random.default_rng(0)
    dreq = dict(backend="distributed", mesh=mesh, connectivity=4)
    reqs = []
    for i, shape in enumerate([(9, 7), (9, 7), (11, 5)]):
        reqs.append(TopologyRequest(
            "cc", mask=block(rng.random(shape) < 0.6, shape),
            grid_shape=shape, tag=f"cc{i}", **dreq))
    field = rng.standard_normal((9, 7))
    reqs.append(TopologyRequest("ms", order=block(order_of(field), (9, 7)),
                                grid_shape=(9, 7), tag="ms", **dreq))
    reqs.append(TopologyRequest(
        "threshold_sweep", field=block(field, (9, 7)),
        thresholds=np.quantile(field, [0.4, 0.8]), grid_shape=(9, 7),
        tag="sw", **dreq))
    n, m = 40, 90
    a, b = rng.integers(0, n, m), rng.integers(0, n, m)
    s, r = np.concatenate([a, b]), np.concatenate([b, a])
    part = rng.integers(0, WORLD, n)
    dec = GraphDecomp(n, s, r, WORLD, part=part)
    reqs.append(TopologyRequest(
        "cc", domain="graph", backend="distributed", mesh=gmesh, decomp=dec,
        mask=rng.random(n) < 0.7, senders=s, receivers=r, tag="gcc"))
    eng = TopologyEngine(min_extent=8, max_batch=8, device="cpu")
    got, want = eng.submit_batch(reqs), submit_many(reqs)
    for g, w in zip(got, want):
        d = same(g, w)
        check(f"sync/{g.tag}", not d, d)
    phases = []
    for g in got:
        v = g.stats.get("comm_phases",
                        g.stats.get("descending", {}).get("comm_phases"))
        phases += v if isinstance(v, list) else [v]
    check("sync/comm_phases", phases and all(x == 1 for x in phases),
          str(phases))
    cc_layouts = sorted(k[5] for k in eng._bucket_runs if k[:3] == (
        "grid", "distributed", "cc"))
    check("sync/buckets_by_exact_extent",
          eng.stats.batches == 4 and cc_layouts == [(9, 7), (11, 5)],
          f"batches {eng.stats.batches}, cc layouts {cc_layouts}")
    # cc (9, 7) x 4 (two masks + two sweep masks), cc (11, 5), the ms's two
    # manifolds, the graph's 40 vertices: no layout padding, no dummy slot
    cells = 4 * 63 + 55 + 2 * 63 + 40
    check("sync/pad_waste_counts_global_extent",
          eng.stats.real_cells == eng.stats.padded_cells == cells,
          f"{eng.stats.real_cells} / {eng.stats.padded_cells} != {cells}")
    misses = eng.stats.cache_misses
    again = eng.submit_batch(reqs)
    check("sync/replay_builds_nothing",
          eng.stats.cache_misses == misses
          and eng.stats.cache_hits >= misses
          and all(not same(x, w) for x, w in zip(again, want)),
          f"misses {misses} -> {eng.stats.cache_misses}")

    # 2. the async plane on a VirtualClock (JAX's `_ASYNC_DIST_WORKER`) ----
    rng = np.random.default_rng(0)
    reqs = [TopologyRequest("cc", mask=block(rng.random((9, 7)) < 0.6,
                                             (9, 7)),
                            grid_shape=(9, 7), tag=i, **dreq)
            for i in range(3)]
    want = submit_many(reqs)
    aeng = AsyncTopologyEngine(min_extent=8, max_batch=2,
                               clock=VirtualClock(), device="cpu")
    h0 = aeng.submit(reqs[0], deadline=1.0)
    order = [not h0.done()]
    h1 = aeng.submit(reqs[1])             # fills capacity 2 -> flush
    order += [h0.done(), h1.done()]
    h2 = aeng.submit(reqs[2], deadline=0.5)
    order.append(not h2.done())
    aeng.advance(0.5)                     # deadline flush
    order.append(h2.done())
    for h, w in zip((h0, h1, h2), want):
        d = same(h.result(), w) if h.done() else "pending"
        check(f"async/{w.tag}", not d and all(order)
              and h.result().stats["comm_phases"] == 1, d or str(order))
    st = aeng.stats
    sums = (st.flush_capacity + st.flush_deadline + st.flush_drain
            + st.flush_retry)
    check("async/flush_reasons",
          st.flush_capacity == 1 and st.flush_deadline == 1
          and sums == st.batches and st.deadline_hits == 2,
          str(st.as_dict()))
    bad = TopologyRequest("cc", mask=block(rng.random((9, 7)) < 0.6,
                                           (9, 7)),
                          grid_shape=(9, 7), table_max_iter=1, tag="bad",
                          **dreq)
    good = TopologyRequest("cc", mask=block(rng.random((9, 7)) < 0.6,
                                            (9, 7)),
                           grid_shape=(9, 7), tag="good", **dreq)
    hb, hg = aeng.submit(bad), aeng.submit(good)
    aeng.drain()
    exc = hb.exception()
    sums = (st.flush_capacity + st.flush_deadline + st.flush_drain
            + st.flush_retry)
    check("async/not_converged_fails_alone",
          hb.done() and isinstance(exc, RuntimeError)
          and "max_iter" in str(exc) and hg.exception() is None
          and not same(hg.result(), submit(good)) and st.failures == 1
          and sums == st.batches,
          f"{exc!r}, good {hg.exception()!r}, {st.as_dict()}")

    # 3. the port's synthetic workload over (2, 2), both table modes ------
    trace = synthetic_trace(TRACE_N, TRACE_SHAPES, connectivity=6, sweep_k=3,
                            seed=5, rate=50.0, deadline_slack=0.08)
    for mode in MODES:
        reqs = trace.requests(backend="distributed", mesh=mesh,
                              table_mode=mode)
        want = submit_many(reqs)
        got = TopologyEngine(max_batch=4, device="cpu").submit_batch(reqs)
        d = [same(g, w) for g, w in zip(got, want)]
        check(f"trace/{mode}/sync", not any(d), str(d))
        aeng = AsyncTopologyEngine(max_batch=4, clock=VirtualClock(),
                                   device="cpu")
        hs = []
        for req, (t, dl) in zip(reqs, trace.arrivals):
            if t > aeng.clock.now():
                aeng.advance(t - aeng.clock.now())
            hs.append(aeng.submit(req, deadline=dl))
        aeng.drain()
        d = [same(h.result(), w) for h, w in zip(hs, want)]
        st = aeng.stats
        check(f"trace/{mode}/async",
              not any(d) and st.completed == TRACE_N
              and st.flush_deadline > 0 and st.batches == (
                  st.flush_capacity + st.flush_deadline + st.flush_drain
                  + st.flush_retry), f"{d}, {st.as_dict()}")

    # 4. the ragged ascending flip: (13, 11, 7) over (2, 2) ---------------
    rng = np.random.default_rng(RAGGED_SEED)
    order = rng.permutation(math.prod(RAGGED)).reshape(RAGGED).astype(
        np.int32)
    rreq = dict(backend="distributed", mesh=mesh, grid_shape=RAGGED,
                connectivity=6)
    reqs = [TopologyRequest("manifold", order=block(order, RAGGED),
                            descending=False, tag="asc", **rreq),
            TopologyRequest("ms", order=block(order, RAGGED), tag="ms",
                            **rreq)]
    eng = TopologyEngine(device="cpu")
    got, want = eng.submit_batch(reqs), submit_many(reqs)
    for name, g, w in zip(("ascending", "ms"), got, want):
        d = same(g, w)
        check(f"ragged/{name}", not d, d)
    # the three manifold items (the flipped one, the ms's two) share one
    # bucket of the exact extent: one execution at capacity 4, one dummy
    check("ragged/one_bucket",
          eng.stats.batches == 1 and eng.stats.items == 3
          and eng.stats.padded_cells == 4 * math.prod(RAGGED),
          str(eng.stats.as_dict()))
    # each result owns its block alone, not a view of the (4, *block) stack
    labs = [got[0].labels, got[1].ascending, got[1].descending]
    check("ragged/results_release_the_dummy_slot",
          all(x.untyped_storage().nbytes() == x.numel() * x.element_size()
              for x in labs), str([x.untyped_storage().nbytes()
                                   for x in labs]))
    out["ragged"] = {"ascending": got[0].labels, "ms_ascending":
                     got[1].ascending, "ms_segmentation": got[1].segmentation}

    # 5. the guard: multi-rank requests need a VirtualClock, uncharged ----
    req = TopologyRequest("cc", mask=block(rng.random((9, 7)) < 0.6, (9, 7)),
                          grid_shape=(9, 7), tag="guard", **dreq)
    for name, kw in (("monotonic_clock_raises", dict(clock=MonotonicClock())),
                     ("charged_clock_raises",
                      dict(clock=VirtualClock(), charge_execution_time=True))):
        try:
            AsyncTopologyEngine(device="cpu", **kw).submit(req)
            check(f"guard/{name}", False, "no ValueError")
        except ValueError as e:
            check(f"guard/{name}", "VirtualClock" in str(e), str(e))
    h = AsyncTopologyEngine(clock=VirtualClock(), device="cpu").submit(req)
    d = same(h.result(), submit(req))
    check("guard/virtual_clock_serves", not d, d)
    if rank == 0:
        # one rank flushes alone: any clock will do
        mesh1 = make_dpc_mesh((1, 1), group=one, device="cpu")
        full = np.random.default_rng(3).random((9, 7)) < 0.6
        req1 = TopologyRequest("cc", backend="distributed", mesh=mesh1,
                               grid_shape=(9, 7), connectivity=4, mask=full,
                               tag="one")
        h = AsyncTopologyEngine(clock=MonotonicClock(),
                                charge_execution_time=True,
                                device="cpu").submit(req1, deadline=1e9)
        d = same(h.result(), submit(req1))
        check("guard/one_rank_monotonic_serves", not d, d)
    else:
        check("guard/one_rank_monotonic_serves", True)

    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    r, w, store_file, out = sys.argv[1:5]
    try:
        main(int(r), int(w), store_file, out)
    except BaseException:
        with open(os.path.join(out, f"rank{r}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise

"""The port's serving engine (`repro_torch.serve`) against the JAX engine
and the port's facade, on the CPU.

Parity: JAX's own mixed workloads (`test_serve_engine._mixed_workload`,
`test_serve_async._mixed_requests`) go through both engines, the JAX engine
once per workload (module fixtures).  Every result's labels, `ascending`,
`descending`, `segmentation`, query and tag are exactly equal to the JAX
engine's and to `repro_torch.topology.submit_many`'s; on the same pure
request stream `stats.as_dict()` and `cache_info()` equal the JAX engine's
(an executable build is counted where JAX counts a compile), the latency
fields included, since both run on a `VirtualClock`.

Units: each JAX unit test of `bucketing`, `scheduler`, `compile_cache` and
`workload` is ported (the scheduler and the cache also replayed op for op
against JAX's), and the port's workload trace equals JAX's payload by
payload.  Behaviours: every async and serve-v3 behaviour of the JAX suite
(`tests/test_serve_async.py`, `tests/test_serve_v3.py`) runs on the port's
engine with a `VirtualClock`, held to the port's `submit_many`.  Plus a
float64 numpy field (compared in float32, as the facade does) and the `ms`
pair hash's int32 wrap on 97x61x43.
"""
import dataclasses
import json
import math

import numpy as np
import pytest
import torch

import jax

from oracles import ragged_graph_case
from test_serve_async import _mixed_requests
from test_serve_engine import _mixed_workload

from repro import serve as jserve
from repro.serve import bucketing as jbucketing
from repro.serve import workload as jworkload
from repro_torch import topology as ptop
from repro_torch.core.ids import compute_order
from repro_torch.interop import canonical_tensor
from repro_torch.serve import (AsyncTopologyEngine, COLD_START_ESTIMATE,
                               DeadlineShed, FlushScheduler, Overloaded,
                               PlaneError, SharedExecutableCache,
                               TopologyEngine, VirtualClock)
from repro_torch.serve import bucketing
from repro_torch.serve.bucketing import (adjacent_layouts, batch_capacity,
                                         bucket_shape, merge_adjacent_layouts,
                                         next_pow2, pad_to, remap_flat_labels)
from repro_torch.serve.workload import (WorkloadTrace, overload_trace,
                                        synthetic_requests, synthetic_trace)

CPU = "cpu"
FIELDS = ("labels", "ascending", "descending", "segmentation")
MIXED_TAGS = [r.tag for r in _mixed_workload()]
ASYNC_SEEDS = (0, 1, 2)


# --- helpers ------------------------------------------------------------------


def _port(reqs):
    """JAX requests as port requests: JAX arrays read back as numpy, one
    array per JAX array, so requests that share an edge list still share
    it (the graph bucket key holds its identity)."""
    memo, out = {}, []
    for r in reqs:
        kw = {}
        for f in dataclasses.fields(r):
            v = getattr(r, f.name)
            if isinstance(v, jax.Array):
                v = memo.setdefault(id(v), np.asarray(v))
            kw[f.name] = v
        out.append(ptop.TopologyRequest(**kw))
    return out


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_results_equal(got, want):
    """Query, tag and every label field exactly equal, dtypes too."""
    assert got.query == want.query and got.tag == want.tag
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            a, b = _np(a), _np(b)
            assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=f)


def _flush_sum(stats):
    return (stats.flush_capacity + stats.flush_deadline + stats.flush_drain
            + stats.flush_retry)


def _cc(rng, shape=(9, 7), conn=4, tag=None):
    return ptop.TopologyRequest("cc", mask=rng.random(shape) < 0.6,
                                connectivity=conn, tag=tag)


def _ms(rng, shape=(9, 7), tag=None):
    field = canonical_tensor(rng.standard_normal(shape), CPU)
    return ptop.TopologyRequest("ms", order=compute_order(field),
                                connectivity=4, tag=tag)


def _facade(reqs):
    return ptop.submit_many(reqs, CPU)


# --- parity with the JAX engine: the sync engine ------------------------------


@pytest.fixture(scope="module")
def mixed():
    """JAX's `_mixed_workload` through the JAX engine and the port's, each
    served twice (the replay hits the cache), and through the port's
    facade."""
    jreqs = _mixed_workload()
    preqs = _port(jreqs)
    out = {"facade": _facade(preqs)}
    for name, eng, reqs in (
            ("jax", jserve.TopologyEngine(min_extent=8, max_batch=16), jreqs),
            ("port", TopologyEngine(min_extent=8, max_batch=16, device=CPU),
             preqs)):
        first = eng.submit_batch(reqs)
        stats1, info1 = eng.stats.as_dict(), eng.cache_info()
        second = eng.submit_batch(reqs)
        out[name] = {"first": first, "second": second, "stats1": stats1,
                     "info1": info1, "stats2": eng.stats.as_dict(),
                     "info2": eng.cache_info(), "engine": eng}
    return out


@pytest.mark.parametrize("idx", range(len(MIXED_TAGS)),
                         ids=[str(t) for t in MIXED_TAGS])
def test_engine_equals_jax_engine_and_facade(mixed, idx):
    got = mixed["port"]["first"][idx]
    _assert_results_equal(got, mixed["jax"]["first"][idx])
    _assert_results_equal(got, mixed["facade"][idx])
    # the replay (every bucket a cache hit) gives the same bits
    _assert_results_equal(mixed["port"]["second"][idx], got)
    for f in FIELDS:
        v = getattr(got, f)
        assert v is None or v.device.type == "cpu"


@pytest.mark.parametrize("when", ["1", "2"])
def test_engine_stats_and_cache_info_equal_jax_engine(mixed, when):
    assert mixed["port"][f"stats{when}"] == mixed["jax"][f"stats{when}"]
    assert mixed["port"][f"info{when}"] == mixed["jax"][f"info{when}"]


def test_replay_hits_executable_cache(mixed):
    s1, s2 = mixed["port"]["stats1"], mixed["port"]["stats2"]
    eng = mixed["port"]["engine"]
    assert s1["cache_misses"] == mixed["port"]["info1"]["size"]
    assert s2["cache_misses"] == s1["cache_misses"]
    assert s2["hit_rate"] >= 0.5
    assert s1["items"] == len(MIXED_TAGS) + 1 + 2   # ms: 2 items, sweep: 3
    assert s1["batches"] < s1["items"], "bucketing must actually batch"
    assert 0.0 <= s1["pad_fraction"] < 1.0
    assert all(v >= 1 for v in eng.cache_info()[
        "runs_per_executable"].values())


# --- parity with the JAX engine: the async plane -------------------------------


def _async_run(engine, clock, reqs_for, submit_many):
    """JAX's random-arrival scenario (`test_async_parity_random_arrival_
    orders`): the draws depend only on the seed and the virtual clock, so
    both engines see the same submissions, deadlines and advances."""
    eng = engine(min_extent=8, max_batch=4, clock=clock())
    runs = []
    for seed in ASYNC_SEEDS:
        rng = np.random.default_rng(9000 + seed)
        reqs = reqs_for(seed)
        handles = {}
        for j in rng.permutation(len(reqs)):
            dl = (None if rng.random() < 0.4
                  else float(eng.clock.now() + rng.uniform(0.1, 3.0)))
            handles[int(j)] = eng.submit(reqs[j], deadline=dl)
            if rng.random() < 0.5:
                eng.advance(float(rng.uniform(0.0, 1.5)))
        eng.drain()
        runs.append((handles, submit_many(reqs), eng.stats.as_dict()))
    return eng, runs


@pytest.fixture(scope="module")
def async_mixed():
    jeng, jruns = _async_run(jserve.AsyncTopologyEngine, jserve.VirtualClock,
                             _mixed_requests, lambda reqs: None)
    peng, pruns = _async_run(
        lambda **kw: AsyncTopologyEngine(device=CPU, **kw), VirtualClock,
        lambda seed: _port(_mixed_requests(seed)), _facade)
    return {"jax": (jeng, jruns), "port": (peng, pruns)}


@pytest.mark.parametrize("seed", ASYNC_SEEDS)
def test_async_engine_equals_jax_async_engine_and_facade(async_mixed, seed):
    jh, _, jstats = async_mixed["jax"][1][seed]
    ph, want, pstats = async_mixed["port"][1][seed]
    assert sorted(ph) == sorted(jh)
    for j, h in ph.items():
        assert h.done() and h.exception() is None
        _assert_results_equal(h.result(), jh[j].result())
        _assert_results_equal(h.result(), want[j])
        assert h.completed_at == jh[j].completed_at
    assert pstats == jstats
    assert pstats["batches"] == (pstats["flush_capacity"]
                                 + pstats["flush_deadline"]
                                 + pstats["flush_drain"]
                                 + pstats["flush_retry"])


def test_async_cache_and_latencies_equal_jax(async_mixed):
    jeng, peng = async_mixed["jax"][0], async_mixed["port"][0]
    assert peng.cache_info() == jeng.cache_info()
    assert peng.latencies == jeng.latencies
    s = peng.stats
    assert s.completed == s.requests and s.failures == 0
    assert s.latency_count == s.completed == len(peng.latencies)
    assert s.queue_depth_peak >= 2
    assert s.deadline_hits + s.deadline_misses <= s.completed


# --- bucketing ----------------------------------------------------------------


def test_bucketing_helpers():
    assert [next_pow2(x) for x in (1, 2, 3, 8, 9)] == [1, 2, 4, 8, 16]
    assert bucket_shape((9, 7, 3), min_extent=8) == (16, 8, 8)
    assert batch_capacity(5, max_batch=64) == 8
    assert batch_capacity(100, max_batch=64) == 64
    # remap: unravel in padded shape, ravel in real shape; -1 preserved
    lab = np.array([[-1, 1], [8, 9]])       # padded shape (4, 8): id 8=(1,0)
    out = remap_flat_labels(np.pad(lab, ((0, 2), (0, 6)),
                                   constant_values=-1), (4, 8), (2, 2))
    assert isinstance(out, torch.Tensor)
    np.testing.assert_array_equal(out.numpy(), [[-1, 1], [2, 3]])


@pytest.mark.parametrize("real,padded,dtype", [
    ((9, 7), (16, 8), torch.int32), ((5, 6, 7), (8, 8, 8), torch.int32),
    ((13, 11, 7), (16, 16, 8), torch.int64), ((6, 5), (6, 5), torch.int32)])
def test_remap_flat_labels_equals_jax(real, padded, dtype):
    """Random padded-shape ids (and -1s) remapped on a tensor == JAX's numpy
    remap; the label dtype is kept."""
    rng = np.random.default_rng(sum(real))
    n_pad, n_real = math.prod(padded), math.prod(real)
    # ids of real cells in the padded shape, as a padded run produces
    coords = np.unravel_index(rng.integers(0, n_real, padded), real)
    lab = np.ravel_multi_index(coords, padded)
    lab = np.where(rng.random(padded) < 0.3, -1, lab)
    assert lab.max() < n_pad
    want = jbucketing.remap_flat_labels(lab.astype(np.int32), padded, real)
    got = remap_flat_labels(torch.from_numpy(lab).to(dtype), padded, real)
    assert got.dtype == dtype and tuple(got.shape) == real
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fill,dtype", [(False, torch.bool),
                                        (-1, torch.int32)])
def test_pad_to_equals_jax(fill, dtype):
    x = torch.arange(63, dtype=torch.int32).reshape(9, 7) % 3 == 0
    x = x.to(dtype)
    got = pad_to(x, (16, 8), fill)
    want = jbucketing.pad_to(x.numpy(), (16, 8), fill)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.numpy(), want)
    assert pad_to(x, (9, 7), fill) is x


@pytest.mark.parametrize("fill,dtype", [(False, torch.bool),
                                        (-1, torch.int32)])
def test_pad_to_into_a_slot_equals_jax(fill, dtype):
    """The engine's form: each payload padded into a slot of a stack that
    holds stale values."""
    x = (torch.arange(63, dtype=torch.int32).reshape(9, 7) % 3 == 0).to(dtype)
    stack = torch.ones((2, 16, 8), dtype=dtype)
    got = pad_to(x, (16, 8), fill, out=stack[1])
    assert got.data_ptr() == stack[1].data_ptr()
    np.testing.assert_array_equal(
        stack[1].numpy(), jbucketing.pad_to(x.numpy(), (16, 8), fill))
    assert bool((stack[0] == 1).all())
    full = (torch.arange(128, dtype=torch.int32).reshape(16, 8) % 5 == 0
            ).to(dtype)
    pad_to(full, (16, 8), fill, out=stack[0])
    assert torch.equal(stack[0], full)


def test_pad_waste_and_layouts_equal_jax():
    shapes = [(9, 7), (5, 5), (17, 3, 2)]
    for s in shapes:
        assert bucket_shape(s, 8) == jbucketing.bucket_shape(s, 8)
    assert bucketing.pad_waste([(9, 7), (5, 5)], (16, 8), 4) == \
        jbucketing.pad_waste([(9, 7), (5, 5)], (16, 8), 4)
    for n in range(1, 130):
        assert batch_capacity(n, 64) == jbucketing.batch_capacity(n, 64)


def test_adjacent_layouts_relation():
    assert adjacent_layouts((8, 8), (16, 8))
    assert adjacent_layouts((8, 8), (8, 16))
    assert not adjacent_layouts((8, 8), (16, 16)), "4x cells is not one step"
    assert not adjacent_layouts((16, 8), (8, 16)), "no domination"
    assert not adjacent_layouts((8, 8), (8, 8)), "identity is not a merge"
    assert not adjacent_layouts((8,), (8, 8)), "rank must match"


def test_merge_plan_cost_threshold():
    counts = {(8, 8): 3, (16, 8): 2}
    plan = merge_adjacent_layouts(counts, slot_cost_cells=1000)
    assert plan == {(8, 8): (16, 8), (16, 8): (16, 8)}
    plan = merge_adjacent_layouts(counts, slot_cost_cells=100)
    assert plan == {(8, 8): (8, 8), (16, 8): (16, 8)}
    assert merge_adjacent_layouts(counts, 0) == \
        {(8, 8): (8, 8), (16, 8): (16, 8)}


@pytest.mark.parametrize("counts", [
    {(8,): 1, (16,): 1, (32,): 1},
    {(8,): 5, (16,): 5, (32,): 5, (64,): 5},
    {(8, 8): 3, (16, 8): 1, (8, 16): 2, (16, 16): 4, (32, 16): 1}])
def test_merge_plan_chains_respect_pad_bound_and_equal_jax(counts):
    plan = merge_adjacent_layouts(counts, slot_cost_cells=10**6)
    assert all(math.prod(tgt) <= 2 * math.prod(orig)
               for orig, tgt in plan.items())
    assert plan == jbucketing.merge_adjacent_layouts(counts, 10**6)
    if len(counts) == 3 and (8,) in counts:
        assert plan == {(8,): (16,), (16,): (16,), (32,): (32,)}


# --- scheduler ----------------------------------------------------------------


def test_virtual_clock():
    clk = VirtualClock()
    assert clk.now() == 0.0
    clk.advance(1.5)
    assert clk.now() == 1.5
    with pytest.raises(ValueError):
        clk.advance(-1.0)


def test_scheduler_capacity_and_drain():
    sch = FlushScheduler(capacity=2, clock=VirtualClock())
    assert sch.enqueue("a", "x1") == 1
    assert sch.full() == [] and sch.depth() == 1
    sch.enqueue("a", "x2")
    sch.enqueue("b", "y1")
    assert sch.full() == ["a"] and sch.depth() == 3
    assert [e.item for e in sch.pop("a")] == ["x1", "x2"]     # FIFO
    rest = sch.pop_all()
    assert [e.item for e in rest["b"]] == ["y1"]
    assert sch.depth() == 0 and sch.pop("b") == []


def test_scheduler_deadline_uses_measured_estimate():
    clk = VirtualClock()
    sch = FlushScheduler(capacity=64, clock=clk, default_estimate=0.0,
                         ewma=0.5)
    sch.enqueue("k", "item", deadline=5.0)
    sch.enqueue("k", "later", deadline=9.0)
    assert sch.earliest_deadline("k") == 5.0
    assert sch.flush_at("k") == 5.0 and sch.due() == []
    sch.observe("k", 2.0)
    assert sch.estimate("k") == 2.0 and sch.flush_at("k") == 3.0
    sch.observe("k", 4.0)               # EWMA: 0.5*4 + 0.5*2
    assert sch.estimate("k") == 3.0
    assert sch.next_due_time() == 2.0
    clk.advance(1.9)
    assert sch.due() == []
    clk.advance(0.1)
    assert sch.due() == ["k"]
    sch2 = FlushScheduler(capacity=64, clock=clk)
    sch2.enqueue("k", "no-deadline")
    assert sch2.due() == [] and sch2.next_due_time() is None


def test_cold_start_flush_is_earlier_than_deadline():
    clk = VirtualClock()
    sch = FlushScheduler(capacity=64, clock=clk)
    sch.enqueue("k", "first", deadline=1.0)
    assert sch.estimate("k") == COLD_START_ESTIMATE > 0.0
    assert COLD_START_ESTIMATE == jserve.COLD_START_ESTIMATE
    assert sch.flush_at("k") == 1.0 - COLD_START_ESTIMATE < 1.0
    legacy = FlushScheduler(capacity=64, clock=clk, default_estimate=0.0)
    legacy.enqueue("k", "first", deadline=1.0)
    assert legacy.flush_at("k") == 1.0


def test_global_ewma_seeds_cold_buckets():
    sch = FlushScheduler(capacity=64, clock=VirtualClock())
    sch.observe("a", 0.2)
    sch.observe("b", 0.4)
    assert sch.estimate("never-seen") == pytest.approx(0.3)
    assert sch.estimate("a") == pytest.approx(0.2)
    assert sch.estimate("b") == pytest.approx(0.4)


def test_due_is_slack_ordered():
    clk = VirtualClock()
    sch = FlushScheduler(capacity=64, clock=clk)
    sch.enqueue("x", 1, deadline=5.0)
    sch.enqueue("y", 1, deadline=3.0)
    sch.enqueue("z", 1, deadline=4.0)
    clk.advance(10.0)
    assert sch.due() == ["y", "z", "x"]
    assert sch.slack("y") < sch.slack("z") < sch.slack("x") < 0


def test_shed_policies():
    def fresh():
        clk = VirtualClock()
        sch = FlushScheduler(capacity=64, clock=clk)
        sch.enqueue("k", "missed", deadline=1.0)
        sch.enqueue("k", "doomed", deadline=3.5)
        sch.enqueue("k", "fine", deadline=10.0)
        sch.enqueue("k", "nodeadline")
        sch.observe("k", 2.0)
        clk.advance(2.0)
        return sch

    sch = fresh()
    assert sch.shed("never") == [] and sch.depth() == 4
    sch = fresh()
    assert [e.item for _, e in sch.shed("late")] == ["missed"]
    assert sch.depth() == 3
    sch = fresh()
    assert [e.item for _, e in sch.shed("hopeless")] == ["missed", "doomed"]
    assert sch.depth() == 2
    with pytest.raises(ValueError):
        sch.shed("aggressive")


def test_scheduler_purge():
    sch = FlushScheduler(capacity=64, clock=VirtualClock())
    sch.enqueue("a", ("r0", 0))
    sch.enqueue("a", ("r1", 0))
    sch.enqueue("b", ("r0", 1))
    out = sch.purge(lambda item: item[0] == "r0")
    assert sorted(e.item for e in out) == [("r0", 0), ("r0", 1)]
    assert sch.depth() == 1 and "b" not in sch.depths()


@pytest.mark.parametrize("seed", range(6))
def test_scheduler_random_ops_equal_jax(seed):
    """Seeded random enqueue/advance/observe/pop/shed sequences on the
    port's scheduler and JAX's: every decision equal, due() never returns
    an empty or non-overdue bucket, slack order monotone, and shed() drops
    exactly the unmeetable entries."""
    rng = np.random.default_rng(7000 + seed)
    scheds = []
    for mod in (jserve, None):
        clk = (mod.VirtualClock() if mod else VirtualClock())
        cls = mod.FlushScheduler if mod else FlushScheduler
        scheds.append((cls(capacity=4, clock=clk), clk))
    keys = ["a", "b", "c", "d"]
    for step in range(300):
        op, r1, r2 = rng.random(), rng.random(), rng.random()
        k = keys[int(rng.integers(4))]
        outs = []
        for sch, clk in scheds:
            if op < 0.5:
                dl = None if r1 < 0.3 else float(clk.now() + 0.01 + 2 * r2)
                sch.enqueue(k, ("item", step), dl)
            elif op < 0.8:
                clk.advance(r1)
            else:
                sch.observe(k, 0.5 * r1)
            due = sch.due()
            slacks = [sch.slack(q) for q in due]
            for q in due:
                assert sch.depths().get(q)
                assert clk.now() >= sch.flush_at(q)
            assert slacks == sorted(slacks)
            if r2 < 0.3:
                for q in due:
                    sch.pop(q)
            outs.append((due, slacks, sch.depths(), sch.full(),
                         sch.next_due_time()))
        assert outs[0] == outs[1], step
    (jsch, _), (sch, clk) = scheds
    now = clk.now()
    dropped = sch.shed("hopeless")
    assert [(k, e.item, e.deadline) for k, e in dropped] == \
        [(k, e.item, e.deadline) for k, e in jsch.shed("hopeless")]
    for k, e in dropped:
        assert e.deadline is not None and now + sch.estimate(k) > e.deadline
    for k in sch.depths():
        for e in sch._queues[k]:
            assert e.deadline is None or now + sch.estimate(k) <= e.deadline


# --- shared executable cache --------------------------------------------------


@pytest.mark.parametrize("capacity", [1, 3, None])
def test_shared_cache_equals_jax_cache(capacity):
    """The same attach/lookup sequence on the port's cache and JAX's: the
    same hits, evictions, info() and attribution, LRU order included."""
    rng = np.random.default_rng(0 if capacity is None else capacity)
    caches = [SharedExecutableCache(capacity=capacity),
              jserve.SharedExecutableCache(capacity=capacity)]
    owners = [[c.attach(), c.attach("r1"), c.attach()] for c in caches]
    assert owners[0] == owners[1] == ["engine-0", "r1", "engine-1"]
    for _ in range(200):
        key, who = int(rng.integers(6)), int(rng.integers(3))
        got = [c.lookup(key, lambda key=key: ("exe", key), o[who])
               for c, o in zip(caches, owners)]
        assert got[0] == got[1]
        assert (key in caches[0]) and len(caches[0]) == len(caches[1])
    assert caches[0].info() == caches[1].info()
    assert list(caches[0]._store) == list(caches[1]._store)
    with pytest.raises(ValueError):
        SharedExecutableCache(capacity=0)


def test_shared_cache_builds_each_executable_once():
    rng = np.random.default_rng(5)
    reqs = [_cc(rng, tag=i) for i in range(3)]
    want = _facade(reqs)
    cache = SharedExecutableCache(capacity=None)
    e1 = AsyncTopologyEngine(min_extent=8, max_batch=4, clock=VirtualClock(),
                             compile_cache=cache, name="r0", device=CPU)
    hs1 = [e1.submit(r) for r in reqs]
    e1.drain()
    builds = cache.compiles
    assert builds >= 1 and e1.stats.cache_misses == builds
    e2 = AsyncTopologyEngine(min_extent=8, max_batch=4, clock=VirtualClock(),
                             compile_cache=cache, name="r1", device=CPU)
    hs2 = [e2.submit(r) for r in reqs]
    e2.drain()
    assert cache.compiles == builds, "replica rebuilt a shared layout"
    assert e2.stats.cache_misses == 0 and e2.stats.cache_hits >= 1
    e3 = TopologyEngine(min_extent=8, max_batch=4, compile_cache=cache,
                        name="sync", device=CPU)
    got3 = e3.submit_batch(reqs)
    assert cache.compiles == builds and e3.stats.cache_misses == 0
    att = cache.attribution()
    assert att["r0"]["misses"] == builds
    assert att["r1"]["misses"] == 0 and att["r1"]["hits"] >= 1
    assert att["sync"]["misses"] == 0 and att["sync"]["hits"] >= 1
    assert len(cache) == builds
    assert len(e1._exec) == len(e2._exec) == len(cache)
    for h1, h2, g3, w in zip(hs1, hs2, got3, want):
        _assert_results_equal(h1.result(), w)
        _assert_results_equal(h2.result(), w)
        _assert_results_equal(g3, w)


def test_private_caches_stay_independent():
    req = _cc(np.random.default_rng(6), tag=0)
    a = TopologyEngine(min_extent=8, max_batch=4, device=CPU)
    b = TopologyEngine(min_extent=8, max_batch=4, device=CPU)
    a.submit_batch([req])
    b.submit_batch([req])
    assert a.stats.cache_misses == 1 and b.stats.cache_misses == 1
    assert a.cache is not b.cache


# --- workload -----------------------------------------------------------------


def test_workload_seed_is_required():
    with pytest.raises(TypeError):
        synthetic_requests(3, ((5, 5),))                  # no seed
    with pytest.raises(TypeError):
        synthetic_requests(3, ((5, 5),), 0)               # not positional


@pytest.mark.parametrize("make", ["synthetic", "overload"])
def test_workload_trace_equals_jax_payload_by_payload(make):
    """The port's trace and JAX's from the same parameters: the same
    arrivals and, request by request, the same query, tag, direction and
    payloads (numpy float64 draws compared and ordered as JAX does)."""
    shapes, mix = ((7, 5, 3), (6, 6), (9, 4)), jworkload._DEFAULT_MIX
    kw = dict(connectivity=4, sweep_k=3, seed=3)
    if make == "synthetic":
        args = dict(rate=2.0, deadline_slack=1.0)
        pt = synthetic_trace(12, shapes, mix, **kw, **args)
        jt = jworkload.synthetic_trace(12, shapes, mix, **kw, **args)
    else:
        args = dict(sustainable_rps=40.0, factor=4.0)
        pt = overload_trace(12, shapes, mix, **kw, **args)
        jt = jworkload.overload_trace(12, shapes, mix, **kw, **args)
    assert pt.as_dict() == jt.as_dict()
    got, want = pt.requests(device=CPU), jt.requests()
    assert {r.query for r in got} == {"cc", "ms", "manifold",
                                      "threshold_sweep"}
    for a, b in zip(got, want):
        assert (a.query, a.tag, a.descending, a.connectivity) == \
            (b.query, b.tag, b.descending, b.connectivity)
        for f in ("mask", "order", "field", "thresholds"):
            va, vb = getattr(a, f), getattr(b, f)
            assert (va is None) == (vb is None), f
            if va is not None:
                assert va.device.type == "cpu"
                assert str(va.dtype).removeprefix("torch.") == \
                    str(np.asarray(vb).dtype), f
                np.testing.assert_array_equal(va.numpy(), np.asarray(vb))


def test_workload_trace_replays_bit_identically():
    trace = synthetic_trace(5, ((7, 5), (6, 6)), connectivity=4, sweep_k=2,
                            seed=3, rate=2.0, deadline_slack=1.0)
    r1, r2 = trace.requests(device=CPU), trace.requests(device=CPU)
    for a, b in zip(r1, r2):
        assert a.query == b.query and a.tag == b.tag
        for f in ("mask", "order", "field", "thresholds"):
            va, vb = getattr(a, f), getattr(b, f)
            assert (va is None) == (vb is None)
            if va is not None:
                assert torch.equal(va, vb)
    ts = [t for t, _ in trace.arrivals]
    assert len(ts) == 5 and ts == sorted(ts)
    assert all(d > t for t, d in trace.arrivals)
    rt = WorkloadTrace.from_dict(json.loads(json.dumps(trace.as_dict())))
    assert rt == trace
    closed = synthetic_trace(5, ((7, 5), (6, 6)), connectivity=4, sweep_k=2,
                             seed=3)
    assert closed.arrivals == ()
    for a, b in zip(closed.requests(device=CPU), r1):
        assert a.query == b.query
    with pytest.raises(ValueError):
        overload_trace(3, ((5, 5),), seed=0, sustainable_rps=0.0)


def test_workload_and_engine_default_to_cuda():
    """Entry points run on the card unless the caller names the CPU: without
    CUDA they raise; `device="cpu"` runs."""
    if torch.cuda.is_available():
        assert TopologyEngine().device.type == "cuda"
        assert AsyncTopologyEngine().device.type == "cuda"
        return
    for make in (TopologyEngine, AsyncTopologyEngine,
                 lambda: synthetic_requests(1, ((5, 5),), seed=0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert TopologyEngine(device=CPU).device.type == "cpu"
    assert AsyncTopologyEngine(device=CPU).device.type == "cpu"


# --- sync engine behaviours ---------------------------------------------------


def test_same_layout_requests_share_one_batch():
    rng = np.random.default_rng(0)
    reqs = [_cc(rng, tag=i) for i in range(3)]
    eng = TopologyEngine(device=CPU)
    got = eng.submit_batch(reqs)
    assert eng.stats.batches == 1 and eng.stats.cache_misses == 1
    for g, w in zip(got, _facade(reqs)):
        _assert_results_equal(g, w)


def test_equal_shape_graphs_share_executable():
    n1, s1, r1, _, _, m1 = ragged_graph_case(1)
    perm = np.random.default_rng(42).permutation(n1)
    s2, r2 = perm[np.asarray(s1)], perm[np.asarray(r1)]
    m2 = np.asarray(m1)[np.argsort(perm)]
    reqs = [ptop.TopologyRequest("cc", domain="graph", mask=m1, senders=s1,
                                 receivers=r1, tag="g1"),
            ptop.TopologyRequest("cc", domain="graph", mask=m2, senders=s2,
                                 receivers=r2, tag="g2")]
    eng = TopologyEngine(device=CPU)
    got = eng.submit_batch(reqs)
    assert eng.stats.batches == 2, "distinct graphs must not stack payloads"
    assert eng.stats.cache_misses == 1, "equal-shape graphs share one build"
    for g, w in zip(got, _facade(reqs)):
        _assert_results_equal(g, w)


def test_float64_field_compares_in_float32_as_the_facade():
    """A numpy float64 field and float64 thresholds: the engine compares
    in float32, as `topology.submit` does (JAX's engine would compare the
    raw float64 arrays).  Thresholds at float32-rounded field values make
    the two precisions disagree."""
    rng = np.random.default_rng(11)
    field = rng.standard_normal((9, 7, 5))
    f32 = field.astype(np.float32).astype(np.float64)
    thr = np.sort(f32.reshape(-1))[[60, 150, 240]]
    assert ((field > thr[:, None, None, None])
            != (f32 > thr[:, None, None, None])).any(), \
        "the case must tell the two precisions apart"
    req = ptop.TopologyRequest("threshold_sweep", field=field,
                               thresholds=thr, connectivity=6, tag="f64")
    got = TopologyEngine(device=CPU).submit(req)
    _assert_results_equal(got, _facade([req])[0])


def test_ms_pair_hash_wraps_as_int32_like_submit():
    """97x61x43 (n = 254,431, so desc * n + asc passes 2**31): the `ms`
    segmentation equals `submit`'s, the int32 wrap of the int64 pair."""
    rng = np.random.default_rng(97)
    shape = (97, 61, 43)
    order = compute_order(canonical_tensor(rng.standard_normal(shape), CPU))
    req = ptop.TopologyRequest("ms", order=order, connectivity=6, tag="ms")
    got = TopologyEngine(device=CPU).submit(req)
    _assert_results_equal(got, _facade([req])[0])
    n = math.prod(shape)
    wide = got.descending.long() * n + got.ascending.long()
    assert int(wide.max()) >= 2**31, "the hash must wrap on this grid"
    assert torch.equal(got.segmentation,
                       ((wide + 2**31) % 2**32 - 2**31).to(torch.int32))


def test_lru_bound_holds_and_evicted_layout_rebuilds_bit_identically():
    rng = np.random.default_rng(8)
    eng = TopologyEngine(min_extent=8, max_batch=4, cache_capacity=2,
                         device=CPU)
    reqs = [_cc(rng, shape=s, tag=i)
            for i, s in enumerate([(5, 5), (9, 9), (17, 17)])]
    want = _facade(reqs)
    for r, w in zip(reqs, want):
        _assert_results_equal(eng.submit(r), w)
        assert len(eng._exec) <= 2
    assert eng.stats.cache_evictions == 1
    misses = eng.stats.cache_misses
    _assert_results_equal(eng.submit(reqs[0]), want[0])
    assert eng.stats.cache_misses == misses + 1
    assert eng.stats.cache_evictions == 2 and len(eng._exec) <= 2
    info = eng.cache_info()
    assert info["evictions"] == 2 and info["capacity"] == 2
    assert info["size"] == len(eng._exec) <= 2


def test_lru_recency_keeps_the_hot_layout():
    rng = np.random.default_rng(9)
    eng = TopologyEngine(min_extent=8, max_batch=4, cache_capacity=2,
                         device=CPU)
    a, b, c = [_cc(rng, shape=s) for s in [(5, 5), (9, 9), (17, 17)]]
    for r in (a, b, a, c):
        eng.submit(r)
    misses = eng.stats.cache_misses
    eng.submit(a)
    assert eng.stats.cache_misses == misses


def test_engine_merges_adjacent_buckets_bit_identically():
    rng = np.random.default_rng(10)
    reqs = [_cc(rng, shape=s, tag=i)
            for i, s in enumerate([(5, 5), (9, 5), (5, 5)])]
    want = _facade(reqs)
    merged = TopologyEngine(min_extent=8, max_batch=8, slot_cost_cells=10**6,
                            device=CPU)
    got = merged.submit_batch(reqs)
    assert merged.stats.batches == 1 and merged.stats.cache_misses == 1
    for g, w in zip(got, want):
        _assert_results_equal(g, w)
    plain = TopologyEngine(min_extent=8, max_batch=8, device=CPU)
    plain.submit_batch(reqs)
    assert plain.stats.batches == 2 and plain.stats.cache_misses == 2
    assert merged.stats.padded_cells >= plain.stats.padded_cells


def test_chunks_past_max_batch_and_dummy_slots():
    """Six same-layout requests at max_batch 4: two executions at
    capacities 4 and 2, every slot padded to the layout."""
    rng = np.random.default_rng(12)
    reqs = [_cc(rng, tag=i) for i in range(6)]
    eng = TopologyEngine(min_extent=8, max_batch=4, device=CPU)
    got = eng.submit_batch(reqs)
    assert eng.stats.batches == 2 and eng.stats.cache_misses == 2
    assert eng.stats.padded_cells == (4 + 2) * 16 * 8
    assert eng.stats.real_cells == 6 * 63
    for g, w in zip(got, _facade(reqs)):
        _assert_results_equal(g, w)


# --- async plane --------------------------------------------------------------


def _async(**kw):
    kw.setdefault("min_extent", 8)
    return AsyncTopologyEngine(clock=VirtualClock(), device=CPU, **kw)


def test_capacity_flush_fills_the_pow2_batch():
    rng = np.random.default_rng(1)
    eng = _async(max_batch=4)
    hs = [eng.submit(_cc(rng, tag=i)) for i in range(4)]
    assert all(h.done() for h in hs)
    assert eng.stats.flush_capacity == 1 and eng.stats.batches == 1
    assert eng.stats.padded_cells == 4 * 16 * 8
    for h, w in zip(hs, _facade([h.request for h in hs])):
        _assert_results_equal(h.result(), w)


def test_deadline_flush_just_before_deadline():
    rng = np.random.default_rng(2)
    eng = _async(max_batch=8)
    h = eng.submit(_cc(rng, tag="solo"), deadline=5.0)
    assert not h.done() and eng.pending() == 1
    eng.advance(4.9)
    assert not h.done() and eng.stats.flush_deadline == 0
    eng.advance(0.1)
    assert h.done() and eng.stats.flush_deadline == 1
    assert eng.stats.deadline_hits == 1 and eng.stats.deadline_misses == 0
    assert h.completed_at == 5.0 and eng.latencies == [5.0]
    assert _flush_sum(eng.stats) == eng.stats.batches


def test_result_forces_cooperative_drain():
    rng = np.random.default_rng(3)
    eng = _async(max_batch=8)
    h = eng.submit(_cc(rng, tag="lazy"))
    assert not h.done()
    res = h.result()
    assert h.done() and eng.stats.flush_drain >= 1
    _assert_results_equal(res, _facade([h.request])[0])


def _poisoned_engine(poison_tags, **kw):
    """Engine whose executor raises whenever a chosen request's item is in
    the executed group (through the `_execute` seam)."""
    eng = _async(**kw)
    tags = set(poison_tags)
    orig = AsyncTopologyEngine._execute

    def boom(fn, group, args):
        if any(eng._pending.get(g.req_idx) is not None
               and eng._pending[g.req_idx].request.tag in tags
               for g in group):
            raise RuntimeError("poisoned execution")
        return orig(eng, fn, group, args)

    eng._execute = boom
    return eng


def test_split_retry_isolates_the_poisoned_request():
    rng = np.random.default_rng(4)
    reqs = [_cc(rng, tag=i) for i in range(4)]
    want = _facade(reqs)
    eng = _poisoned_engine({2}, max_batch=8)
    hs = [eng.submit(r) for r in reqs]
    eng.drain()
    assert "poisoned" in str(hs[2].exception())
    with pytest.raises(RuntimeError):
        hs[2].result()
    for i in (0, 1, 3):
        assert hs[i].exception() is None
        _assert_results_equal(hs[i].result(), want[i])
    s = eng.stats
    assert s.retries >= 1 and s.failures == 1 and s.completed == 3
    assert s.flush_retry >= 2 and _flush_sum(s) == s.batches
    assert eng.pending() == 0 and not eng._outputs
    h = eng.submit(_cc(rng, tag="after"))
    eng.drain()
    _assert_results_equal(h.result(), _facade([h.request])[0])
    assert _flush_sum(eng.stats) == eng.stats.batches


def test_failure_of_one_item_fails_the_whole_request():
    rng = np.random.default_rng(5)
    ms = _ms(rng, shape=(5, 6), tag="ms-poison")
    ok = _cc(rng, shape=(5, 6), tag="ok")
    eng = _poisoned_engine({"ms-poison"}, max_batch=8)
    h_ms, h_ok = eng.submit(ms), eng.submit(ok)
    eng.drain()
    assert h_ms.exception() is not None and h_ok.exception() is None
    _assert_results_equal(h_ok.result(), _facade([ok])[0])
    assert eng.stats.failures == 1 and not eng._outputs


def test_idempotency_replay_returns_cached_result_without_execution():
    req = _cc(np.random.default_rng(6), tag="idem")
    eng = _async(max_batch=8)
    h1 = eng.submit(req, idempotency_key="tenant/1")
    assert eng.submit(req, idempotency_key="tenant/1") is h1
    assert eng.stats.dedup_hits == 1 and eng.stats.requests == 1
    res = h1.result()
    batches = eng.stats.batches
    h2 = eng.submit(req, idempotency_key="tenant/1")
    assert h2.done() and h2.result() is res
    assert eng.stats.batches == batches and eng.stats.dedup_hits == 2
    h3 = eng.submit(req, idempotency_key="tenant/2")
    eng.drain()
    assert eng.stats.batches == batches + 1
    _assert_results_equal(h3.result(), res)


def test_failed_idempotent_request_is_not_cached():
    req = _cc(np.random.default_rng(7), tag="flaky")
    eng = _poisoned_engine({"flaky"}, max_batch=8)
    h = eng.submit(req, idempotency_key="k")
    eng.drain()
    assert h.exception() is not None
    eng._execute = lambda fn, group, args: fn(*args)   # heal the executor
    h2 = eng.submit(req, idempotency_key="k")
    assert h2 is not h
    eng.drain()
    _assert_results_equal(h2.result(), _facade([req])[0])


def test_default_capacity_keeps_replay_building_nothing():
    reqs = _port(_mixed_requests(0))
    eng = _async(max_batch=16)
    for _ in range(2):
        for r in reqs:
            eng.submit(r)
        eng.drain()
        if _ == 0:
            misses = eng.stats.cache_misses
    assert eng.stats.cache_misses == misses
    assert eng.stats.cache_evictions == 0


def test_async_drain_applies_merge_policy():
    rng = np.random.default_rng(11)
    reqs = [_cc(rng, shape=s, tag=i) for i, s in enumerate([(5, 5), (9, 5)])]
    eng = _async(max_batch=8, slot_cost_cells=10**6)
    hs = [eng.submit(r) for r in reqs]
    eng.drain()
    assert eng.stats.batches == 1
    for h, w in zip(hs, _facade(reqs)):
        _assert_results_equal(h.result(), w)


def test_admission_rejects_with_typed_overloaded():
    rng = np.random.default_rng(0)
    eng = _async(max_batch=64, max_queue_depth=2)
    h0 = eng.submit(_cc(rng, tag=0), deadline=100.0)
    h1 = eng.submit(_cc(rng, tag=1), deadline=100.0)
    h2 = eng.submit(_cc(rng, tag=2), deadline=100.0)
    assert h2.done() and isinstance(h2.exception(), Overloaded)
    with pytest.raises(Overloaded):
        h2.result()
    s = eng.stats
    assert s.rejected == 1 and s.queue_depth_limit == 1 and s.requests == 2
    eng.drain()
    want = _facade([h0.request, h1.request])
    _assert_results_equal(h0.result(), want[0])
    _assert_results_equal(h1.result(), want[1])
    assert s.completed + s.failures + s.shed == s.requests
    h3 = eng.submit(_cc(rng, tag=3))
    eng.drain()
    assert h3.exception() is None and s.rejected == 1


def test_admission_rejects_on_inflight_cells():
    rng = np.random.default_rng(1)
    eng = _async(max_batch=64, max_inflight_cells=100)   # (9,7) = 63 cells
    eng.submit(_cc(rng, tag=0))
    h1 = eng.submit(_cc(rng, tag=1))
    assert isinstance(h1.exception(), Overloaded)
    assert "max_inflight_cells" in str(h1.exception())
    assert eng.stats.rejected == 1 and eng.stats.queue_depth_limit == 0
    eng.drain()
    assert eng._inflight_cells == 0
    h2 = eng.submit(_cc(rng, tag=2))
    eng.drain()
    assert h2.exception() is None


def test_shed_late_fails_handle_with_deadline_shed():
    rng = np.random.default_rng(2)
    eng = _async(max_batch=64, shed_policy="late")
    h = eng.submit(_ms(rng, tag="ms"), deadline=1.0)
    h2 = eng.submit(_cc(rng, tag="cc"), deadline=50.0)
    eng.advance(2.0)
    assert isinstance(h.exception(), DeadlineShed)
    with pytest.raises(DeadlineShed):
        h.result()
    s = eng.stats
    assert s.shed == 1 and s.batches == 0
    assert not h2.done()
    eng.drain()
    _assert_results_equal(h2.result(), _facade([h2.request])[0])
    assert s.completed + s.failures + s.shed == s.requests == 2
    assert eng._inflight_cells == 0


def test_shed_hopeless_uses_estimate_never_keeps():
    rng = np.random.default_rng(3)
    eng = _async(max_batch=64, shed_policy="hopeless", default_estimate=2.0)
    h = eng.submit(_cc(rng, tag=0), deadline=1.0)
    assert isinstance(h.exception(), DeadlineShed)
    assert "shed_policy='hopeless'" in str(h.exception())
    keep = _async(max_batch=64, shed_policy="never", default_estimate=2.0)
    hk = keep.submit(_cc(rng, tag=1), deadline=1.0)
    assert hk.done() and hk.exception() is None
    _assert_results_equal(hk.result(), _facade([hk.request])[0])
    assert keep.stats.shed == 0 and keep.stats.deadline_misses == 0


def test_deadline_flush_order_follows_slack():
    rng = np.random.default_rng(4)
    eng = _async(max_batch=64)
    eng.submit(_cc(rng, shape=(9, 7), tag="loose"), deadline=5.0)
    eng.submit(_cc(rng, shape=(6, 5), tag="tight"), deadline=3.0)
    eng.clock.advance(10.0)
    order = eng.scheduler.due()
    assert [eng.scheduler.earliest_deadline(k) for k in order] == [3.0, 5.0]
    assert eng.poll() == 2


def test_overload_4x_oversubscribed():
    """JAX's overload acceptance run on the port's engine: admitted requests
    complete bit-identically, the rest are shed or rejected with typed
    errors, flushes follow slack, and two engines on one shared cache build
    each executable once."""
    trace = overload_trace(24, ((9, 7), (6, 5)),
                           mix=(("cc", 0.7), ("ms", 0.3)), connectivity=4,
                           seed=7, sustainable_rps=40.0, factor=4.0)
    cache = SharedExecutableCache(capacity=None)

    def run(name, policy="hopeless"):
        eng = _async(max_batch=4, max_queue_depth=6, shed_policy=policy,
                     compile_cache=cache, name=name)
        due_orders, orig_due = [], eng.scheduler.due

        def spying_due():
            keys = orig_due()
            due_orders.append([eng.scheduler.slack(k) for k in keys])
            return keys

        eng.scheduler.due = spying_due
        handles = []
        for req, (t, dl) in zip(trace.requests(device=CPU), trace.arrivals):
            if t > eng.clock.now():
                eng.advance(t - eng.clock.now())
            handles.append(eng.submit(req, deadline=dl))
            assert _flush_sum(eng.stats) == eng.stats.batches
        eng.drain()
        return eng, handles, due_orders

    eng1, hs1, due1 = run("r0")
    builds, s = cache.compiles, eng1.stats
    for h in hs1:
        assert h.done()
        assert h.exception() is None or isinstance(h.exception(), PlaneError)
    assert s.rejected > 0 and s.shed > 0 and s.completed > 0
    assert s.failures == 0 and s.completed + s.shed == s.requests
    assert s.rejected == sum(isinstance(h.exception(), Overloaded)
                             for h in hs1)
    assert s.shed == sum(isinstance(h.exception(), DeadlineShed)
                         for h in hs1)
    done = [h for h in hs1 if h.exception() is None]
    for h, w in zip(done, _facade([h.request for h in done])):
        _assert_results_equal(h.result(), w)
    assert all(o == [] for o in due1) and s.flush_deadline == 0
    eng2, hs2, _ = run("r1")
    assert cache.compiles == builds and eng2.stats.cache_misses == 0
    assert (eng2.stats.rejected, eng2.stats.shed, eng2.stats.completed) == \
        (s.rejected, s.shed, s.completed)
    assert [type(a.exception()) for a in hs1] == \
        [type(b.exception()) for b in hs2]
    eng3, hs3, due3 = run("r2", policy="never")
    assert any(len(o) > 0 for o in due3)
    assert all(o == sorted(o) for o in due3)
    s3 = eng3.stats
    assert s3.shed == 0 and s3.failures == 0 and s3.rejected > 0
    assert s3.completed == s3.requests
    done3 = [h for h in hs3 if h.exception() is None]
    for h, w in zip(done3, _facade([h.request for h in done3])):
        _assert_results_equal(h.result(), w)

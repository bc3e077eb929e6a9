"""The port's distributed graph backend (`repro_torch/core/distributed_graph.py`)
and the facade's distributed graph routes against the JAX package, on the
CPU.

Geometry: the port's `GraphDecomp` and `_GraphShardGeom` equal JAX's array
for array (value and dtype) on every case of
`tests/torch_dist_graph_ranks.py::graph_cases`: the ragged corpus
(`oracles.ragged_graph_case`, imbalanced partitions, empty ones included)
and the JAX package's own test graphs (the 4^3 tet edge list at 1, 2, 4 and
8 parts, the path graph's cuts, the strided `part=`, the random multigraph
with duplicate and self edges).  No mesh is needed for these.

Ranks: one gloo group of 8 CPU processes (`tests/torch_dist_graph_ranks.py`),
started once for the module, runs every case on the subgroup of its
partition count, in both table modes with the mask gathered and not; each
rank returns its own labels, put together here by `assemble_graph_labels`.
They must equal JAX's pure `connected_components_graph` (run in this
process while the ranks work) and the numpy oracle, bit for bit; every rank
must report the same stats, and the stats their closed forms.  A batch of
three masks equals its items' single calls, and issues as many permutes,
all-gathers and all-reduces as its slowest item's single call.  The facade
routes (`cc`, `threshold_sweep`) equal the direct calls and JAX's pure
routes.  `DPCMesh.permute` is checked on partial permutations in which some
rank only sends, some only receives and some does neither.

Under jax 0.9.0 JAX's public distributed graph function raises in its last
step (ROADMAP Queue 3 item 6), and each of its programs compiles for about
30 s, so `tests/jax_distributed_golden.py` ran its per-partition program on
four cases (the "graph" groups) and recorded labels and stats in
`tests/data/jax_distributed_golden.npz`; every field of the port's stats
must equal that record, and one case runs live here (`random40_p8`,
sharded, mask gathered) and must equal both the record and the port.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from oracles import oracle_components_graph
from torch_dist_graph_ranks import (GATHER, MODES, PERMUTES, THRESHOLDS,
                                    WORLD, batch_masks, graph_cases)
import jax_distributed_golden as golden_run

from repro import topology as jtop
from repro.core import distributed_graph as jg
from repro.core.connected_components import connected_components_graph
from repro_torch.core import distributed_graph as tg

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "..", "src")
GOLDEN = os.path.join(_HERE, "data", "jax_distributed_golden.npz")
RANKS_TIMEOUT_S = 900
LIVE_GROUP = ("random40_p8", "sharded")
LIVE_QUERY = "gather"
LIVE_TIMEOUT_S = 900

CASES = graph_cases()
KEYS = [f"{name}|{mode}|{gm}" for name in CASES for mode in MODES
        for gm in GATHER]
GOLDEN_KEYS = [f"{name}|{mode}|{gm}" for name in golden_run.GRAPH_CASES
               for mode in MODES for gm in GATHER]
FLOAT_FIELDS = ("ghost_bytes", "masked_ghost_fraction", "pad_fraction",
                "table_bytes_peak")


def _decomps(name):
    n, s, r, nparts, part, _, _ = CASES[name]
    return (jg.GraphDecomp(n, s, r, nparts, part=part),
            tg.GraphDecomp(n, s, r, nparts, part=part))


def _env(**extra):
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [_SRC, _HERE, os.environ.get("PYTHONPATH", "")]), **extra)


def _jax_pure():
    """{(case, what): labels} of JAX's pure graph routes on every case's
    global input: cc of its mask and of its batch's masks, and the sweep."""
    out = {}
    for name, (n, s, r, _, _, mask, field) in CASES.items():
        js, jr = jnp.asarray(s), jnp.asarray(r)
        out[name, "cc"] = np.asarray(connected_components_graph(
            jnp.asarray(mask), js, jr).labels)
        for b, m in enumerate(batch_masks(CASES[name])):
            out[name, f"item{b}"] = np.asarray(connected_components_graph(
                jnp.asarray(m), js, jr).labels)
        out[name, "sweep"] = np.asarray(jtop.submit(jtop.TopologyRequest(
            "threshold_sweep", domain="graph", field=field,
            thresholds=np.asarray(THRESHOLDS, np.float32), senders=s,
            receivers=r)).labels)
    return out


@pytest.fixture(scope="module")
def live_jax(tmp_path_factory):
    """Start JAX's distributed graph program on LIVE_GROUP's LIVE_QUERY in a
    subprocess (8 virtual CPU devices); yields (process, output dir)."""
    out = tmp_path_factory.mktemp("live_jax_graph")
    log = open(out / "log", "w")
    proc = subprocess.Popen(
        [sys.executable, golden_run.__file__, "--group",
         str(golden_run.ALL.index(("graph", LIVE_GROUP))), "--out",
         str(out / "part.npz"), "--queries", LIVE_QUERY],
        env=_env(JAX_PLATFORMS="cpu"), stdout=log, stderr=subprocess.STDOUT)
    try:
        yield proc, out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


@pytest.fixture(scope="module")
def run(tmp_path_factory, live_jax):
    """Start the 8 ranks (the live JAX run is already going), compute the
    JAX references meanwhile, wait for the ranks.  Returns ([per-rank
    results], JAX references)."""
    out = tmp_path_factory.mktemp("graph_ranks")
    env = _env(OMP_NUM_THREADS="1")
    logs = [open(out / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(_HERE, "torch_dist_graph_ranks.py"),
         str(r), str(WORLD), str(out / "store"), str(out)], env=env,
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(WORLD)]
    try:
        refs = _jax_pure()
        deadline = time.monotonic() + RANKS_TIMEOUT_S
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    failed = {r: (out / f"rank{r}.log").read_text()[-3000:]
              for r, p in enumerate(procs) if p.returncode != 0}
    assert not failed, failed
    results = [torch.load(out / f"rank{r}.pt", weights_only=True)
               for r in range(WORLD)]
    return results, refs


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as f:
        return dict(f)


def _assembled(results, key, name, field="labels"):
    """The global labels of a case from every rank's own labels, after
    checking each part's dtype and length."""
    dec = _decomps(name)[1]
    parts = [results[p][key][field] for p in range(dec.nparts)]
    for p, part in enumerate(parts):
        assert part.dtype == torch.int32
        assert part.shape[-1] == dec.owned_counts[p]
    return tg.assemble_graph_labels(parts, dec).numpy()


def _rank_stats(results, key, n):
    """Rank 0's stats, after checking that ranks 1..n-1 report the same
    values in the same dtypes."""
    first = results[0][key]["stats"]
    for r in range(1, n):
        for field, v in results[r][key]["stats"].items():
            assert v.dtype == first[field].dtype and torch.equal(
                v, first[field]), f"rank {r} {field}"
    return first


# --- geometry, in one process -------------------------------------------------


@pytest.mark.parametrize("name", list(CASES))
def test_graph_decomposition_matches_jax(name):
    j, t = _decomps(name)
    for attr in ("n", "nparts", "n_owned", "pad_fraction", "g_max",
                 "n_local", "c_max", "table_size", "n_cut", "e_max"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert t.id_dtype == torch.int32 and j.id_dtype == jnp.int32
    for attr in ("part", "owned_counts", "owned_gid", "local_gid",
                 "local_valid", "local_ghost", "owned_lidx", "cut_lidx",
                 "edge_src", "edge_dst", "cut_edge_src", "cut_edge_dst",
                 "cut_gid_sorted", "cut_slot_sorted"):
        got, want = getattr(t, attr), getattr(j, attr)
        assert got.dtype == want.dtype, attr
        np.testing.assert_array_equal(got, want, err_msg=attr)
    jgeom, tgeom = jg._graph_shard_geom(j), tg._graph_shard_geom(t)
    assert tg._graph_shard_geom(t) is tgeom
    for attr in ("d_max", "n_chunks", "stack_size", "round_perms",
                 "se_max"):
        assert getattr(tgeom, attr) == getattr(jgeom, attr), attr
    for attr in ("chunk_of", "store_idx", "stack_edge_src",
                 "stack_edge_dst"):
        got, want = getattr(tgeom, attr), getattr(jgeom, attr)
        assert got.dtype == want.dtype, attr
        np.testing.assert_array_equal(got, want, err_msg=attr)
    # each round of the schedule is a partial permutation
    for rnd in tgeom.round_perms:
        assert len({q for q, _ in rnd}) == len({p for _, p in rnd}) \
            == len(rnd)


@pytest.mark.parametrize("args,match", [
    ((0, [], [], 1), "at least one vertex"),
    ((3, [0], [1], 0), "nparts"),
    ((3, [0, 1], [1], 1), "equal length"),
    ((3, [0, 3], [1, 0], 1), "out of range"),
    ((3, [0, 1], [1, 0], 2, [0, 1]), "every vertex"),
    ((3, [0, 1], [1, 0], 2, [0, 1, 2]), r"\[0, 2\)"),
    ((3, [0], [2], 2, [0, 0, 1]), "BOTH directions"),
])
def test_graph_decomposition_refuses_what_jax_refuses(args, match):
    for mod in (jg, tg):
        with pytest.raises(ValueError, match=match):
            mod.GraphDecomp(*args)


# --- 8 gloo ranks ------------------------------------------------------------


@pytest.mark.parametrize("key", KEYS)
def test_labels_match_the_jax_pure_path(run, key):
    results, refs = run
    name = key.split("|")[0]
    n, s, r, _, _, mask, _ = CASES[name]
    got = _assembled(results, key, name)
    want = refs[name, "cc"]
    assert want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, oracle_components_graph(mask, s, r).astype(np.int32))


@pytest.mark.parametrize("key", KEYS)
def test_stats_are_replicated_and_match_their_closed_forms(run, key):
    results, _ = run
    name, mode, gm = key.split("|")
    gm = gm == "True"
    dec = _decomps(name)[1]
    stats = _rank_stats(results, key, dec.nparts)
    for field, v in stats.items():
        assert v.ndim == 0
        assert v.dtype == (torch.float32 if field in FLOAT_FIELDS
                           else torch.int32), field
    mask, f32, isz = CASES[name][5], np.float32, 4
    real = dec.cut_lidx >= 0
    cut_gid = np.take_along_axis(dec.local_gid, np.maximum(dec.cut_lidx, 0),
                                 axis=1)[real]
    masked = f32(int(mask[cut_gid].sum())) / f32(max(dec.n_cut, 1))
    rounds = int(stats["exchange_rounds"])
    want = {"pad_fraction": f32(dec.pad_fraction), "converged": 1,
            "kernel_rounds": 0, "global_iters_saved": 0}
    if dec.table_size == 0:
        want.update(comm_phases=0, exchange_rounds=0, table_iters=0,
                    ghost_bytes=f32(0), masked_ghost_fraction=f32(0),
                    table_bytes_peak=f32(0))
    elif mode == "replicated":
        rows = 2 if gm else 1
        want.update(comm_phases=1, exchange_rounds=0,
                    masked_ghost_fraction=masked,
                    ghost_bytes=f32(dec.n_cut * rows * isz),
                    table_bytes_peak=f32(dec.table_size * (
                        2 * isz if gm else isz + 1)))
    else:
        geom = tg._graph_shard_geom(dec)
        halo = geom.stack_size - dec.c_max
        assert rounds >= 1
        want.update(comm_phases=rounds + 1, masked_ghost_fraction=masked,
                    ghost_bytes=f32(halo * isz) * (f32(rounds) + f32(1))
                    + (f32(halo) if gm else f32(0)),
                    table_bytes_peak=f32((2 * geom.stack_size + dec.c_max)
                                         * isz + geom.stack_size))
    for field, w in want.items():
        got = stats[field].item()
        if isinstance(w, np.float32):
            assert f32(got) == w, (field, got, w)
        else:
            assert got == w, (field, got, w)
    assert int(stats["local_iters"]) >= 1


@pytest.mark.parametrize("key", GOLDEN_KEYS)
def test_stats_match_the_jax_distributed_record(run, golden, key):
    """Labels and every GraphDPCStats field (value and dtype) against the
    record of JAX's distributed graph program."""
    results, _ = run
    name, mode, gm = key.split("|")
    gkey = golden_run.graph_key(name, mode,
                                "gather" if gm == "True" else "nogather")
    want = golden[f"{gkey}__labels"]
    assert want.dtype == np.int32
    np.testing.assert_array_equal(_assembled(results, key, name), want)
    for field, v in _rank_stats(results, key, CASES[name][3]).items():
        w = golden[f"{gkey}__{field}"]
        assert str(v.dtype).split(".")[1] == str(w.dtype), field
        assert v.item() == w.item(), (field, v.item(), w.item())


@pytest.mark.parametrize("key", KEYS)
def test_batch_items_equal_single_calls(run, key):
    """A batch of three masks: each item's labels equal its single call's
    and JAX's pure path, its (B,) stats fields the single calls' values,
    and it issues as many collectives of each kind as its slowest item's
    single call (as many as every item's in replicated mode)."""
    results, refs = run
    name, mode, _ = key.split("|")
    nparts = CASES[name][3]
    got = _assembled(results, f"{key}|batch", name)
    stats = _rank_stats(results, f"{key}|batch", nparts)
    for b in range(3):
        item = f"{key}|item{b}"
        np.testing.assert_array_equal(got[b], refs[name, f"item{b}"])
        np.testing.assert_array_equal(got[b], _assembled(results, item,
                                                         name))
        for field, v in _rank_stats(results, item, nparts).items():
            assert stats[field].shape == (3,) and \
                stats[field].dtype == v.dtype, field
            assert stats[field][b].item() == v.item(), (b, field)
    for rank in range(nparts):
        counts = results[rank][f"{key}|batch"]["counts"]
        singles = [results[rank][f"{key}|item{b}"]["counts"]
                   for b in range(3)]
        assert counts == {k: max(c[k] for c in singles) for k in counts}
        assert counts["shift"] == 0
        if mode == "replicated":
            assert all(c == counts for c in singles)


@pytest.mark.parametrize("name,mode", [(n, m) for n in CASES for m in MODES])
def test_facade_routes_equal_direct_calls_and_jax(run, name, mode):
    """`submit(TopologyRequest("cc" | "threshold_sweep", domain="graph",
    backend="distributed"))` with the global mask or field on every rank:
    cc equals the direct call (labels, `stats == as_dict()`); the sweep,
    assembled, equals JAX's pure sweep, with (K,) stats; no threshold gives
    (0, owned_counts[p]) int32 labels."""
    results, refs = run
    nparts = CASES[name][3]
    dec = _decomps(name)[1]
    for rank in range(nparts):
        got = results[rank][f"{name}|{mode}|facade cc"]
        want = results[rank][f"{name}|{mode}|True"]
        assert torch.equal(got["labels"], want["labels"])
        assert got["stats"] == tg.GraphDPCStats(**want["stats"]).as_dict()
        sweep = results[rank][f"{name}|{mode}|facade sweep3"]["stats"]
        assert sweep["converged"] == [1] * len(THRESHOLDS)
        empty = results[rank][f"{name}|{mode}|facade sweep0"]["labels"]
        assert empty.dtype == torch.int32
        assert tuple(empty.shape) == (0, int(dec.owned_counts[rank]))
    np.testing.assert_array_equal(
        _assembled(results, f"{name}|{mode}|facade sweep3", name),
        refs[name, "sweep"])


def test_permute_is_a_partial_permutation(run):
    """`DPCMesh.permute` at `PERMUTES`: a rank gets what its source sent,
    zeros without one (rank 6 and the empty permutation), its own value on
    a self pair; bools travel; a repeated source raises ValueError."""
    results, _ = run
    for i, pairs in enumerate(PERMUTES):
        source = {d: s for s, d in pairs}
        for rank in range(WORLD):
            col = results[rank]["collectives"]
            src = source.get(rank)
            want = [0, 0] if src is None else [src + 1, -10 * src]
            want_b = [False, False] if src is None else [src % 2 == 0, True]
            assert col[f"permute{i}"] == want, (i, rank)
            assert col[f"permute_bool{i}"] == want_b, (i, rank)
    for rank in range(WORLD):
        assert "repeat a source" in \
            results[rank]["collectives"]["repeated_source"]


def test_mesh_and_mask_checks_match_jax():
    """The entry points' own ValueErrors and messages, raised before any
    collective: a mesh that is not 1-D, a partition count that does not
    match, a mask of the wrong length."""
    dec = _decomps("tet4_p2")[1]

    class Mesh:
        def __init__(self, names, layout):
            self.names, self.layout = names, layout
    fn = tg.distributed_connected_components_graph
    with pytest.raises(ValueError, match="graph CC needs a 1-D mesh"):
        fn(torch.ones(64, dtype=torch.bool), dec, Mesh(("bx", "by"),
                                                       (1, 2)))
    with pytest.raises(ValueError, match="mesh has 4 devices but decomp "
                       "has 2 partitions"):
        fn(torch.ones(64, dtype=torch.bool), dec, Mesh(("shards",), (4,)))
    with pytest.raises(ValueError, match="mask has 63 entries for 64 "
                       "vertices"):
        fn(torch.ones(63, dtype=torch.bool), dec, Mesh(("shards",), (2,)))
    with pytest.raises(ValueError, match="masks have 63 entries for 64 "
                       "vertices"):
        tg.distributed_connected_components_graph_batch(
            torch.ones(2, 63, dtype=torch.bool), dec, Mesh(("shards",),
                                                           (2,)))


@pytest.fixture(scope="module")
def live(live_jax):
    proc, out = live_jax
    rc = proc.wait(timeout=LIVE_TIMEOUT_S)
    assert rc == 0, (out / "log").read_text()[-3000:]
    with np.load(out / "part.npz") as f:
        return dict(f)


def test_live_jax_distributed_run_equals_the_record_and_the_port(
        run, golden, live):
    results, _ = run
    name, mode = LIVE_GROUP
    key = golden_run.graph_key(name, mode, LIVE_QUERY)
    fields = ("labels",) + tg.GraphDPCStats._fields
    assert sorted(live) == sorted(f"{key}__{f}" for f in fields)
    for field in fields:
        got, want = live[f"{key}__{field}"], golden[f"{key}__{field}"]
        assert got.dtype == want.dtype and got.shape == want.shape, field
        np.testing.assert_array_equal(got, want, err_msg=field)
    rkey = f"{name}|{mode}|{LIVE_QUERY == 'gather'}"
    np.testing.assert_array_equal(_assembled(results, rkey, name),
                                  live[f"{key}__labels"])
    for field, v in _rank_stats(results, rkey, CASES[name][3]).items():
        assert v.item() == live[f"{key}__{field}"].item(), field

"""The port's distributed grid backend (`repro_torch/core/distributed.py`)
against the JAX package, on the CPU.

Geometry: the port's `BlockDecomp` and `_ShardGeom` against JAX's (neither
needs a device mesh) on the ragged corpus, 97x61x43 over (2, 2, 2) and the
divisible cases.

Ranks: one gloo group of 8 CPU processes (`tests/torch_dist_ranks.py`),
started once for the module, runs every case; layouts of fewer ranks run on
subgroups.  Each case's blocks of labels, gathered here, must equal the JAX
pure path (`descending_manifold`, `ascending_manifold`,
`connected_components_grid`, run in this process while the ranks work) bit
for bit, and the numpy oracles; every rank must report the same stats, and
the stats their closed forms.  Cases: the ragged corpus and 97x61x43 over
(2, 2, 2); `ms` (both manifolds) and `cc` with the mask gathered and not;
connectivity 6 and 26 (4 and 6 in 2-D); both table modes.

JAX's own distributed functions compile their shard_map program anew on
every call (about 30 s a call here), so this module runs one group of them
live and reads the rest from a record: `tests/jax_distributed_golden.py`
ran them on 8 virtual devices on the divisible cases (16^3 and 16x12x8
over (2, 2, 2)) and wrote `tests/data/jax_distributed_golden.npz`; the
same script runs one case again, connected components of 16x12x8 at
connectivity 6, sharded, mask gathered (about 70 s of compiles), in a
subprocess while the ranks work, and that run must equal both the record
and the port, field for field.  The port run with
`fused_impl="ref"` must equal every field of it (the JAX package's CPU
"auto" is the init-only path, kernel_rounds 0); with "auto" (the fused
kernel's plain version on the CPU) the labels and every field but
`kernel_rounds`, `local_iters` and `global_iters_saved`, which depend on
where the local phase starts.  Ragged extents are not compared with JAX's
distributed functions: under jax 0.9.0 they raise ShardingTypeError there
(ROADMAP Queue 3 item 6), so ragged cases are held to the pure path.

Batches (`distributed_*_batch`, B = 3 on 16x12x8 and B = 2 on 97x61x43 over
(2, 2, 2)): each item's labels and stats equal its single call, the stats
carry a leading (B,) dim, and the batch issues as many halo shifts,
all-gathers and all-reduces as the single call of its slowest item (every
item's, in replicated mode); the 16x12x8 batch equals the record of JAX's
`distributed_*_batch` field for field.  The facade's distributed routes
(`topology.submit`, each rank passing its block) equal the direct calls,
and, gathered, JAX's pure routes, the `ms` segmentation's pair hash with
the global vertex count included.
"""
import math
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from oracles import oracle_components, oracle_manifold
from torch_dist_ranks import (BATCHES, GOLDEN_SHAPES, MODES, QUERIES, SWEEP,
                              WORLD, golden_inputs, grid_cases, grid_inputs,
                              sweep_field)
import jax_distributed_golden as golden_run

from repro import topology as jtop
from repro.core import distributed as jdist
from repro.core.connected_components import connected_components_grid
from repro.core.ms_segmentation import ascending_manifold, descending_manifold
from repro_torch.core import distributed as tdist

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "..", "src")
GOLDEN = os.path.join(_HERE, "data", "jax_distributed_golden.npz")
RANKS_TIMEOUT_S = 900
# the case of JAX's distributed functions run live: (shape, conn, mode)
# and the query
LIVE_GROUP = ((16, 12, 8), 6, "sharded")
LIVE_QUERY = "cc_gather"
LIVE_TIMEOUT_S = 900

CASES = {c[0]: c for c in grid_cases()}
KEYS = [f"{name}|{conn}|{mode}|{query}"
        for name, (_, _, _, conns, _, _) in CASES.items()
        for conn in conns for mode in MODES for query in QUERIES]
GOLDEN_KEYS = [f"{'x'.join(map(str, s))}|{conn}|{mode}|{query}|{impl}"
               for s in GOLDEN_SHAPES for conn in (6, 26) for mode in MODES
               for query in QUERIES for impl in ("ref", "auto")]
IMPL_FIELDS = ("kernel_rounds", "local_iters", "global_iters_saved")
BATCH_KEYS = [f"batch|{name}|{conn}|{mode}|{query}"
              for name, _, _, conns in BATCHES for conn in conns
              for mode in MODES for query in QUERIES]
FACADE_KEYS = [f"facade|{name}|{conns[0]}|{mode}"
               for name, (_, _, _, conns, _, _) in CASES.items()
               for mode in MODES]


def _names(layout):
    return jdist.BLOCK_AXES[:len(layout)]


def _jax_pure():
    """{(case, conn, query kind): labels} of the JAX pure path and, for the
    corpus, the numpy oracles, on every case's global input."""
    out = {}
    for name, shape, _, conns, mask_p, seed in CASES.values():
        order, mask = grid_inputs(shape, mask_p, seed)
        for conn in conns:
            want = {
                "desc": descending_manifold(jnp.asarray(order), conn)[0],
                "asc": ascending_manifold(jnp.asarray(order), conn)[0],
                "cc": connected_components_grid(jnp.asarray(mask),
                                                conn).labels}
            for kind, labels in want.items():
                out[name, conn, kind] = np.asarray(labels).reshape(shape)
            if conn == conns[0]:
                # the facade's pure routes: ms and a threshold sweep
                out[name, conn, "ms"] = np.asarray(jtop.submit(
                    jtop.TopologyRequest("ms", order=order,
                                         connectivity=conn)).segmentation)
                out[name, conn, "sweep"] = np.asarray(jtop.submit(
                    jtop.TopologyRequest(
                        "threshold_sweep", field=sweep_field(shape, seed),
                        thresholds=np.asarray(SWEEP, np.float32),
                        connectivity=conn)).labels)
            if name.startswith("corpus"):
                out[name, conn, "oracle desc"] = oracle_manifold(order, conn,
                                                                 True)
                out[name, conn, "oracle asc"] = oracle_manifold(order, conn,
                                                                False)
                out[name, conn, "oracle cc"] = oracle_components(mask, conn)
    return out


def _env(**extra):
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [_SRC, _HERE, os.environ.get("PYTHONPATH", "")]), **extra)


@pytest.fixture(scope="module")
def live_jax(tmp_path_factory):
    """Start JAX's distributed functions on LIVE_GROUP's LIVE_QUERY in a
    subprocess (8 virtual CPU devices); yields (process, its output
    directory)."""
    out = tmp_path_factory.mktemp("live_jax")
    log = open(out / "log", "w")
    proc = subprocess.Popen(
        [sys.executable, golden_run.__file__, "--group",
         str(golden_run.GROUPS.index(LIVE_GROUP)), "--out",
         str(out / "part.npz"), "--queries", LIVE_QUERY], env=_env(JAX_PLATFORMS="cpu"), stdout=log,
        stderr=subprocess.STDOUT)
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
    out = tmp_path_factory.mktemp("ranks")
    env = _env(OMP_NUM_THREADS="1")
    logs = [open(out / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(_HERE, "torch_dist_ranks.py"), str(r),
         str(WORLD), str(out / "store"), str(out)], env=env, stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(WORLD)]
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


def _gathered(results, key, shape, layout, field="labels"):
    """The global labels of a case: every rank's block put in place (with
    the blocks' leading dims, if any)."""
    dec = tdist.BlockDecomp(shape, layout, _names(layout))
    blocks = [r[key][field] for r in results[:math.prod(layout)]]
    lead = tuple(blocks[0].shape[:blocks[0].dim() - len(shape)])
    out = np.full(lead + tuple(shape), -2, np.int64)
    for rank, block in enumerate(blocks):
        coords = np.unravel_index(rank, layout)
        assert block.dtype == torch.int32
        out[(Ellipsis,) + dec.block_slices(coords)] = block.numpy()
    assert (out != -2).all(), "the blocks cover the grid"
    return out.astype(np.int32)


def _rank_stats(results, key, n):
    """The stats of rank 0, after checking that ranks 1..n-1 report the
    same values in the same dtypes."""
    first = results[0][key]["stats"]
    for r in range(1, n):
        for field, v in results[r][key]["stats"].items():
            assert v.dtype == first[field].dtype and torch.equal(
                v, first[field]), f"rank {r} {field}"
    return first


def _closed_forms(name, conn, mode, query, stats, mask):
    """The stats that have a closed form in the decomposition."""
    _, shape, layout, _, _, _ = CASES[name]
    dec = jdist.BlockDecomp(shape, layout, _names(layout))
    isz, gm = 4, query == "cc_gather"
    rounds = int(stats["exchange_rounds"])
    want = {"pad_fraction": np.float32(dec.pad_fraction), "converged": 1}
    if query.startswith("cc"):
        coords = dec.boundary_coords
        real = (coords < np.asarray(dec.grid)).all(axis=1)
        masked = int(mask[tuple(coords[real].T)].sum())
        want["masked_ghost_fraction"] = np.float32(masked) / np.float32(
            max(dec.n_valid_slots, 1))
    else:
        want.update(masked_ghost_fraction=np.float32(1.0), stitch_rounds=0)
    if mode == "replicated":
        want.update(comm_phases=1, exchange_rounds=0)
        if query.startswith("cc"):
            want["ghost_bytes"] = np.float32(dec.n_valid_slots * isz) + (
                np.float32(dec.n_valid_slots) if gm else np.float32(0.0))
            want["table_bytes_peak"] = np.float32(dec.table_size * (isz + 1))
        else:
            want["ghost_bytes"] = np.float32(dec.n_valid_slots * isz)
            want["table_bytes_peak"] = np.float32(dec.table_size * isz)
    else:
        geom = jdist._ShardGeom(dec, conn)
        halo = geom.stack_size - geom.rows
        assert rounds >= 1
        if query.startswith("cc"):
            want["comm_phases"] = rounds + 1
            want["ghost_bytes"] = (np.float32(halo * isz) * (np.float32(rounds) + np.float32(1))
                                   + (np.float32(halo) if gm else np.float32(0.0)))
            want["table_bytes_peak"] = np.float32(
                (2 * geom.stack_size + geom.rows) * isz + geom.stack_size)
        else:
            want["comm_phases"] = rounds
            want["ghost_bytes"] = np.float32(halo * isz) * np.float32(rounds)
            want["table_bytes_peak"] = np.float32((geom.stack_size + geom.rows)
                                            * isz)
    return want


def _check_stats(stats, want):
    for field, v in stats.items():
        assert v.ndim == 0
        assert v.dtype == (torch.float32 if field in (
            "ghost_bytes", "masked_ghost_fraction", "pad_fraction",
            "table_bytes_peak") else torch.int32), field
    for field, w in want.items():
        got = stats[field].item()
        if isinstance(w, np.float32):
            assert np.float32(got) == w, (field, got, w)
        else:
            assert got == w, (field, got, w)
    kr, li = int(stats["kernel_rounds"]), int(stats["local_iters"])
    assert int(stats["global_iters_saved"]) >= 0
    assert int(stats["global_iters_saved"]) <= kr
    assert li >= 1


# --- geometry, in one process -------------------------------------------------


GEOMETRY = sorted({(c[1], c[2]) for c in CASES.values()}
                  | {(s, (2, 2, 2)) for s in GOLDEN_SHAPES}
                  | {((3, 9), (8,)), ((8, 8, 8), (2, 2, 2))})


@pytest.mark.parametrize("shape,layout", GEOMETRY)
def test_block_decomposition_matches_jax(shape, layout):
    names = _names(layout)
    j = jdist.BlockDecomp(shape, layout, names)
    t = tdist.BlockDecomp(shape, layout, names)
    for attr in ("grid", "layout", "local", "padded", "ext", "ragged",
                 "nblocks", "size", "stride", "bstride", "face_stride",
                 "face_size", "face_offset", "table_size", "owned_slices",
                 "n_valid_slots", "pad_fraction"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert t.id_dtype == torch.int32 and j.id_dtype == jnp.int32
    np.testing.assert_array_equal(t.ghost_mask(), j.ghost_mask())
    assert t.boundary_coords.dtype == np.int32
    np.testing.assert_array_equal(t.boundary_coords, j.boundary_coords)
    np.testing.assert_array_equal(t.slot_coords(torch).numpy(),
                                  j.boundary_coords)
    g = np.arange(j.size, dtype=np.int32)
    jb, jp = j.boundary_pos(g, np)
    for got_b, got_p in (t.boundary_pos(g, np),
                         t.boundary_pos(torch.from_numpy(g))):
        got_b, got_p = np.asarray(got_b), np.asarray(got_p)
        assert got_p.dtype == np.int32
        np.testing.assert_array_equal(got_b, jb)
        np.testing.assert_array_equal(got_p, jp)
    # the blocks tile the grid once, none longer than `local`
    cover = np.zeros(shape, np.int32)
    for coords in np.ndindex(*layout):
        sl = t.block_slices(coords)
        assert all(s.stop - s.start <= n for s, n in zip(sl, t.local))
        cover[sl] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("conn", [6, 26])
@pytest.mark.parametrize("shape,layout", GEOMETRY)
def test_shard_geometry_matches_jax(shape, layout, conn):
    if len(shape) == 2:
        conn = {6: 4, 26: 6}[conn]
    names = _names(layout)
    j = jdist._ShardGeom(jdist.BlockDecomp(shape, layout, names), conn)
    t = tdist._ShardGeom(tdist.BlockDecomp(shape, layout, names), None, conn)
    for attr in ("rows", "local_off", "act", "sz", "moore", "n_chunks",
                 "stack_size"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert getattr(t, "vn_base", None) == getattr(j, "vn_base", None)


def test_mesh_needs_a_process_group_and_a_valid_layout():
    with pytest.raises(ValueError, match="1..3 axes"):
        tdist.make_dpc_mesh((2, 2, 2, 2), device="cpu")
    with pytest.raises(ValueError, match="positive"):
        tdist.make_dpc_mesh((2, 0), device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        tdist.make_dpc_mesh((2, 2), device="cpu")


# --- 8 gloo ranks ------------------------------------------------------------


@pytest.mark.parametrize("key", KEYS)
def test_labels_match_the_jax_pure_path(run, key):
    results, refs = run
    name, conn, mode, query = key.split("|")
    _, shape, layout, _, mask_p, seed = CASES[name]
    got = _gathered(results, key, shape, layout)
    kind = "cc" if query.startswith("cc") else query
    want = refs[name, int(conn), kind]
    assert want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if name.startswith("corpus"):
        np.testing.assert_array_equal(
            got, refs[name, int(conn), f"oracle {kind}"].astype(np.int32))


@pytest.mark.parametrize("key", KEYS)
def test_stats_are_replicated_and_match_their_closed_forms(run, key):
    results, _ = run
    name, conn, mode, query = key.split("|")
    _, shape, layout, _, mask_p, seed = CASES[name]
    stats = _rank_stats(results, key, math.prod(layout))
    _, mask = grid_inputs(shape, mask_p, seed)
    _check_stats(stats, _closed_forms(name, int(conn), mode, query, stats,
                                      mask))


@pytest.mark.parametrize("name,conn", [(n, c) for n, v in CASES.items()
                                       for c in v[3]])
def test_labels_agree_across_table_modes_and_gather_mask(run, name, conn):
    results, _ = run
    _, shape, layout, _, _, _ = CASES[name]
    for query in QUERIES:
        want = _gathered(results, f"{name}|{conn}|replicated|{query}",
                         shape, layout)
        got = _gathered(results, f"{name}|{conn}|sharded|{query}", shape,
                        layout)
        np.testing.assert_array_equal(got, want)
    for mode in MODES:
        a = _gathered(results, f"{name}|{conn}|{mode}|cc_gather", shape,
                      layout)
        b = _gathered(results, f"{name}|{conn}|{mode}|cc_nogather", shape,
                      layout)
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as f:
        return dict(f)


@pytest.mark.parametrize("key", GOLDEN_KEYS)
def test_divisible_cases_match_jax_distributed(run, golden, key):
    """Labels and every DPCStats field against JAX's distributed_manifold /
    distributed_connected_components (fused_impl "ref" against JAX's CPU
    "auto", the init-only path: every field; "auto": the labels and every
    field but the three that depend on the local phase's start)."""
    results, _ = run
    name, conn, mode, query, impl = key.split("|")
    shape = tuple(int(x) for x in name.split("x"))
    order, mask = golden_inputs(shape)
    np.testing.assert_array_equal(golden[f"{name}__order"], order)
    np.testing.assert_array_equal(golden[f"{name}__mask"], mask)
    gkey = f"{name}__c{conn}__{mode}__{query}"
    rkey = f"{name}|{conn}|{mode}|{query}|{impl}"
    got = _gathered(results, rkey, shape, (2, 2, 2))
    want = golden[f"{gkey}__labels"]
    assert want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    stats = _rank_stats(results, rkey, WORLD)
    for field, v in stats.items():
        w = golden[f"{gkey}__{field}"]
        assert str(v.dtype).split(".")[1] == str(w.dtype), field
        if impl == "auto" and field in IMPL_FIELDS:
            continue
        assert v.item() == w.item(), (field, v.item(), w.item())
    if impl == "auto":
        assert int(stats["kernel_rounds"]) >= 1
        ref = _rank_stats(results, rkey[:-4] + "ref", WORLD)
        assert int(ref["kernel_rounds"]) == 0
        if query in ("desc", "asc"):
            assert int(stats["local_iters"]) <= int(ref["local_iters"])
            assert int(stats["global_iters_saved"]) == max(
                int(stats["kernel_rounds"]) - int(stats["local_iters"]), 0)


@pytest.fixture(scope="module")
def live(live_jax):
    """LIVE_QUERY's arrays from the live run of JAX's distributed
    functions."""
    proc, out = live_jax
    rc = proc.wait(timeout=LIVE_TIMEOUT_S)
    assert rc == 0, (out / "log").read_text()[-3000:]
    with np.load(out / "part.npz") as f:
        return dict(f)


def test_live_jax_distributed_run_equals_the_record_and_the_port(
        run, golden, live):
    """JAX's distributed functions, run now, give the recorded labels and
    DPCStats (value and dtype), and the port (fused_impl "ref") gives
    theirs."""
    results, _ = run
    shape, conn, mode = LIVE_GROUP
    query = LIVE_QUERY
    key = golden_run.case_key(shape, conn, mode, query)
    fields = ("labels",) + tdist.DPCStats._fields
    assert sorted(live) == sorted(f"{key}__{f}" for f in fields)
    for field in fields:
        got, want = live[f"{key}__{field}"], golden[f"{key}__{field}"]
        assert got.dtype == want.dtype and got.shape == want.shape, field
        np.testing.assert_array_equal(got, want, err_msg=field)
    rkey = f"{'x'.join(map(str, shape))}|{conn}|{mode}|{query}|ref"
    np.testing.assert_array_equal(_gathered(results, rkey, shape, (2, 2, 2)),
                                  live[f"{key}__labels"])
    for field, v in _rank_stats(results, rkey, WORLD).items():
        w = live[f"{key}__{field}"]
        assert str(v.dtype).split(".")[1] == str(w.dtype), field
        assert v.item() == w.item(), (field, v.item(), w.item())


def _coords(rank, layout):
    return tuple(int(c) for c in np.unravel_index(rank, layout))


def test_axis_shift_at_layouts_2_4_and_8(run):
    """shift(to_next=[r, -r], to_prev=[r + 100, 100 - r]) returns what the
    neighbours sent, -7 where the lattice ends; layout 2 is a swap."""
    results, _ = run
    for layout in ((2, 4), (8,)):
        for rank in range(WORLD):
            c = _coords(rank, layout)
            for a in range(len(layout)):
                got = results[rank]["collectives"][f"shift{layout}/{a}"]
                want = []
                for step, add in ((-1, 0), (1, 100)):
                    n = list(c)
                    n[a] += step
                    if 0 <= n[a] < layout[a]:
                        r = int(np.ravel_multi_index(n, layout))
                        want += [r + add, -r + add]
                    else:
                        want += [-7, -7]
                assert got == want, (layout, rank, a)


def test_axis_shift_carries_bools(run):
    results, _ = run
    for layout in ((2, 4), (8,)):
        for rank in range(WORLD):
            p = _coords(rank, layout)[0]
            stride = WORLD // layout[0]
            prev = [(rank - stride) % 3 == 0, True] if p > 0 else [False] * 2
            nxt = [not ((rank + stride) % 3 == 0), False] \
                if p < layout[0] - 1 else [False] * 2
            assert results[rank]["collectives"][f"shift_bool{layout}"] == \
                prev + nxt, (layout, rank)


def test_all_gather_is_in_row_major_rank_order(run):
    results, _ = run
    for rank in range(WORLD):
        col = results[rank]["collectives"]
        assert col["all_gather"] == [[r, 10 * r] for r in range(WORLD)]
        assert col["all_gather_bool"] == [r % 2 == 1 for r in range(WORLD)]
        if rank < 4:
            assert col["subgroup_gather"] == [0, 1, 2, 3]


def test_all_reduce_max_min_sum(run):
    results, _ = run
    for rank in range(WORLD):
        assert results[rank]["collectives"]["reduce"] == [
            [7, 0], [0, -7], [28, -28]]


def test_ranks_report_the_failures_the_reference_raises(run):
    """check_converged raises on every rank when the table fixpoint is cut
    at table_max_iter=1, in both modes; without CUDA the default device
    raises."""
    results, _ = run
    for rank in range(WORLD):
        col = results[rank]["collectives"]
        assert col["not_converged"] == ["replicated", "sharded"], rank
        assert col["default_device"] == "RuntimeError", rank


# --- batches ------------------------------------------------------------------


def _batch_case(key):
    _, name, conn, mode, query = key.split("|")
    (_, shape, b, _), = [c for c in BATCHES if c[0] == name]
    return shape, b, int(conn), mode, query


@pytest.mark.parametrize("key", BATCH_KEYS)
def test_batch_items_equal_single_calls(run, key):
    """Each item's block of labels and every stats field equal the item's
    single call, on every rank; the batched fields carry a leading (B,)
    dim in the single call's dtype, the same on every rank."""
    results, _ = run
    shape, b, _, _, _ = _batch_case(key)
    stats = _rank_stats(results, key, WORLD)
    for rank in range(WORLD):
        got = results[rank][key]
        assert got["labels"].shape[0] == b
        for item in range(b):
            want = results[rank][f"{key}|item{item}"]
            assert torch.equal(got["labels"][item], want["labels"]), \
                (rank, item)
            for field, v in want["stats"].items():
                g = got["stats"][field]
                assert g.shape == (b,) and g.dtype == v.dtype, field
                assert g[item].item() == v.item(), (rank, item, field)
    assert int(stats["converged"].min()) == 1


@pytest.mark.parametrize("key", BATCH_KEYS)
def test_batch_collectives_fire_once_for_the_batch(run, key):
    """A batch issues as many shifts, all-gathers and all-reduces as the
    single call of its slowest item; in replicated mode every item's single
    call issues the same, so the batch issues what one single call does."""
    results, _ = run
    _, b, _, mode, _ = _batch_case(key)
    for rank in range(WORLD):
        got = results[rank][key]["counts"]
        singles = [results[rank][f"{key}|item{i}"]["counts"]
                   for i in range(b)]
        assert got == {k: max(c[k] for c in singles) for k in got}, rank
        assert got["shift"] >= 3 and got["all_reduce"] >= 1
        assert got["permute"] == 0
        if mode == "replicated":
            assert all(c == got for c in singles), rank
            assert got["all_gather"] >= 1


@pytest.mark.parametrize("key", [k for k in BATCH_KEYS
                                 if k.split("|")[1] == "16x12x8"])
def test_batch_matches_jax_distributed_batch(run, golden, key):
    """The 16x12x8 batch (fused_impl "ref") against JAX's
    distributed_manifold_batch / distributed_connected_components_batch:
    the gathered (B, *grid) labels and every (B,) stats field, value and
    dtype."""
    results, _ = run
    shape, b, conn, mode, query = _batch_case(key)
    orders, masks = golden_run.batch_inputs(shape, b)
    np.testing.assert_array_equal(golden["batch__orders"], orders)
    np.testing.assert_array_equal(golden["batch__masks"], masks)
    gkey = golden_run.batch_key(conn, mode, query)
    want = golden[f"{gkey}__labels"]
    assert want.dtype == np.int32 and want.shape == (b,) + shape
    np.testing.assert_array_equal(
        _gathered(results, key, shape, (2, 2, 2)), want)
    for field, v in _rank_stats(results, key, WORLD).items():
        w = golden[f"{gkey}__{field}"]
        assert str(v.dtype).split(".")[1] == str(w.dtype), field
        np.testing.assert_array_equal(v.numpy(), w, err_msg=field)


# --- the facade's distributed routes -------------------------------------------


@pytest.mark.parametrize("key", FACADE_KEYS)
def test_facade_routes_equal_direct_calls_and_jax(run, key):
    """`topology.submit(backend="distributed")`, each rank passing its
    block and `grid_shape`: cc and both manifolds equal the direct calls
    (labels and `stats == as_dict()`); ms gives both manifolds with their
    stats and, gathered, JAX's pure ms segmentation (the pair hash with the
    global vertex count); the sweep, gathered, equals JAX's pure sweep with
    batched stats, and no threshold gives (0, *block) int32 labels."""
    results, refs = run
    _, name, conn, mode = key.split("|")
    _, shape, layout, _, _, _ = CASES[name]
    n = math.prod(layout)

    def direct(query):
        return f"{name}|{conn}|{mode}|{query}"
    for rank in range(n):
        res = results[rank]
        for query, ref in (("cc", "cc_gather"), ("manifoldTrue", "desc"),
                           ("manifoldFalse", "asc")):
            got, want = res[f"{key}|{query}"], res[direct(ref)]
            assert torch.equal(got["labels"], want["labels"]), query
            assert got["stats"] == tdist.DPCStats(
                **want["stats"]).as_dict(), query
        ms = res[f"{key}|ms"]
        for field, ref in (("descending", "desc"), ("ascending", "asc")):
            assert torch.equal(ms[field], res[direct(ref)]["labels"])
            assert ms["stats"][field] == tdist.DPCStats(
                **res[direct(ref)]["stats"]).as_dict()
        assert ms["segmentation"].dtype == torch.int32
        sweep = res[f"{key}|sweep3"]
        assert sweep["stats"]["converged"] == [1] * len(SWEEP)
        empty = res[f"{key}|sweep0"]["labels"]
        assert empty.dtype == torch.int32
        assert tuple(empty.shape) == (0,) + tuple(
            res[direct("desc")]["labels"].shape)
    np.testing.assert_array_equal(
        _gathered(results, f"{key}|ms", shape, layout, "segmentation"),
        refs[name, int(conn), "ms"].reshape(shape))
    np.testing.assert_array_equal(
        _gathered(results, f"{key}|sweep3", shape, layout),
        refs[name, int(conn), "sweep"].reshape((len(SWEEP),) + shape))

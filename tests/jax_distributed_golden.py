"""Writes `tests/data/jax_distributed_golden.npz`: the JAX package's
distributed functions on 8 virtual CPU devices, for
`tests/test_torch_distributed.py` and `tests/test_torch_distributed_graph.py`.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/jax_distributed_golden.py

Three kinds of groups:

  grid   `distributed_manifold` and `distributed_connected_components` over
         a (2, 2, 2) mesh: 16^3 and 16x12x8 (divisible extents),
         connectivity 6 and 26, both table modes; the descending and
         ascending manifolds of a seeded order field, and connected
         components of a seeded mask with the mask gathered and not.
  batch  `distributed_manifold_batch` and
         `distributed_connected_components_batch` on 16x12x8 over (2, 2, 2),
         B = 3 (`batch_inputs`), the same queries, connectivities and modes.
  graph  the distributed graph program on four cases of
         `tests/torch_dist_graph_ranks.py` (`GRAPH_CASES`), both table
         modes, the mask gathered and not.  Under jax 0.9.0 the public
         `distributed_connected_components_graph` raises ShardingTypeError
         in its last step, the scatter of the sharded owned labels back to
         global ids, after its shard_map has run.  So `run_graph` runs the
         same per-partition program (`_cc_partition`) through the same
         shard_map with the same arguments, and does that scatter in numpy.

Each grid and batch case runs with the block-local phase's
`fused_impl="auto"` (on the CPU the JAX package's init-only path).  The
file holds the inputs, the labels and every stats field in its JAX dtype.

Each entry point compiles its shard_map program anew on every call (about
30-60 s a call on one CPU core), which is why the tests read this file and
do not run them itself.  `--jobs N` runs the groups in N worker processes;
`--kinds` (comma-separated) runs only those kinds and keeps the record's
other entries; `--group I` runs one group (an index into `ALL`) and writes
its part, `--queries` (comma-separated) only some of its queries.
"""
import argparse
import itertools
import os
import subprocess
import sys
import tempfile

import numpy as np

SHAPES = ((16, 16, 16), (16, 12, 8))
CONNS = (6, 26)
MODES = ("replicated", "sharded")
LAYOUT = (2, 2, 2)
MASK_P = 0.6
QUERIES = ("desc", "asc", "cc_gather", "cc_nogather")
GROUPS = tuple(itertools.product(SHAPES, CONNS, MODES))
BATCH_SHAPE, BATCH = (16, 12, 8), 3
BATCH_GROUPS = tuple(itertools.product(CONNS, MODES))
GRAPH_CASES = ("tet4_p4", "random40_p8", "strided48_p4_s1", "corpus3")
GRAPH_QUERIES = ("gather", "nogather")
GRAPH_GROUPS = tuple(itertools.product(GRAPH_CASES, MODES))
# every group as (kind, group); the grid groups first, so that a grid
# group's index is its index in GROUPS
ALL = (tuple(("grid", g) for g in GROUPS)
       + tuple(("batch", g) for g in BATCH_GROUPS)
       + tuple(("graph", g) for g in GRAPH_GROUPS))
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                   "jax_distributed_golden.npz")


def case_key(shape, conn, mode, query):
    return f"{'x'.join(map(str, shape))}__c{conn}__{mode}__{query}"


def batch_key(conn, mode, query):
    return f"batch__{case_key(BATCH_SHAPE, conn, mode, query)}"


def graph_key(case, mode, query):
    return f"graph__{case}__{mode}__{query}"


def inputs(shape):
    """(order int32 permutation, bool mask), seeded by the shape."""
    rng = np.random.default_rng(sum(shape))
    order = rng.permutation(int(np.prod(shape))).reshape(shape).astype(
        np.int32)
    return order, rng.random(shape) < MASK_P


def batch_inputs(shape=BATCH_SHAPE, b=BATCH):
    """(b, *shape) int32 order permutations and bool masks, seeded."""
    rng = np.random.default_rng(sum(shape) + 1)
    orders = np.stack([rng.permutation(int(np.prod(shape))).reshape(shape)
                       for _ in range(b)]).astype(np.int32)
    return orders, rng.random((b,) + shape) < MASK_P


def _record(out, key, labels, stats):
    out[f"{key}__labels"] = np.asarray(labels)
    for name, val in zip(stats._fields, stats):
        out[f"{key}__{name}"] = np.asarray(val)


def run_grid(group, out, queries, batch):
    import jax.numpy as jnp
    from repro.core import distributed as jd
    mesh = jd.make_dpc_mesh(LAYOUT)
    if batch:
        conn, mode = group
        (order, mask), shape = batch_inputs(), BATCH_SHAPE
        manifold = jd.distributed_manifold_batch
        cc = jd.distributed_connected_components_batch
    else:
        shape, conn, mode = group
        order, mask = inputs(shape)
        manifold = jd.distributed_manifold
        cc = jd.distributed_connected_components
    for query in queries:
        if query in ("desc", "asc"):
            labels, stats = manifold(jnp.asarray(order), mesh, conn,
                                     descending=query == "desc",
                                     table_mode=mode)
        else:
            labels, stats = cc(jnp.asarray(mask), mesh, conn,
                               gather_mask=query == "cc_gather",
                               table_mode=mode)
        key = (batch_key(conn, mode, query) if batch
               else case_key(shape, conn, mode, query))
        _record(out, key, labels, stats)


def run_graph(group, out, queries):
    """JAX's distributed graph program on one case (module docstring): the
    body of `distributed_connected_components_graph` up to its last
    scatter, which is done in numpy."""
    from functools import partial
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.core import distributed_graph as jg
    from repro.core._shardmap import shard_map_norep
    from repro.core.distributed import make_dpc_mesh
    from torch_dist_graph_ranks import graph_cases
    case, mode = group
    n, s, r, nparts, part, mask, _ = graph_cases()[case]
    dec = jg.GraphDecomp(n, s, r, nparts, part=part)
    mesh = make_dpc_mesh(nparts)
    name = mesh.axis_names[0]
    lgid = jnp.asarray(dec.local_gid, dtype=dec.id_dtype)
    local_mask = jnp.where(jnp.asarray(dec.local_valid),
                           jnp.asarray(mask)[jnp.clip(lgid, 0)], False)
    geom_args = jg._shard_geom_args(dec, mode)
    spec = P(name, None)
    for query in queries:
        fn = partial(jg._cc_partition, dec=dec, name=name,
                     gather_mask=query == "gather", table_mode=mode)
        mapped = shard_map_norep(
            fn, mesh, (spec,) * (7 + len(geom_args)),
            (spec, jg.GraphDPCStats(*([P()] * len(jg.GraphDPCStats._fields)))))
        owned, stats = mapped(
            local_mask, lgid, jnp.asarray(dec.local_ghost),
            jnp.asarray(dec.owned_lidx), jnp.asarray(dec.edge_src),
            jnp.asarray(dec.edge_dst), jnp.asarray(dec.cut_lidx), *geom_args)
        gid = dec.owned_gid.reshape(-1)
        labels = np.zeros(n, np.asarray(owned).dtype)
        labels[gid[gid < n]] = np.asarray(owned).reshape(-1)[gid < n]
        _record(out, graph_key(case, mode, query), labels, stats)


def run_group(index, path, queries=None):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    kind, group = ALL[index]
    out = {}
    if kind == "graph":
        run_graph(group, out, queries or GRAPH_QUERIES)
    else:
        run_grid(group, out, queries or QUERIES, kind == "batch")
    np.savez(path, **out)


def kinds_prefix(kind):
    """The record's key prefix of a kind's entries."""
    return {"grid": tuple(f"{'x'.join(map(str, sh))}__c" for sh in SHAPES),
            "batch": ("batch__",), "graph": ("graph__",)}[kind]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--group", type=int)
    ap.add_argument("--out")
    ap.add_argument("--queries")
    ap.add_argument("--kinds", default="grid,batch,graph")
    args = ap.parse_args()
    if args.group is not None:
        run_group(args.group, args.out,
                  tuple(args.queries.split(",")) if args.queries else None)
        return
    kinds = args.kinds.split(",")
    merged = {}
    if set(kinds) != {"grid", "batch", "graph"}:
        with np.load(OUT) as old:      # keep the other kinds' entries
            merged.update((k, v) for k, v in old.items()
                          if not k.startswith(tuple(
                              p for k2 in kinds for p in kinds_prefix(k2))))
    with tempfile.TemporaryDirectory() as tmp:
        todo = [i for i, (kind, _) in enumerate(ALL) if kind in kinds]
        parts = [os.path.join(tmp, f"{i}.npz") for i in todo]
        pending = list(todo)
        running = []
        while pending or running:
            while pending and len(running) < args.jobs:
                i = pending.pop(0)
                running.append(subprocess.Popen(
                    [sys.executable, __file__, "--group", str(i),
                     "--out", parts[todo.index(i)]]))
            proc = running.pop(0)
            if proc.wait() != 0:
                sys.exit(f"a group failed: {proc.args}")
        for shape in SHAPES:
            order, mask = inputs(shape)
            merged[f"{'x'.join(map(str, shape))}__order"] = order
            merged[f"{'x'.join(map(str, shape))}__mask"] = mask
        merged["batch__orders"], merged["batch__masks"] = batch_inputs()
        for p in parts:
            with np.load(p) as part:
                merged.update(part)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **merged)
    print(f"wrote {len(merged)} arrays to {OUT}")


if __name__ == "__main__":
    main()

"""Rank side of `tests/test_torch_distributed_graph.py`: one gloo group of 8
CPU ranks runs the port's distributed graph backend on every case and
writes its labels and stats to `<out>/rank<r>.pt`.

    python tests/torch_dist_graph_ranks.py RANK WORLD STORE_FILE OUT_DIR

Imports torch and the port only (no jax).  A case of P partitions runs on
the `dist.new_group` subgroup of ranks 0..P-1, which every rank creates in
the same order; rank p runs partition p and records its own labels.  The
cases (`graph_cases`) are made from seeds with numpy, the same way on every
rank, in the test and in `tests/jax_distributed_golden.py`.
"""
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

from oracles import GRAPH_SEED_CORPUS, ragged_graph_case

WORLD = 8
MODES = ("replicated", "sharded")
GATHER = (True, False)
THRESHOLDS = (0.3, 0.6, 0.9)
# partial permutations over the 8 ranks: rank 0 sends and receives, 1
# sends and receives, 2 and 7 only receive, 3 and 5 only send, 4 sends to
# itself, 6 does neither; then the empty permutation
PERMUTES = (((0, 1), (1, 2), (3, 0), (5, 7), (4, 4)), ())


def _edges(shape, conn):
    from repro_torch.data import grid_edge_list
    s, r = grid_edge_list(shape, conn, device="cpu")
    return s.numpy(), r.numpy()


def graph_cases():
    """{name: (n, senders, receivers, nparts, part or None, mask, field)}:
    the ragged corpus (`oracles.ragged_graph_case`) and the test graphs of
    the JAX package's `tests/test_distributed_graph_cc.py`: the 4^3 tet
    edge list at 1, 2, 4 and 8 parts (a random mask and mask = ones), the
    16-vertex path graph with masks whose components end on the cuts, the
    strided partition of an 8x6 grid, and a random multigraph with
    duplicate and self edges over 8 parts.  `field` (float32) drives the
    threshold sweeps."""
    out = {}

    def add(name, n, s, r, nparts, part, mask):
        field = np.random.default_rng(len(out)).random(n, dtype=np.float32)
        out[name] = (n, s, r, nparts, part, np.asarray(mask, bool), field)

    for seed in GRAPH_SEED_CORPUS:
        n, s, r, nparts, part, mask = ragged_graph_case(seed)
        add(f"corpus{seed}", n, s, r, nparts, part, mask)
    s3, r3 = _edges((4, 4, 4), 14)
    rng = np.random.default_rng(0)
    for nparts in (1, 2, 4, 8):
        add(f"tet4_p{nparts}", 64, s3, r3, nparts, None, rng.random(64) < 0.6)
        add(f"tet4_p{nparts}_geometry", 64, s3, r3, nparts, None,
            np.ones(64, bool))
    sp, rp = _edges((16,), 2)
    cutsplit = np.ones(16, bool)
    cutsplit[[4, 8]] = False
    onecut = np.zeros(16, bool)
    onecut[3:5] = True
    for nparts in (2, 4):
        add(f"path16_p{nparts}_merge", 16, sp, rp, nparts, None,
            np.ones(16, bool))
        add(f"path16_p{nparts}_split", 16, sp, rp, nparts, None, cutsplit)
    add("path16_p4_straddle", 16, sp, rp, 4, None, onecut)
    s2, r2 = _edges((8, 6), 6)
    part = (np.arange(48) % 4).astype(np.int64)
    for seed in (1, 2):
        add(f"strided48_p4_s{seed}", 48, s2, r2, 4, part,
            np.random.default_rng(seed).random(48) < 0.6)
    rng = np.random.default_rng(7)
    a, b = rng.integers(0, 40, 120), rng.integers(0, 40, 120)
    add("random40_p8", 40, np.concatenate([a, b]), np.concatenate([b, a]), 8,
        None, rng.random(40) < 0.55)
    return out


def batch_masks(case):
    """(3, n) masks of a case's batch: its mask, the complement, ones."""
    mask = case[5]
    return np.stack([mask, ~mask, np.ones_like(mask)])


def collective_checks(rank):
    """`DPCMesh.permute` on the world group at `PERMUTES`, int32 and bool
    payloads, and the ValueError for a repeated source.  Returns {name:
    list}."""
    from repro_torch.core.distributed import make_dpc_mesh
    mesh = make_dpc_mesh(WORLD, device="cpu")
    out = {}
    for i, pairs in enumerate(PERMUTES):
        x = torch.tensor([rank + 1, -10 * rank], dtype=torch.int32)
        out[f"permute{i}"] = mesh.permute(x, pairs).tolist()
        out[f"permute_bool{i}"] = mesh.permute(
            torch.tensor([rank % 2 == 0, True]), pairs).tolist()
    try:
        mesh.permute(torch.zeros(1), ((0, 1), (0, 2)))
        out["repeated_source"] = "none"
    except ValueError as e:
        out["repeated_source"] = str(e)
    return out


def counted(mesh):
    """Wrap the mesh's collectives with call counters; returns the dict."""
    counts = {"shift": 0, "permute": 0, "all_gather": 0, "all_reduce": 0}
    for name in counts:
        def wrapped(*args, _f=getattr(mesh, name), _name=name, **kw):
            counts[_name] += 1
            return _f(*args, **kw)
        setattr(mesh, name, wrapped)
    return counts


def main(rank, world, store, out_dir):
    from repro_torch.core.distributed import make_dpc_mesh
    from repro_torch.core.distributed_graph import (
        GraphDecomp, distributed_connected_components_graph,
        distributed_connected_components_graph_batch)
    from repro_torch.topology import TopologyRequest, submit
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    cases = graph_cases()
    groups = {p: dist.new_group(list(range(p))) if p < world else None
              for p in sorted({c[3] for c in cases.values()})}
    results = {"collectives": collective_checks(rank)}

    def record(key, labels, stats, counts=None):
        results[key] = {"labels": labels.cpu(),
                        "stats": dict(zip(stats._fields, stats)),
                        "counts": counts}

    for name, (n, s, r, nparts, part, mask, field) in cases.items():
        if rank >= nparts:
            continue
        mesh = make_dpc_mesh(nparts, group=groups[nparts], device="cpu")
        counts = counted(mesh)
        dec = GraphDecomp(n, s, r, nparts, part=part)
        m = torch.from_numpy(mask)
        masks = torch.from_numpy(batch_masks(cases[name]))
        for mode in MODES:
            for gm in GATHER:
                key = f"{name}|{mode}|{gm}"
                for k in counts:
                    counts[k] = 0
                record(key, *distributed_connected_components_graph(
                    m, dec, mesh, gather_mask=gm, table_mode=mode),
                    dict(counts))
                for b in range(len(masks)):
                    for k in counts:
                        counts[k] = 0
                    record(f"{key}|item{b}",
                           *distributed_connected_components_graph(
                               masks[b], dec, mesh, gather_mask=gm,
                               table_mode=mode), dict(counts))
                for k in counts:
                    counts[k] = 0
                record(f"{key}|batch",
                       *distributed_connected_components_graph_batch(
                           masks, dec, mesh, gather_mask=gm,
                           table_mode=mode), dict(counts))
            # the facade's two graph routes
            edges = dict(domain="graph", backend="distributed", mesh=mesh,
                         decomp=dec, senders=s, receivers=r, table_mode=mode)
            res = submit(TopologyRequest("cc", mask=mask, **edges))
            results[f"{name}|{mode}|facade cc"] = {
                "labels": res.labels, "stats": res.stats}
            for thr in (THRESHOLDS, ()):
                res = submit(TopologyRequest(
                    "threshold_sweep", field=field,
                    thresholds=np.asarray(thr, np.float32), **edges))
                results[f"{name}|{mode}|facade sweep{len(thr)}"] = {
                    "labels": res.labels, "stats": res.stats}
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    r, w, store_file, out = sys.argv[1:5]
    try:
        main(int(r), int(w), store_file, out)
    except BaseException:
        with open(os.path.join(out, f"rank{r}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise

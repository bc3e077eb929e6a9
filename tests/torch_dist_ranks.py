"""Rank side of `tests/test_torch_distributed.py`: one gloo group of 8 CPU
ranks runs the port's distributed grid backend on every case (single calls,
batches with their items' single calls and the collectives each issues,
and the `topology.submit` routes) and writes its blocks of labels and its
stats to `<out>/rank<r>.pt`.

    python tests/torch_dist_ranks.py RANK WORLD STORE_FILE OUT_DIR

Imports torch and the port only (no jax).  Layouts of fewer ranks run on
`dist.new_group` subgroups of ranks 0..P-1, which every rank creates in the
same order.  The inputs are made from seeds with numpy, the same way on
every rank and in the test; each rank cuts its own block of them.
"""
import math
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

from jax_distributed_golden import batch_inputs
from oracles import GRID_SEED_CORPUS, ragged_grid_case
from torch_dist_graph_ranks import counted

WORLD = 8
RAGGED = (97, 61, 43)
RAGGED_MASK_P = 0.3
QUERIES = ("desc", "asc", "cc_gather", "cc_nogather")
MODES = ("replicated", "sharded")
GOLDEN_SHAPES = ((16, 16, 16), (16, 12, 8))
GOLDEN_MASK_P = 0.6
# batches over (2, 2, 2): (name, shape, B, connectivities); the 16x12x8
# batch is `jax_distributed_golden.batch_inputs`, the ragged one its
# generator's first B items at that extent
BATCHES = (("16x12x8", (16, 12, 8), 3, (6, 26)), ("x".join(map(
    str, RAGGED)), RAGGED, 2, (6,)))
SWEEP = (0.25, 0.5, 0.75)


def grid_cases():
    """(name, shape, layout, connectivities, mask_p, seed): the ragged
    corpus and 97x61x43 over (2, 2, 2).  Connectivity 6 and 26 in 3-D, 4
    and 6 (the 2-D table's two) in 2-D."""
    out = []
    for seed in GRID_SEED_CORPUS:
        shape, layout, _, mask_p = ragged_grid_case(seed)
        conns = (4, 6) if len(shape) == 2 else (6, 26)
        out.append((f"corpus{seed}", shape, layout, conns, mask_p, seed))
    out.append(("x".join(map(str, RAGGED)), RAGGED, (2, 2, 2), (6, 26),
                RAGGED_MASK_P, 97))
    return out


def grid_inputs(shape, mask_p, seed):
    """(order int32 permutation, bool mask) of a case, seeded."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(int(np.prod(shape))).reshape(shape).astype(
        np.int32)
    return order, rng.random(shape) < mask_p


def golden_inputs(shape):
    """The inputs of `tests/jax_distributed_golden.py` (the file also holds
    them; the test checks that they agree)."""
    rng = np.random.default_rng(sum(shape))
    order = rng.permutation(int(np.prod(shape))).reshape(shape).astype(
        np.int32)
    return order, rng.random(shape) < GOLDEN_MASK_P


def sweep_field(shape, seed):
    """The float32 field of a case's threshold sweep, seeded."""
    return np.random.default_rng(seed + 1).random(shape, dtype=np.float32)


def run_query(query, block, mesh, shape, conn, mode, fused_impl="auto",
              batch=False):
    from repro_torch.core import distributed as d
    if query in ("desc", "asc"):
        fn = d.distributed_manifold_batch if batch else d.distributed_manifold
        return fn(block[0], mesh, shape, conn, descending=query == "desc",
                  fused_impl=fused_impl, table_mode=mode)
    fn = (d.distributed_connected_components_batch if batch
          else d.distributed_connected_components)
    return fn(block[1], mesh, shape, conn, gather_mask=query == "cc_gather",
              fused_impl=fused_impl, table_mode=mode)


def batch_runs(rank, record):
    """Each batch of `BATCHES` in both modes through the four queries with
    fused_impl "ref" (JAX's CPU path), and each of its items alone, with
    the collectives each call issued."""
    from repro_torch.core.distributed import BlockDecomp, make_dpc_mesh
    mesh = make_dpc_mesh((2, 2, 2), device="cpu")
    counts = counted(mesh)
    for name, shape, b, conns in BATCHES:
        sl = (slice(None),) + BlockDecomp(shape, mesh.layout,
                                          mesh.names).block_slices(
                                              mesh.coords)
        orders, masks = batch_inputs(shape, b)
        block = (torch.from_numpy(orders[sl].copy()),
                 torch.from_numpy(masks[sl].copy()))
        for conn in conns:
            for mode in MODES:
                for query in QUERIES:
                    key = f"batch|{name}|{conn}|{mode}|{query}"
                    for item in [None] + list(range(b)):
                        for k in counts:
                            counts[k] = 0
                        x = block if item is None else tuple(
                            t[item] for t in block)
                        labels, stats = run_query(
                            query, x, mesh, shape, conn, mode, "ref",
                            batch=item is None)
                        record(key if item is None else f"{key}|item{item}",
                               labels, stats, dict(counts))


def facade_runs(groups, rank, record):
    """`topology.submit(backend="distributed")` on every case at its first
    connectivity, both modes: cc, both manifolds, ms, and a threshold
    sweep over `SWEEP` and over no threshold, each rank passing its
    block."""
    from repro_torch.core.distributed import BlockDecomp, make_dpc_mesh
    from repro_torch.topology import TopologyRequest, submit
    for name, shape, layout, conns, mask_p, seed in grid_cases():
        if rank >= math.prod(layout):
            continue
        mesh = make_dpc_mesh(layout, group=groups[math.prod(layout)],
                             device="cpu")
        sl = BlockDecomp(shape, mesh.layout, mesh.names).block_slices(
            mesh.coords)
        order, mask = grid_inputs(shape, mask_p, seed)
        field = sweep_field(shape, seed)[sl]
        for mode in MODES:
            req = dict(backend="distributed", mesh=mesh, grid_shape=shape,
                       connectivity=conns[0], table_mode=mode)
            out = {"cc": submit(TopologyRequest("cc", mask=mask[sl], **req)),
                   "ms": submit(TopologyRequest("ms", order=order[sl],
                                                **req))}
            for desc in (True, False):
                out[f"manifold{desc}"] = submit(TopologyRequest(
                    "manifold", order=order[sl], descending=desc, **req))
            for thr in (SWEEP, ()):
                out[f"sweep{len(thr)}"] = submit(TopologyRequest(
                    "threshold_sweep", field=field,
                    thresholds=np.asarray(thr, np.float32), **req))
            for query, res in out.items():
                record(f"facade|{name}|{conns[0]}|{mode}|{query}", res)


def collective_checks(groups, rank):
    """Unit cases of the three collectives: axis shifts at layout 2 and 4
    (mesh (2, 4)) and 8 (mesh 8), edge fill included, the all-gather's rank
    order and the three reductions.  Returns {name: list}."""
    from repro_torch.core.distributed import make_dpc_mesh
    out = {}
    for layout in ((2, 4), 8):
        mesh = make_dpc_mesh(layout, device="cpu")
        me = torch.tensor([rank, -rank], dtype=torch.int32)
        for a in range(len(mesh.layout)):
            prev, nxt = mesh.shift(a, to_next=me, to_prev=me + 100, fill=-7)
            out[f"shift{mesh.layout}/{a}"] = prev.tolist() + nxt.tolist()
        flags = torch.tensor([rank % 3 == 0, True])
        fp, fn = mesh.shift(0, to_next=flags, to_prev=~flags, fill=False)
        out[f"shift_bool{mesh.layout}"] = fp.tolist() + fn.tolist()
    mesh = make_dpc_mesh((2, 2, 2), device="cpu")
    out["all_gather"] = mesh.all_gather(
        torch.tensor([rank, 10 * rank], dtype=torch.int32)).tolist()
    out["all_gather_bool"] = mesh.all_gather(
        torch.tensor([rank % 2 == 1])).reshape(-1).tolist()
    out["reduce"] = [mesh.all_reduce([rank, -rank], op) for op in
                     (dist.ReduceOp.MAX, dist.ReduceOp.MIN,
                      dist.ReduceOp.SUM)]
    sub = make_dpc_mesh(4, group=groups[4], device="cpu") if rank < 4 \
        else None
    if sub is not None:
        out["subgroup_gather"] = sub.all_gather(
            torch.tensor([rank], dtype=torch.int32)).reshape(-1).tolist()
    return out


def failure_checks(rank):
    """What the reference raises: check_converged on every rank when the
    table fixpoint is cut at table_max_iter=1 (97x61x43 over (2, 2, 2)), in
    both modes; and, without CUDA, the default device.  Returns {name:
    what happened}."""
    from repro_torch.core.distributed import (BlockDecomp,
                                              distributed_manifold,
                                              make_dpc_mesh)
    mesh = make_dpc_mesh((2, 2, 2), device="cpu")
    order, _ = grid_inputs(RAGGED, RAGGED_MASK_P, 97)
    sl = BlockDecomp(RAGGED, mesh.layout, mesh.names).block_slices(
        mesh.coords)
    raised = []
    for mode in MODES:
        try:
            distributed_manifold(torch.from_numpy(order[sl].copy()), mesh,
                                 RAGGED, 6, table_mode=mode, table_max_iter=1)
        except RuntimeError as e:
            if "did not reach its fixpoint" in str(e):
                raised.append(mode)
    try:
        make_dpc_mesh((2, 2, 2))
        device = "none"
    except RuntimeError as e:
        device = type(e).__name__ if "no CUDA device" in str(e) else str(e)
    return {"not_converged": raised, "default_device": device}


def main(rank, world, store, out_dir):
    from repro_torch.core.distributed import BlockDecomp, make_dpc_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    cases = grid_cases()
    sizes = sorted({math.prod(c[2]) for c in cases} | {4})
    groups = {p: dist.new_group(list(range(p))) if p < world else None
              for p in sizes}
    results = {"collectives": {**collective_checks(groups, rank),
                               **failure_checks(rank)}}

    def record(key, labels, stats, counts=None):
        results[key] = {"labels": labels.cpu(),
                        "stats": dict(zip(stats._fields, stats)),
                        "counts": counts}

    def record_result(key, res):
        results[key] = {f: getattr(res, f) for f in (
            "labels", "ascending", "descending", "segmentation", "stats",
            "meta")}

    for name, shape, layout, conns, mask_p, seed in cases:
        if rank >= math.prod(layout):
            continue
        mesh = make_dpc_mesh(layout, group=groups[math.prod(layout)],
                             device="cpu")
        sl = BlockDecomp(shape, mesh.layout, mesh.names).block_slices(
            mesh.coords)
        order, mask = grid_inputs(shape, mask_p, seed)
        block = (torch.from_numpy(order[sl].copy()),
                 torch.from_numpy(mask[sl].copy()))
        for conn in conns:
            for mode in MODES:
                for query in QUERIES:
                    record(f"{name}|{conn}|{mode}|{query}",
                           *run_query(query, block, mesh, shape, conn, mode))

    mesh = make_dpc_mesh((2, 2, 2), device="cpu")
    for shape in GOLDEN_SHAPES:
        sl = BlockDecomp(shape, mesh.layout, mesh.names).block_slices(
            mesh.coords)
        order, mask = golden_inputs(shape)
        block = (torch.from_numpy(order[sl].copy()),
                 torch.from_numpy(mask[sl].copy()))
        name = "x".join(map(str, shape))
        for conn in (6, 26):
            for mode in MODES:
                for query in QUERIES:
                    for impl in ("ref", "auto"):
                        record(f"{name}|{conn}|{mode}|{query}|{impl}",
                               *run_query(query, block, mesh, shape, conn,
                                          mode, fused_impl=impl))
    batch_runs(rank, record)
    facade_runs(groups, rank, record_result)
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

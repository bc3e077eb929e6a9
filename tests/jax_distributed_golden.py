"""Writes `tests/data/jax_distributed_golden.npz`: the JAX package's
`distributed_manifold` and `distributed_connected_components` on 8 virtual
CPU devices over a (2, 2, 2) mesh, for `tests/test_torch_distributed.py`.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/jax_distributed_golden.py

Cases: 16^3 and 16x12x8 (divisible extents), connectivity 6 and 26, both
table modes; the descending and ascending manifolds of a seeded order
field, and connected components of a seeded mask with the mask gathered
and not.  Each case runs with the block-local phase's `fused_impl="auto"`
(on the CPU the JAX package's init-only path).  The file holds the inputs,
the labels and every `DPCStats` field in its JAX dtype.

Each entry point compiles its shard_map program anew on every call (about
30 s a call on one CPU core, so about 30 minutes for the 32 cases in one
process), which is why the test reads this file and does not run them
itself.  `--jobs N` runs the (shape, connectivity, mode) groups in N worker
processes; `--group I` runs one group and writes its part, `--queries`
(comma-separated) only some of its queries.
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
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                   "jax_distributed_golden.npz")


def case_key(shape, conn, mode, query):
    return f"{'x'.join(map(str, shape))}__c{conn}__{mode}__{query}"


def inputs(shape):
    """(order int32 permutation, bool mask), seeded by the shape."""
    rng = np.random.default_rng(sum(shape))
    order = rng.permutation(int(np.prod(shape))).reshape(shape).astype(
        np.int32)
    return order, rng.random(shape) < MASK_P


def run_group(index, path, queries=QUERIES):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax.numpy as jnp
    from repro.core.distributed import (make_dpc_mesh, distributed_manifold,
                                        distributed_connected_components)
    shape, conn, mode = GROUPS[index]
    mesh = make_dpc_mesh(LAYOUT)
    order, mask = inputs(shape)
    out = {}
    for query in queries:
        if query in ("desc", "asc"):
            labels, stats = distributed_manifold(
                jnp.asarray(order), mesh, conn, descending=query == "desc",
                table_mode=mode)
        else:
            labels, stats = distributed_connected_components(
                jnp.asarray(mask), mesh, conn,
                gather_mask=query == "cc_gather", table_mode=mode)
        key = case_key(shape, conn, mode, query)
        out[f"{key}__labels"] = np.asarray(labels)
        for name, val in zip(stats._fields, stats):
            out[f"{key}__{name}"] = np.asarray(val)
    np.savez(path, **out)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--group", type=int)
    ap.add_argument("--out")
    ap.add_argument("--queries", default=",".join(QUERIES))
    args = ap.parse_args()
    if args.group is not None:
        run_group(args.group, args.out, tuple(args.queries.split(",")))
        return
    with tempfile.TemporaryDirectory() as tmp:
        parts = [os.path.join(tmp, f"{i}.npz") for i in range(len(GROUPS))]
        pending = list(range(len(GROUPS)))
        running = []
        while pending or running:
            while pending and len(running) < args.jobs:
                i = pending.pop(0)
                running.append(subprocess.Popen(
                    [sys.executable, __file__, "--group", str(i),
                     "--out", parts[i]]))
            proc = running.pop(0)
            if proc.wait() != 0:
                sys.exit(f"a group failed: {proc.args}")
        merged = {}
        for shape in SHAPES:
            order, mask = inputs(shape)
            merged[f"{'x'.join(map(str, shape))}__order"] = order
            merged[f"{'x'.join(map(str, shape))}__mask"] = mask
        for p in parts:
            with np.load(p) as part:
                merged.update(part)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **merged)
    print(f"wrote {len(merged)} arrays to {OUT}")


if __name__ == "__main__":
    main()

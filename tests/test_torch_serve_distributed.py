"""The port's serving engine on the distributed backend, on the CPU.

One gloo group of 4 CPU ranks, layout (2, 2) as in JAX's distributed serve
workers, runs `tests/torch_serve_ranks.py` once for the module.  Every rank
holds each engine result to the port's facade (`topology.submit`, labels
and stats): the sync engine on JAX's engine-vs-facade workload and the
async engine on a `VirtualClock` on JAX's async workload, the port's
synthetic workload in both table modes, and a ragged ascending manifold
(13x11x7, so the flip must take the global vertex count).  JAX's own
distributed serve tests fail under jax 0.9.0 (ROADMAP Queue 3 item 6); the
facade is held to JAX by `tests/test_torch_distributed.py`.  Here the
ragged ascending labels, gathered from the ranks, are also held to JAX's
pure `ascending_manifold`.

The rank script names its checks (`CHECKS`); each is a test here, and
passes when every rank recorded True: a request with `table_max_iter=1`
fails alone with a RuntimeError naming `max_iter`, distributed grid items
bucket by their exact global extent (two extents that share a JAX layout
take one bucket each), and the async engine raises ValueError for a
multi-rank request unless its clock is a `VirtualClock` with no execution
time charged, while a one-rank mesh serves on any clock.
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

from torch_serve_ranks import (CHECKS, LAYOUT, RAGGED, RAGGED_SEED, WORLD)

from repro.core.ms_segmentation import ascending_manifold, ms_segmentation
from repro_torch.core.distributed import BLOCK_AXES, BlockDecomp

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "..", "src")
RANKS_TIMEOUT_S = 600


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("serve_ranks")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [_SRC, _HERE, os.environ.get("PYTHONPATH", "")]))
    logs = [open(out / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(_HERE, "torch_serve_ranks.py"), str(r),
         str(WORLD), str(out / "store"), str(out)], env=env, stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(WORLD)]
    try:
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
    return [torch.load(out / f"rank{r}.pt", weights_only=True)
            for r in range(WORLD)]


@pytest.mark.parametrize("name", CHECKS)
def test_rank_check(ranks, name):
    bad = {r: out["checks"][name] for r, out in enumerate(ranks)
           if out["checks"][name] is not True}
    assert not bad, bad


def _gathered(ranks, key):
    dec = BlockDecomp(RAGGED, LAYOUT, BLOCK_AXES[:len(LAYOUT)])
    out = np.full(RAGGED, -2, np.int64)
    for r, res in enumerate(ranks):
        block = res["ragged"][key]
        assert block.dtype == torch.int32
        out[dec.block_slices(np.unravel_index(r, LAYOUT))] = block.numpy()
    return out


@pytest.fixture(scope="module")
def ragged_jax():
    rng = np.random.default_rng(RAGGED_SEED)
    order = rng.permutation(math.prod(RAGGED)).reshape(RAGGED).astype(
        np.int32)
    asc = np.asarray(ascending_manifold(jnp.asarray(order), 6)[0])
    seg = np.asarray(ms_segmentation(jnp.asarray(order), 6).segmentation)
    return {"ascending": asc.reshape(RAGGED), "ms_ascending":
            asc.reshape(RAGGED), "ms_segmentation": seg.reshape(RAGGED)}


@pytest.mark.parametrize("key", ["ascending", "ms_ascending",
                                 "ms_segmentation"])
def test_ragged_ascending_gathered_equals_jax_pure(ranks, ragged_jax, key):
    np.testing.assert_array_equal(_gathered(ranks, key), ragged_jax[key])

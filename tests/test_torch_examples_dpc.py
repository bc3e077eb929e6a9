"""The port's example twins `examples/quickstart_torch.py` and
`examples/graph_cc_torch.py` with `--device cpu`, against JAX's
single-device labels.

JAX's own examples raise in their distributed calls under jax 0.9.0
(ROADMAP.md Queue 3), so the twins' labels -- single-device and assembled
from their gloo ranks' blocks and partitions -- are held to JAX's pure
path on the same Perlin field: `ms_segmentation` (descending manifold),
`connected_components_grid` of the top-10% mask, the ragged 31^3 crop's
descending manifold, and `connected_components_graph` of the tet mesh with
the mask and with mask = ones.  One subprocess, started once for the
module, runs each twin's `main` in turn (quickstart on 8 and 4 ranks,
graph CC on 8 and on 3, two of which hold a partition) -- each spawns its
ranks with `torch.multiprocessing` -- and writes what each returned to an
.npz file.  The twins' round counts are the port's kernel path's (JAX's
`fused_impl="kernel"`), not JAX's CPU default (its init-only path), so
only labels are compared.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp

from repro.core import compute_order
from repro.core.connected_components import (connected_components_graph,
                                             connected_components_grid)
from repro.core.ms_segmentation import ms_segmentation
from repro.data import grid_edge_list, perlin_noise

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.join(_HERE, "..")
TIMEOUT_S = 240


RUNS = (("quickstart_torch", 8), ("quickstart_torch", 4),
        ("graph_cc_torch", 8), ("graph_cc_torch", 3))


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    """{(example, ranks): (what main returned, its stdout)}."""
    out = tmp_path_factory.mktemp("twins")
    code = "\n".join([
        "import contextlib, io, numpy as np",
        "import graph_cc_torch, quickstart_torch",
        f"for name, ranks in {RUNS!r}:",
        "    buf = io.StringIO()",
        "    with contextlib.redirect_stdout(buf):",
        "        got = globals()[name].main(['--device', 'cpu', '--ranks',",
        "                                    str(ranks)])",
        f"    np.savez({str(out)!r} + f'/{{name}}_{{ranks}}.npz', **got)",
        f"    open({str(out)!r} + f'/{{name}}_{{ranks}}.txt', 'w').write(",
        "        buf.getvalue())"])
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [os.path.join(_ROOT, "src"), os.path.join(_ROOT, "examples"),
         os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return {(name, ranks): (dict(np.load(out / f"{name}_{ranks}.npz")),
                            (out / f"{name}_{ranks}.txt").read_text())
            for name, ranks in RUNS}


@pytest.fixture(scope="module")
def grid_ref():
    field = perlin_noise((32, 32, 32), frequency=0.1, seed=42)
    order = compute_order(jnp.asarray(field))
    mask = jnp.asarray(field > np.quantile(field, 0.9))
    rorder = compute_order(jnp.asarray(np.asarray(field)[:31, :31, :31]))
    return {"descending": np.asarray(ms_segmentation(order, 6).descending),
            "labels": np.asarray(connected_components_grid(mask, 6).labels),
            "ragged": np.asarray(ms_segmentation(rorder, 6).descending)}


@pytest.mark.parametrize("ranks", [8, 4])
def test_quickstart_twin_gives_jax_single_device_labels(twins, grid_ref,
                                                        ranks):
    got, stdout = twins["quickstart_torch", ranks]
    for key in ("descending", "slab_descending", "block_descending"):
        np.testing.assert_array_equal(got[key].reshape(-1),
                                      grid_ref["descending"].reshape(-1))
    for key in ("labels", "slab_labels", "block_labels"):
        np.testing.assert_array_equal(got[key], grid_ref["labels"])
    for key in ("ragged_ref", "ragged_descending"):
        np.testing.assert_array_equal(got[key].reshape(-1),
                                      grid_ref["ragged"].reshape(-1))
    tag = {8: "2x2x2", 4: "2x2"}[ranks]
    lines = stdout.splitlines()
    assert any(l.startswith(f"DPC on {ranks} slab(s): identical labels")
               for l in lines)
    assert any(l.startswith(f"DPC on {tag} blocks: identical labels")
               for l in lines)
    assert any(l.startswith("DPC on a ragged 31x31x31 grid over "
                            f"{ranks} device(s): identical labels")
               and l.endswith("still 1 exchange phase") for l in lines)


@pytest.fixture(scope="module")
def graph_ref():
    shape = (16, 16, 16)
    senders, receivers = grid_edge_list(shape, connectivity=14)
    field = perlin_noise(shape, frequency=0.1, seed=42)
    mask = jnp.asarray((field > np.quantile(field, 0.9)).ravel())
    s, r = jnp.asarray(senders), jnp.asarray(receivers)
    return {"labels": np.asarray(connected_components_graph(mask, s, r)
                                 .labels),
            "geometry": np.asarray(connected_components_graph(
                jnp.ones(mask.shape, bool), s, r).labels)}


@pytest.mark.parametrize("ranks,nparts", [(8, 8), (3, 2)])
def test_graph_cc_twin_gives_jax_single_device_labels(twins, graph_ref,
                                                      ranks, nparts):
    got, stdout = twins["graph_cc_torch", ranks]
    for key in ("labels", "distributed_labels"):
        np.testing.assert_array_equal(got[key], graph_ref["labels"])
    for key in ("geometry", "distributed_geometry"):
        np.testing.assert_array_equal(got[key], graph_ref["geometry"])
    assert (f"distributed over {nparts} partition(s): identical labels; 1 "
            f"all_gather phase") in stdout
    assert "pure-geometry CC (mask=ones): identical labels" in stdout

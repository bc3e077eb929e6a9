"""Distributed unstructured CC on the PyTorch/CUDA port (the twin of
`examples/graph_cc.py`): the paper's graph path in 60 seconds.

Builds a synthetic tet-mesh-style edge list (the Freudenthal
tetrahedralization of a Perlin-noise grid, treated as a fully unstructured
mesh), labels the thresholded connected components on one device, then
vertex-partitions the mesh over `--ranks` processes with GraphDecomp (one
partition a `torch.distributed` gloo rank: on the CPU with `--device cpu`,
sharing the card otherwise) and checks the distributed labels are
bit-identical -- with exactly one all_gather communication phase (paper
Alg. 2's budget):

  PYTHONPATH=src python examples/graph_cc_torch.py [--device cpu] \\
      [--ranks 8]

`main` returns the labels (numpy): single-device and distributed, for the
top-10% mask and for mask = ones.
"""
import argparse
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch._device import resolve_device  # noqa: E402
from repro_torch.core import (GraphDecomp,  # noqa: E402
                              assemble_graph_labels,
                              connected_components_graph)
from repro_torch.data import grid_edge_list, perlin_noise  # noqa: E402

SHAPE = (16, 16, 16)


def _parts(n, ranks):
    return max(d for d in range(1, ranks + 1) if n % d == 0)


def _rank(rank, world, tmp, device):
    """Partition `rank`'s process: cc of the mask and of ones over the
    partitions, its labels and stats written to `tmp`."""
    import torch.distributed as dist
    from repro_torch.core import (distributed_connected_components_graph,
                                  make_dpc_mesh)

    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            world_size=world, rank=rank)
    inp = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=True)
    n = inp["mask"].numel()
    nparts = _parts(n, world)
    group = dist.new_group(list(range(nparts)))      # every rank makes it
    out = {}
    if rank < nparts:
        dec = GraphDecomp(n, inp["senders"].numpy(), inp["receivers"].numpy(),
                          nparts)
        mesh = make_dpc_mesh(nparts, group=group, device=dev)
        for name, mask in (("mask", inp["mask"]),
                           ("ones", torch.ones(n, dtype=torch.bool))):
            got, stats = distributed_connected_components_graph(
                mask.to(dev), dec, mesh)
            out[name] = (got.cpu(), stats.as_dict())
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    ap.add_argument("--ranks", type=int, default=2,
                    help="processes of the distributed run, a partition each")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # --- the mesh: a tet-mesh-style edge list over a Perlin field ----------
    shape = SHAPE
    n = int(np.prod(shape))
    senders, receivers = grid_edge_list(shape, connectivity=14, device=dev)
    field = perlin_noise(shape, frequency=0.1, seed=42, device=dev)
    host = field.cpu().numpy()
    mask = torch.from_numpy((host > np.quantile(host, 0.9)).ravel()).to(dev)
    print(f"tet-style mesh: {n} vertices, {senders.numel()} directed edges, "
          f"{int(mask.sum())} masked (top 10%)")

    # --- single-device oracle (paper Alg. 3 on graphs) ---------------------
    ref = connected_components_graph(mask, senders, receivers)
    labels = ref.labels.cpu().numpy()
    n_comp = len(np.unique(labels[labels >= 0]))
    print(f"single device: {n_comp} components "
          f"({int(ref.n_rounds)} stitch rounds)")
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    g_ref = connected_components_graph(ones, senders, receivers)

    # --- distributed: vertex partition, one process a partition ------------
    nparts = _parts(n, args.ranks)
    tmp = tempfile.mkdtemp(prefix="graph_cc_torch_")
    try:
        torch.save({"mask": mask.cpu(), "senders": senders.cpu(),
                    "receivers": receivers.cpu()},
                   os.path.join(tmp, "inputs.pt"))
        torch.multiprocessing.spawn(_rank, args=(args.ranks, tmp, str(dev)),
                                    nprocs=args.ranks)
        parts = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=True) for r in range(nparts)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    dec = GraphDecomp(n, senders.cpu().numpy(), receivers.cpu().numpy(),
                      nparts)
    got = {"labels": labels, "geometry": g_ref.labels.cpu().numpy()}
    got["distributed_labels"] = assemble_graph_labels(
        [p["mask"][0] for p in parts], dec).numpy()
    assert (got["distributed_labels"] == labels).all(), \
        "labels must be bit-identical"
    stats = parts[0]["mask"][1]
    print(f"distributed over {nparts} partition(s): identical labels; "
          f"{int(stats['comm_phases'])} all_gather phase, "
          f"{int(stats['ghost_bytes']):,} cut-table bytes, "
          f"{int(stats['table_iters'])} table rounds")

    # --- pure geometry (no scalar data): mask = ones -----------------------
    got["distributed_geometry"] = assemble_graph_labels(
        [p["ones"][0] for p in parts], dec).numpy()
    assert (got["distributed_geometry"] == got["geometry"]).all()
    print("pure-geometry CC (mask=ones): identical labels")
    return got


if __name__ == "__main__":
    main()

"""Quickstart on the PyTorch/CUDA port (the twin of `examples/quickstart.py`):
the paper in 60 seconds.

Computes the Morse-Smale segmentation and thresholded connected components
of a 3D Perlin-noise field (the paper's dataset), first on one device,
then distributed with DPC (Alg. 1+2) over `--ranks` processes, one block
each (`torch.distributed` gloo ranks: on the CPU with `--device cpu`,
sharing the card otherwise) -- on slabs, on an N-D block lattice and on a
ragged grid -- and checks that they agree bit for bit:

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu] \\
      [--ranks 8]

`main` returns the labels (numpy): the single-device results and the
distributed ones assembled from the ranks' blocks.
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
from repro_torch.core import (BlockDecomp, compact_labels,  # noqa: E402
                              compute_order, connected_components_grid,
                              ms_segmentation)
from repro_torch.data import perlin_noise  # noqa: E402

SHAPE = (32, 32, 32)
LATTICE = {8: (2, 2, 2), 4: (2, 2), 2: (2,)}


def _layouts(shape, ranks):
    """(slab count, lattice layout or None, ragged shape), as JAX's
    example picks them from its device count."""
    n_shards = max(d for d in range(1, ranks + 1) if shape[0] % d == 0)
    layout = LATTICE.get(ranks)
    if layout and not all(s % p == 0 for s, p in zip(shape, layout)):
        layout = None
    return n_shards, layout, tuple(s - 1 for s in shape)


def _rank(rank, world, tmp, device):
    """One block's process: slab, lattice and ragged runs of its block,
    written to `tmp` as (labels, stats) per run."""
    import torch.distributed as dist
    from repro_torch.core import (distributed_connected_components,
                                  distributed_manifold, make_dpc_mesh)

    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            world_size=world, rank=rank)
    inp = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=True)
    n_shards, layout, rshape = _layouts(SHAPE, world)
    slabs = dist.new_group(list(range(n_shards)))   # every rank makes it
    out = {}

    def run(name, mesh, order, mask, shape):
        sl = BlockDecomp(shape, mesh.layout, mesh.names).block_slices(
            mesh.coords)
        d, st = distributed_manifold(order[sl].to(dev), mesh, shape, 6,
                                     descending=True)
        res = {"desc": d.cpu(), "stats": st.as_dict()}
        if mask is not None:
            c, cst = distributed_connected_components(mask[sl].to(dev), mesh,
                                                      shape, 6)
            res.update(cc=c.cpu(), cc_stats=cst.as_dict())
        out[name] = res

    if rank < n_shards:
        run("slabs", make_dpc_mesh(n_shards, group=slabs, device=dev),
            inp["order"], inp["mask"], SHAPE)
    if layout:
        run("blocks", make_dpc_mesh(layout, device=dev), inp["order"],
            inp["mask"], SHAPE)
    run("ragged", make_dpc_mesh(world, device=dev), inp["rorder"], None,
        rshape)
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _assemble(tmp, name, key, layout, shape):
    """The whole grid from the ranks' blocks of run `name`."""
    dec = BlockDecomp(shape, layout, ("bx", "by", "bz")[:len(layout)])
    out = np.full(shape, -2, np.int64)
    for r in range(int(np.prod(layout))):
        blk = torch.load(os.path.join(tmp, f"rank{r}.pt"),
                         weights_only=True)[name][key]
        out[dec.block_slices(np.unravel_index(r, layout))] = blk.numpy()
    return out


def _stats(tmp, name, key="stats"):
    return torch.load(os.path.join(tmp, "rank0.pt"),
                      weights_only=True)[name][key]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    ap.add_argument("--ranks", type=int, default=2,
                    help="processes of the distributed runs, a block each")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    ranks = args.ranks

    # --- the scalar field (paper §5: Perlin noise, frequency 0.1) ---------
    # cubic, so the block lattice's surface-to-volume edge over slabs shows
    shape = SHAPE
    field = perlin_noise(shape, frequency=0.1, seed=42, device=dev)
    order = compute_order(field)                # Simulation-of-Simplicity

    # --- Morse-Smale segmentation (paper Alg. 1) ---------------------------
    seg = ms_segmentation(order, connectivity=6)
    _, n_segments = compact_labels(seg.segmentation)
    desc = seg.descending.cpu().numpy()
    n_max = len(np.unique(desc))
    n_min = len(np.unique(seg.ascending.cpu().numpy()))
    print(f"MS segmentation of {shape}: {int(n_segments)} segments "
          f"({n_max} maxima x {n_min} minima), "
          f"{int(seg.n_iter_desc)} doubling rounds")

    # --- connected components of the top-10% mask (paper Alg. 3) ----------
    host = field.cpu().numpy()
    mask = torch.from_numpy(host > np.quantile(host, 0.9)).to(dev)
    cc = connected_components_grid(mask, connectivity=6)
    labels = cc.labels.cpu().numpy()
    n_comp = len(np.unique(labels[labels >= 0]))
    print(f"top-10% mask: {int(mask.sum())} vertices in {n_comp} components "
          f"({int(cc.n_rounds)} stitch rounds, {int(cc.n_compress_iter)} "
          f"compress iters)")

    # --- the ragged grid's single-device reference -------------------------
    n_shards, layout, rshape = _layouts(shape, ranks)
    rorder = compute_order(field[tuple(slice(0, s) for s in rshape)])
    rref = ms_segmentation(rorder, connectivity=6).descending.cpu().numpy()

    # --- distributed (DPC): one process a block ----------------------------
    tmp = tempfile.mkdtemp(prefix="quickstart_torch_")
    try:
        torch.save({"order": order.cpu(), "mask": mask.cpu(),
                    "rorder": rorder.cpu()}, os.path.join(tmp, "inputs.pt"))
        torch.multiprocessing.spawn(_rank, args=(ranks, tmp, str(dev)),
                                    nprocs=ranks)
        got = {"descending": desc, "labels": labels, "ragged_ref": rref}
        got["slab_descending"] = _assemble(tmp, "slabs", "desc",
                                           (n_shards,), shape)
        got["slab_labels"] = _assemble(tmp, "slabs", "cc", (n_shards,),
                                       shape)
        assert (got["slab_descending"] == desc).all()
        assert (got["slab_labels"] == labels).all()
        stats, cstats = _stats(tmp, "slabs"), _stats(tmp, "slabs",
                                                     "cc_stats")
        print(f"DPC on {n_shards} slab(s): identical labels; one exchange of "
              f"{int(stats['ghost_bytes']):,} ghost bytes, "
              f"{int(stats['table_iters'])} table rounds "
              f"(CC masked ghost fraction "
              f"{float(cstats['masked_ghost_fraction']):.3f})")

        # --- same, on an N-D block lattice (better surface-to-volume) ------
        if layout:
            got["block_descending"] = _assemble(tmp, "blocks", "desc",
                                                layout, shape)
            got["block_labels"] = _assemble(tmp, "blocks", "cc", layout,
                                            shape)
            assert (got["block_descending"] == desc).all()
            assert (got["block_labels"] == labels).all()
            bstats = _stats(tmp, "blocks")
            tag = "x".join(map(str, layout))
            print(f"DPC on {tag} blocks: identical labels; one exchange of "
                  f"{int(bstats['ghost_bytes']):,} ghost bytes "
                  f"(vs {int(stats['ghost_bytes']):,} for slabs)")

        # --- ragged extents: nothing needs to divide the mesh --------------
        # (pad-and-mask, deviation (p) in DESIGN.md -- the paper's real
        # dataset shapes are never multiples of the node count)
        got["ragged_descending"] = _assemble(tmp, "ragged", "desc",
                                             (ranks,), rshape)
        assert (got["ragged_descending"] == rref).all()
        rstats = _stats(tmp, "ragged")
        print(f"DPC on a ragged {'x'.join(map(str, rshape))} grid over "
              f"{ranks} device(s): identical labels, pad fraction "
              f"{float(rstats['pad_fraction']):.3f}, still "
              f"{int(rstats['comm_phases'])} exchange phase")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return got


if __name__ == "__main__":
    main()

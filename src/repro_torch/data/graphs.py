"""Graph inputs of the DPC graph path (port of the DPC parts of
`repro/data/graphs.py`): the edge list of a structured grid's implicit
triangulation (a synthetic tet mesh at connectivity 14) and a random
undirected graph in CSR form.  The GNN helpers of that module come with
the port's GNN substrate."""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..core.steepest import neighbor_offsets


def grid_edge_list(shape, connectivity: int, device=None):
    """Edge list of a structured grid's implicit triangulation, emitted as an
    unstructured mesh: with connectivity 14 on a 3-D shape this is exactly
    the edge set of the Kuhn/Freudenthal tetrahedralization (TTK's implicit
    triangulation).  Returns (senders, receivers) with BOTH directions of
    every undirected edge, int64 as numpy gives them, in JAX's order:
    offsets in table order, the sources of each offset row-major.

    The edges are built on `device` (default ``"cuda"``), each offset's
    slice written into the two output tensors in place: 256^3 at
    connectivity 14 is 233,311,230 edges, 1.87 GB a list in int64."""
    dev = resolve_device(device)
    shape = tuple(int(s) for s in shape)
    offs = neighbor_offsets(len(shape), connectivity)
    idx = torch.arange(int(np.prod(shape)), dtype=torch.int64,
                       device=dev).reshape(shape)
    cuts = []
    for off in offs:
        src = tuple(slice(0, sz - o) if o >= 0 else slice(-o, sz)
                    for o, sz in zip(off, shape))
        dst = tuple(slice(o, sz) if o >= 0 else slice(0, sz + o)
                    for o, sz in zip(off, shape))
        cuts.append((src, dst, idx[src].shape))
    total = sum(int(np.prod(sub)) for _, _, sub in cuts)
    send = torch.empty(total, dtype=torch.int64, device=dev)
    recv = torch.empty(total, dtype=torch.int64, device=dev)
    pos = 0
    for src, dst, sub in cuts:
        k = int(np.prod(sub))
        send[pos:pos + k].view(sub).copy_(idx[src])
        recv[pos:pos + k].view(sub).copy_(idx[dst])
        pos += k
    return send, recv


def random_csr(n_nodes: int, avg_degree: int, seed: int = 0):
    """Undirected random graph in CSR form (deterministic): the JAX
    package's numpy code, the same `default_rng` calls in the same order, so
    the graph is bit-equal to it.  Returns (indptr int64, indices int32)."""
    rng = np.random.default_rng(seed)
    m = n_nodes * avg_degree // 2
    src = rng.integers(0, n_nodes, m)
    dst = rng.integers(0, n_nodes, m)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    s = np.concatenate([src, dst])
    d = np.concatenate([dst, src])
    order = np.argsort(s, kind="stable")
    s, d = s[order], d[order]
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.add.at(indptr, s + 1, 1)
    indptr = np.cumsum(indptr)
    return indptr, d.astype(np.int32)

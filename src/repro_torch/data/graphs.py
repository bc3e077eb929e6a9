"""Graph data (port of `repro/data/graphs.py`): the edge list of a
structured grid's implicit triangulation (a synthetic tet mesh at
connectivity 14), a random undirected graph in CSR form, the GNN datasets
(cora-shaped, batched molecules with DimeNet triplets, a triangulated
mesh), the CSR neighbour sampler and its fixed-shape batches, and the
paper's DPC-CC on a batch (`component_labels`).

Everything but `grid_edge_list` and `component_labels` is JAX's numpy
code: the same `default_rng` calls in the same order, so every array is
bit-equal to JAX's.  Batches are dicts of numpy arrays plus the int
`n_graphs`; `interop.gnn_batch_from_numpy` puts one on a device."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import resolve_device
from ..core.connected_components import connected_components_graph
from ..core.steepest import neighbor_offsets
from ..interop import canonical_tensor


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


def cora_like(seed: int = 0, n_nodes: int = 2708, n_edges: int = 10556,
              d_feat: int = 1433, n_classes: int = 7):
    """Synthetic stand-in with cora's exact shape (full_graph_sm cell)."""
    rng = np.random.default_rng(seed)
    m = n_edges // 2
    src = rng.integers(0, n_nodes, m).astype(np.int32)
    dst = rng.integers(0, n_nodes, m).astype(np.int32)
    senders = np.concatenate([src, dst])
    receivers = np.concatenate([dst, src])
    feat = (rng.random((n_nodes, d_feat)) < 0.012).astype(np.float32)
    labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    return {
        "node_feat": feat, "senders": senders, "receivers": receivers,
        "node_mask": np.ones(n_nodes, bool),
        "edge_mask": np.ones(len(senders), bool),
        "labels": labels, "graph_ids": np.zeros(n_nodes, np.int32),
        "n_graphs": 1,
    }


def molecule_batch(batch: int = 128, n_nodes: int = 30, n_edges: int = 64,
                   n_species: int = 16, seed: int = 0,
                   max_triplets_per_graph: int | None = None):
    """Batched small molecules (the `molecule` cell): radius-graph edges,
    per-graph energy targets, DimeNet triplet lists."""
    rng = np.random.default_rng(seed)
    N, E = batch * n_nodes, batch * n_edges
    pos = rng.standard_normal((batch, n_nodes, 3)).astype(np.float32) * 2.0
    species = rng.integers(0, n_species, (batch, n_nodes)).astype(np.int32)
    senders = np.zeros((batch, n_edges), np.int32)
    receivers = np.zeros((batch, n_edges), np.int32)
    for b in range(batch):
        d = np.linalg.norm(pos[b][:, None] - pos[b][None, :], axis=-1)
        np.fill_diagonal(d, np.inf)
        flat = np.argsort(d.ravel())[:n_edges]
        senders[b] = (flat // n_nodes).astype(np.int32)
        receivers[b] = (flat % n_nodes).astype(np.int32)
    offs = (np.arange(batch) * n_nodes).astype(np.int32)
    senders = (senders + offs[:, None]).ravel()
    receivers = (receivers + offs[:, None]).ravel()
    energy = rng.standard_normal(batch).astype(np.float32)
    t_src, t_dst, t_mask = build_triplets(
        senders, receivers, N,
        max_triplets=batch * (max_triplets_per_graph or 4 * n_edges))
    return {
        "node_feat": species.reshape(-1, 1).astype(np.float32),
        "positions": pos.reshape(-1, 3),
        "senders": senders, "receivers": receivers,
        "node_mask": np.ones(N, bool), "edge_mask": np.ones(E, bool),
        "graph_ids": np.repeat(np.arange(batch, dtype=np.int32), n_nodes),
        "n_graphs": batch, "labels": energy,
        "triplet_src": t_src, "triplet_dst": t_dst, "triplet_mask": t_mask,
    }


def build_triplets(senders, receivers, n_nodes, max_triplets: int):
    """DimeNet edge-pair lists: all (k->j, j->i) with k != i.  Padded to
    `max_triplets`; pad entries point at edge 0 with mask=0."""
    e = len(senders)
    # the incoming edges of j are (k->j), its outgoing ones (j->i): group
    # the incoming edges by j
    in_by_node = [[] for _ in range(n_nodes)]
    for idx in range(e):
        in_by_node[receivers[idx]].append(idx)
    t_src, t_dst = [], []
    for ji in range(e):
        j = senders[ji]
        for kj in in_by_node[j]:
            if senders[kj] != receivers[ji]:  # k != i
                t_src.append(kj)
                t_dst.append(ji)
                if len(t_src) >= max_triplets:
                    break
        if len(t_src) >= max_triplets:
            break
    t = len(t_src)
    pad = max_triplets - t
    src = np.array(t_src + [0] * pad, np.int32)
    dst = np.array(t_dst + [0] * pad, np.int32)
    mask = np.array([True] * t + [False] * pad)
    return src, dst, mask


def mesh_grid_graph(nx: int, ny: int, seed: int = 0, d_node_in: int = 8,
                    d_edge_in: int = 4, d_out: int = 3):
    """Regular triangulated mesh for MeshGraphNet smoke/bench runs."""
    rng = np.random.default_rng(seed)
    n = nx * ny
    idx = np.arange(n).reshape(nx, ny)
    half_s = np.concatenate([idx[:-1, :].ravel(), idx[:, :-1].ravel(),
                             idx[:-1, :-1].ravel()])
    half_r = np.concatenate([idx[1:, :].ravel(), idx[:, 1:].ravel(),
                             idx[1:, 1:].ravel()])
    send = np.concatenate([half_s, half_r]).astype(np.int32)
    recv = np.concatenate([half_r, half_s]).astype(np.int32)
    e = len(send)
    return {
        "node_feat": rng.standard_normal((n, d_node_in)).astype(np.float32),
        "edge_feat": rng.standard_normal((e, d_edge_in)).astype(np.float32),
        "senders": send, "receivers": recv,
        "node_mask": np.ones(n, bool), "edge_mask": np.ones(e, bool),
        "labels": rng.standard_normal((n, d_out)).astype(np.float32),
        "graph_ids": np.zeros(n, np.int32), "n_graphs": 1,
    }


# --- neighbor sampler (minibatch_lg) ------------------------------------------


@dataclasses.dataclass
class NeighborSampler:
    """Uniform fanout sampler over a CSR graph (GraphSAGE-style), producing
    fixed-shape padded subgraph batches for jit stability."""
    indptr: np.ndarray
    indices: np.ndarray
    fanouts: tuple
    seed: int = 0

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed)
        self.n_nodes = len(self.indptr) - 1

    def max_sample_nodes(self, batch_nodes: int) -> int:
        total, layer = 0, batch_nodes
        for f in (1,) + tuple(self.fanouts):
            layer = layer * f
            total += layer
        return total

    def max_sample_edges(self, batch_nodes: int) -> int:
        total, layer = 0, batch_nodes
        for f in self.fanouts:
            total += layer * f
            layer = layer * f
        return 2 * total  # both directions

    def sample(self, seeds: np.ndarray):
        """Returns (nodes, senders, receivers, masks): local-indexed padded
        subgraph with `seeds` first."""
        batch = len(seeds)
        frontier = seeds.astype(np.int64)
        nodes = [frontier]
        s_loc, r_loc = [], []
        node_pos = {int(v): i for i, v in enumerate(frontier)}
        for f in self.fanouts:
            new = []
            for v in frontier:
                lo, hi = self.indptr[v], self.indptr[v + 1]
                deg = hi - lo
                if deg == 0:
                    continue
                picks = self.indices[
                    lo + self.rng.integers(0, deg, min(f, deg))]
                for u in picks:
                    u = int(u)
                    if u not in node_pos:
                        node_pos[u] = len(node_pos)
                        new.append(u)
                    s_loc.append(node_pos[u])
                    r_loc.append(node_pos[int(v)])
            frontier = np.array(new, np.int64) if new else np.empty(0, np.int64)
            nodes.append(frontier)
        all_nodes = np.concatenate(nodes) if nodes else seeds
        max_n = self.max_sample_nodes(batch)
        max_e = self.max_sample_edges(batch)
        n, e = len(node_pos), len(s_loc)
        node_ids = np.full(max_n, -1, np.int64)
        node_ids[:n] = np.fromiter(node_pos.keys(), np.int64, n)
        senders = np.full(max_e, max_n - 1, np.int32)
        receivers = np.full(max_e, max_n - 1, np.int32)
        senders[:e] = s_loc
        receivers[:e] = r_loc
        # reverse direction for undirected message passing
        senders[e:2 * e] = r_loc
        receivers[e:2 * e] = s_loc
        node_mask = np.zeros(max_n, bool)
        node_mask[:n] = True
        edge_mask = np.zeros(max_e, bool)
        edge_mask[:2 * e] = True
        return node_ids, senders, receivers, node_mask, edge_mask


def sampled_batch(sampler: NeighborSampler, features: np.ndarray,
                  labels: np.ndarray, batch_nodes: int, step: int = 0):
    """One minibatch_lg training batch: sample seeds, gather features."""
    rng = np.random.default_rng(sampler.seed + step)
    seeds = rng.integers(0, sampler.n_nodes, batch_nodes)
    node_ids, snd, rcv, nmask, emask = sampler.sample(seeds)
    safe = np.clip(node_ids, 0, features.shape[0] - 1)
    feat = features[safe] * nmask[:, None]
    lab = np.where(nmask, labels[safe], -1).astype(np.int32)
    # only seed nodes carry supervision
    lab[batch_nodes:] = -1
    return {
        "node_feat": feat.astype(np.float32),
        "senders": snd, "receivers": rcv,
        "node_mask": nmask, "edge_mask": emask,
        "labels": lab, "graph_ids": np.zeros(len(nmask), np.int32),
        "n_graphs": 1,
    }


# --- DPC integration ----------------------------------------------------------


def component_labels(batch, device=None) -> np.ndarray:
    """Label the batch's connected components with the paper's algorithm
    (`core.connected_components_graph`, mask = node_mask) on `device`
    (default ``"cuda"``); the labels come back as a numpy array, as JAX's
    do.  Used by the pipeline for sanity metrics (e.g. the number of
    disconnected fragments a sampler produced)."""
    res = connected_components_graph(
        canonical_tensor(batch["node_mask"], device),
        canonical_tensor(batch["senders"], device),
        canonical_tensor(batch["receivers"], device))
    return res.labels.cpu().numpy()


_NODE_KEYS = ("node_feat", "positions", "node_mask", "graph_ids")
_EDGE_KEYS = ("senders", "receivers", "edge_mask", "edge_feat")
_TRIPLET_KEYS = ("triplet_src", "triplet_dst", "triplet_mask")


def pad_graph(batch: dict, multiple: int) -> dict:
    """A numpy graph batch with its node, edge and triplet arrays padded to
    multiples of `multiple` rows, as the dry-run cells pad theirs (to 512)
    so that they split over any mesh of that many ranks: pad nodes are
    masked (features 0, graph 0, GAT label -1), pad edges join the last
    node to itself, masked, and pad triplets join the last edge to itself,
    masked.  Per-graph arrays and `n_graphs` are unchanged."""
    def up(n):
        return -(-n // multiple) * multiple

    n, e = batch["node_mask"].shape[0], batch["senders"].shape[0]
    gat_labels = batch.get("labels") is not None and \
        batch["labels"].shape[0] == n
    groups = [(_NODE_KEYS + (("labels",) if gat_labels else ()), n, 0),
              (_EDGE_KEYS, e, up(n) - 1)]
    if "triplet_src" in batch:
        groups.append((_TRIPLET_KEYS, batch["triplet_src"].shape[0],
                       up(e) - 1))
    out = dict(batch)
    for keys, size, last in groups:
        for k in keys:
            v = batch.get(k)
            if v is None:
                continue
            fill = 0
            if k in ("senders", "receivers", "triplet_src", "triplet_dst"):
                fill = last
            elif k == "labels" and v.ndim == 1 and v.dtype.kind == "i":
                fill = -1
            pad = np.full((up(size) - size,) + v.shape[1:], fill, v.dtype)
            out[k] = np.concatenate([v, pad])
    return out

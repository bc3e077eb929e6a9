"""Distributed connected components on unstructured (edge-list) meshes over
`torch.distributed` (port of `repro/core/distributed_graph.py`).

The same phase structure as the block backend (`core/distributed.py`),
with table-driven id maps in place of coordinate arithmetic:

  decomposition  `GraphDecomp` vertex-partitions a global edge list into
                 per-partition local subgraphs plus a one-ring ghost layer;
                 every global <-> local id translation is a numpy lookup
                 table, built the same way on every rank.
  local phase    graph mask-argmax init with masked ghosts pinned to self
                 (Alg. 1 lines 6-8), path compression and the stitch
                 fixpoint (Alg. 3, deviation (d) in DESIGN.md), all local.
  ONE comm phase an all-gather of every partition's owned cut vertices'
                 labels (and masks, in the same payload) into a replicated
                 flat table (deviation (b)); or, with table_mode="sharded",
                 the own cut row plus one chunk per adjacent partition,
                 exchanged by a static schedule of partial permutations
                 (`DPCMesh.permute`) in the outer rounds of
                 `_table.sharded_fixpoint_batch` (deviation (s)).
  resolution     the table chase (slot lookup by sorted-gid search), the
                 hook+propagate fixpoint over the static cut-edge list
                 (deviation (d2)) and value-search substitution
                 (`core/_table.py`).

One process per partition, on a 1-D mesh of `decomp.nparts` ranks
(`make_dpc_mesh(nparts)`): rank p runs partition p.  Every rank passes the
global (n,) mask: the ghosts' mask values are read from it, not exchanged,
as in the reference (deviation (g1) in DESIGN.md).  Each rank gets back its
own labels only, `(owned_counts[p],)` in the order of
`decomp.owned_gid[p]` (pad slots dropped), so no rank builds the global
label array; `assemble_graph_labels` puts the parts together.  Stats are
the same on every rank.

The `_batch` entry point takes (B, n) masks; as under JAX's `vmap`, the
table's all-gather, each permute round, each sharded exchange round and
the stats' reduction fire once for the batch, and each item keeps its own
counts.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .._meta import read_int

from ._table import (check_converged, check_table_mode, hook_propagate,
                     make_group_max, pointer_chase, sharded_fixpoint_batch,
                     value_substitute)
from .connected_components import _cc_fixpoint, _graph_stitch
from .distributed import (DPCMesh, _cut_max_fn, _f32, _i32, _item,
                          _pmax_lists, _reduce_any_fn)
from .stats import GraphDPCStats
from .steepest import compact, graph_mask_argmax_pairs, id_dtype_for


class GraphDecomp:
    """Static geometry of a vertex partition of an edge-list mesh (a copy of
    the reference's, numpy arrays equal to its).

    `senders`/`receivers` carry BOTH directions of every undirected edge.
    `part[v]` assigns vertex v to one of `nparts` partitions; the default
    is contiguous blocks of global ids (the leading n % nparts blocks one
    larger).  Any assignment works: each partition's owned set is padded to
    ``n_owned = max(counts)`` with inert sentinel slots (deviation (p) in
    DESIGN.md).

    Per partition p:
      owned    the sorted global ids with part == p (padded to `n_owned`;
               pad entries carry gid `n`);
      ghosts   the one-ring: vertices of other partitions reached by a cut
               edge from p;
      local id index into sorted(owned ∪ ghosts), padded at the end to
               `n_local`; the local order is the global order restricted to
               the local set, so local id maxima are global id maxima;
      edges    every directed edge with >= 1 endpoint owned by p, in local
               ids (padded with (0, 0) self-loops, which change nothing);
      cut      owned vertices incident to an inter-partition edge; cut j of
               p owns slot ``p * c_max + j`` of the gathered table.

    Ids are int32 below 2**31 vertices and int64 from there (`id_dtype`,
    a torch dtype), as the grid backend's; local ids are int32.
    """

    def __init__(self, n_vertices, senders, receivers, nparts, part=None):
        self.n = int(n_vertices)
        self.nparts = int(nparts)
        if self.n < 1:
            raise ValueError("graph must have at least one vertex")
        if self.nparts < 1:
            raise ValueError("nparts must be >= 1")
        self.id_dtype = id_dtype_for(self.n)
        s = np.asarray(senders, dtype=np.int64).ravel()
        r = np.asarray(receivers, dtype=np.int64).ravel()
        if s.shape != r.shape:
            raise ValueError("senders and receivers must have equal length")
        if s.size and not (0 <= s.min() and s.max() < self.n
                           and 0 <= r.min() and r.max() < self.n):
            raise ValueError("edge endpoints out of range")
        if part is None:
            sizes = [len(c) for c in
                     np.array_split(np.arange(self.n), self.nparts)]
            part = np.repeat(np.arange(self.nparts), sizes)
        part = np.asarray(part, dtype=np.int64).ravel()
        if part.shape[0] != self.n:
            raise ValueError("part must assign every vertex")
        if part.size and (part.min() < 0 or part.max() >= self.nparts):
            raise ValueError(f"part values must lie in [0, {self.nparts})")
        counts = np.bincount(part, minlength=self.nparts)
        self.part = part
        self.owned_counts = counts
        self.n_owned = int(counts.max())
        self.pad_fraction = 1.0 - self.n / (self.nparts * self.n_owned)

        ps, pr = part[s], part[r]
        cross = ps != pr
        owned, ghosts, cut = [], [], []
        for p in range(self.nparts):
            owned.append(np.flatnonzero(part == p))
            sel = (ps == p) & cross
            ghosts.append(np.unique(r[sel]))
            cut.append(np.unique(s[sel]))
        self.g_max = max((len(g) for g in ghosts), default=0)
        self.n_local = self.n_owned + self.g_max
        if self.n_local >= 2**31:
            raise ValueError("per-partition extent exceeds int32 local ids; "
                             "use more partitions")
        self.c_max = max((len(c) for c in cut), default=0)
        self.table_size = self.nparts * self.c_max
        self.n_cut = int(sum(len(c) for c in cut))  # real (non-pad) slots

        self.owned_gid = np.full((self.nparts, self.n_owned), self.n,
                                 np.int64)
        lgid = np.full((self.nparts, self.n_local), -1, np.int64)
        valid = np.zeros((self.nparts, self.n_local), bool)
        is_ghost = np.zeros((self.nparts, self.n_local), bool)
        owned_lidx = np.zeros((self.nparts, self.n_owned), np.int32)
        cut_lidx = np.full((self.nparts, self.c_max), -1, np.int32)
        slot_of = np.full(self.n, -1, np.int64)
        gid2lid = np.full(self.n, -1, np.int64)              # reused scratch
        eloc = []
        for p in range(self.nparts):
            o, g, c = owned[p], ghosts[p], cut[p]
            self.owned_gid[p, :len(o)] = o
            loc = np.sort(np.concatenate([o, g]))
            lgid[p, :len(loc)] = loc
            valid[p, :len(loc)] = True
            gid2lid[loc] = np.arange(len(loc))
            is_ghost[p, gid2lid[g]] = True
            owned_lidx[p, :len(o)] = gid2lid[o]
            if len(o) < self.n_owned:
                # pad owned slots point at the first invalid local slot:
                # mask False there, so the pad label is -1 downstream
                owned_lidx[p, len(o):] = min(len(loc), self.n_local - 1)
            cut_lidx[p, :len(c)] = gid2lid[c]
            slot_of[c] = p * self.c_max + np.arange(len(c))
            esel = (ps == p) | (pr == p)
            ls, lr = gid2lid[s[esel]], gid2lid[r[esel]]
            if ls.size and ((ls < 0).any() or (lr < 0).any()):
                raise ValueError(
                    "edge list must contain BOTH directions of every "
                    "undirected edge (one-ring ghost closure violated)")
            eloc.append((ls, lr))
            gid2lid[loc] = -1
        self.e_max = max((len(ls) for ls, _ in eloc), default=0)
        self.edge_src = np.zeros((self.nparts, self.e_max), np.int32)
        self.edge_dst = np.zeros((self.nparts, self.e_max), np.int32)
        for p, (ls, lr) in enumerate(eloc):
            self.edge_src[p, :len(ls)] = ls
            self.edge_dst[p, :len(lr)] = lr
        self.local_gid, self.local_valid = lgid, valid
        self.local_ghost = is_ghost
        self.owned_lidx = owned_lidx
        self.cut_lidx = cut_lidx

        # cut edges in table-slot space (both directions already present)
        self.cut_edge_src = slot_of[s[cross]].astype(np.int32)
        self.cut_edge_dst = slot_of[r[cross]].astype(np.int32)
        # sorted gid -> slot lookup for the pointer chase
        allcut = np.concatenate(cut)
        order = np.argsort(allcut)
        self.cut_gid_sorted = allcut[order]
        self.cut_slot_sorted = slot_of[allcut[order]].astype(np.int32)
        self._on_device = {}

    def on_device(self, rank: int, device) -> dict:
        """Partition `rank`'s rows of the tables as tensors on `device`,
        uploaded once per rank and device: local gids (id dtype), validity,
        ghosts, owned and cut local ids, local edges, and the sorted cut
        gids and their slots."""
        key = (rank, str(device))
        if key not in self._on_device:
            def up(a, dtype=None):
                t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
                return t if dtype is None else t.to(dtype)
            self._on_device[key] = {
                "gid": up(self.local_gid[rank], self.id_dtype),
                "valid": up(self.local_valid[rank]),
                "ghost": up(self.local_ghost[rank]),
                "owned": up(self.owned_lidx[rank]),
                "src": up(self.edge_src[rank]),
                "dst": up(self.edge_dst[rank]),
                "cut": up(self.cut_lidx[rank]),
                "cut_gid": up(self.cut_gid_sorted, self.id_dtype),
                "cut_slot": up(self.cut_slot_sorted),
            }
        return self._on_device[key]


class _GraphShardGeom:
    """Sharded-table geometry of a vertex partition (deviation (s)), a copy
    of the reference's.

    Two partitions are adjacent iff a cut edge joins them.  Every
    partition's stack holds its own cut row (chunk 0) plus one chunk per
    adjacent partition, padded to the largest degree `d_max` with inert
    fill chunks.  The halo exchange is a static schedule of partial
    permutations: the directed receive pairs {(q -> p) : q adjacent to p}
    are split greedily into rounds in which no partition sends or receives
    twice.  `store_idx[p, k]` is the chunk partition p stores round k's row
    into, `n_chunks` (dropped) when it receives nothing that round.
    """

    def __init__(self, dec: GraphDecomp):
        c = dec.c_max
        pe_s = dec.cut_edge_src // max(c, 1)
        pe_d = dec.cut_edge_dst // max(c, 1)
        adjset = [set() for _ in range(dec.nparts)]
        for a, b in zip(pe_s.tolist(), pe_d.tolist()):
            adjset[a].add(b)
            adjset[b].add(a)
        adj = [sorted(s) for s in adjset]
        self.d_max = max((len(a) for a in adj), default=0)
        self.n_chunks = 1 + self.d_max
        self.stack_size = self.n_chunks * c
        chunk_of = np.full((dec.nparts, dec.nparts), -1, np.int32)
        for p in range(dec.nparts):
            chunk_of[p, p] = 0
            for i, q in enumerate(adj[p]):
                chunk_of[p, q] = 1 + i
        self.chunk_of = chunk_of

        pairs = [(q, p) for p in range(dec.nparts) for q in adj[p]]
        perms = []
        while pairs:
            used_s, used_d, rnd, rest = set(), set(), [], []
            for q, p in pairs:
                if q not in used_s and p not in used_d:
                    used_s.add(q)
                    used_d.add(p)
                    rnd.append((q, p))
                else:
                    rest.append((q, p))
            perms.append(tuple(rnd))
            pairs = rest
        self.round_perms = tuple(perms)
        store_idx = np.full((dec.nparts, max(len(perms), 1)), self.n_chunks,
                            np.int32)
        for k, rnd in enumerate(perms):
            for q, p in rnd:
                store_idx[p, k] = chunk_of[p, q]
        self.store_idx = store_idx

        # cut edges rewritten to per-partition stack slots: edge (u -> v)
        # is in p's list iff both endpoint partitions have a chunk in p's
        # stack; pad rows carry src == stack_size
        srow = dec.cut_edge_src % max(c, 1)
        drow = dec.cut_edge_dst % max(c, 1)
        lists = []
        for p in range(dec.nparts):
            cs, cd = chunk_of[p, pe_s], chunk_of[p, pe_d]
            sel = (cs >= 0) & (cd >= 0)
            lists.append((cs[sel] * c + srow[sel], cd[sel] * c + drow[sel]))
        self.se_max = max((len(a) for a, _ in lists), default=0)
        ses = np.full((dec.nparts, max(self.se_max, 1)), self.stack_size,
                      np.int32)
        sed = np.zeros((dec.nparts, max(self.se_max, 1)), np.int32)
        for p, (a, b) in enumerate(lists):
            ses[p, :len(a)] = a
            sed[p, :len(b)] = b
        self.stack_edge_src = ses
        self.stack_edge_dst = sed


def _graph_shard_geom(dec: GraphDecomp) -> _GraphShardGeom:
    """The sharded geometry, built once per decomposition (numpy)."""
    geom = dec.__dict__.get("_shard_geom")
    if geom is None:
        geom = dec.__dict__["_shard_geom"] = _GraphShardGeom(dec)
    return geom


def _slot_lookup(t):
    """(values -> (hit, slot)) through the sorted cut-gid table of the
    partition tensors `t` (`GraphDecomp.on_device`)."""
    sg, sl = t["cut_gid"], t["cut_slot"]

    def lookup(v):
        c = v.clamp(min=0)
        i = torch.searchsorted(sg, c).clamp_(0, sg.numel() - 1)
        return (v >= 0) & (sg[i] == c), sl[i]
    return lookup


def _local_phase(m, t):
    """One item's local CC fixpoint (Alg. 3) on the partition's local
    subgraph: the mask-argmax init over the edges with both ends masked,
    masked ghosts pinned to self, then stitch + compress.  The pairs are
    compacted once, as `connected_components_graph` does; the pad
    self-loops change nothing."""
    src, dst = t["src"], t["dst"]
    pairs = compact(m.index_select(0, src) & m.index_select(0, dst),
                    src, dst)
    d0 = graph_mask_argmax_pairs(m, *pairs, ghost=t["ghost"])
    return _cc_fixpoint(d0, lambda d: _graph_stitch(d, *pairs))


def _cc_partitions(local_masks, dec: GraphDecomp, mesh: DPCMesh,
                   gather_mask: bool, table_mode: str, table_max_iter: int):
    """Partition `mesh.rank`'s program for a (B, n_local) stack of local
    masks: ((B, n_owned) labels, GraphDPCStats with (B,) fields)."""
    t = dec.on_device(mesh.rank, mesh.device)
    B, dt, c_max = local_masks.shape[0], dec.id_dtype, dec.c_max
    isz = torch.tensor([], dtype=dt).element_size()

    # 1.-3. the local phase, item by item, in local ids; then global ids
    owned, cut_lab, cut_m, rounds_l, iters_l = [], [], [], [], []
    cvalid, cli = t["cut"] >= 0, t["cut"].clamp(min=0)
    for m in local_masks:
        res = _local_phase(m, t)
        dg = torch.where(res.labels >= 0,
                         t["gid"].index_select(0, res.labels.clamp(min=0)),
                         -1)
        owned.append(dg.index_select(0, t["owned"]))
        cut_lab.append(torch.where(cvalid, dg.index_select(0, cli), -1))
        cut_m.append(cvalid & m.index_select(0, cli))
        rounds_l.append(res.n_rounds)
        iters_l.append(res.n_compress_iter)
    # the local stats' reduction comes first, so every rank's first
    # collective is one that all ranks join (NCCL asks it of a permute)
    li, sr = _pmax_lists(mesh, iters_l, rounds_l)
    zeros = [0] * B

    if dec.table_size == 0:
        # no inter-partition edges (or a single partition): fully local
        final = torch.stack(owned)
        stats = GraphDPCStats(
            local_iters=_i32(li), table_iters=_i32(zeros),
            stitch_rounds=_i32(sr), ghost_bytes=_f32([0.0] * B),
            masked_ghost_fraction=_f32([0.0] * B),
            comm_phases=_i32(zeros),
            pad_fraction=_f32(dec.pad_fraction).repeat(B),
            kernel_rounds=_i32(zeros), global_iters_saved=_i32(zeros),
            table_bytes_peak=_f32([0.0] * B), exchange_rounds=_i32(zeros),
            converged=_i32([1] * B))
        return final, stats

    lookup = _slot_lookup(t)
    cut_lab, cut_m = torch.stack(cut_lab), torch.stack(cut_m)
    finals, table_iters = [], []
    if table_mode == "replicated":
        # 5. the ONE communication phase: owned cut labels (+ masks in the
        #    same payload), (B, rows, c_max) gathered for the batch
        payload = (torch.stack([cut_lab, cut_m.to(dt)], dim=1) if gather_mask
                   else cut_lab[:, None])
        g = mesh.all_gather(payload)              # (nparts, B, rows, c_max)
        ces = torch.from_numpy(dec.cut_edge_src).to(mesh.device).long()
        ced = torch.from_numpy(dec.cut_edge_dst).to(mesh.device)

        def chase(v):
            hit, slot = lookup(v)
            return torch.where(hit, v.index_select(
                0, slot.clamp(0, v.numel() - 1)), v)

        not_ok, masked = [], []
        for b in range(B):
            T = g[:, b, 0].reshape(-1)
            M = (g[:, b, 1].reshape(-1) != 0) if gather_mask else T >= 0
            # 6a. positional chase (Alg. 2 lines 15-25, table-driven lookup)
            Tstar, chase_iters, chase_ok = pointer_chase(T, chase,
                                                         table_max_iter)
            # 6b. hook + propagate over the static cut-edge list (d2)
            group_max, perm, sorted_vals = make_group_max(Tstar)
            cut_max = _cut_max_fn(*compact(M[ces] & M[ced], ces, ced))
            G, prop_iters, prop_ok = hook_propagate(Tstar, cut_max, group_max,
                                                    table_max_iter)
            # 7. substitution: chase the own label once, adopt its group's
            #    maximum
            o = owned[b]
            hit, slot = lookup(o)
            chased = torch.where(hit, Tstar.index_select(
                0, slot.clamp(0, Tstar.numel() - 1)), o)
            finals.append(value_substitute(o, chased, sorted_vals,
                                           G.index_select(0, perm)))
            table_iters.append(chase_iters + prop_iters)
            not_ok.append(int(not (chase_ok and prop_ok)))
            masked.append(read_int(M.sum()))
        rows = 2 if gather_mask else 1
        # pad cut slots carry label -1 / mask False and are left out of the
        # exchange accounting (deviation (p))
        ghost_bytes = _f32(dec.n_cut * rows * isz).repeat(B)
        comm, exch_rounds = [1] * B, zeros
        # gathered payload (labels + mask as id dtype), or labels + bool M
        table_bytes = _f32(dec.table_size * ((2 * isz) if gather_mask
                                             else (isz + 1))).repeat(B)
    else:
        # 5'-7'. sharded (deviation (s)): own cut row + one chunk per
        #    adjacent partition, max-flooding relayed by permute rounds
        geom = _graph_shard_geom(dec)
        size = geom.stack_size
        store = geom.store_idx[mesh.rank]
        chunk_row = torch.from_numpy(geom.chunk_of[mesh.rank]).to(
            mesh.device)

        def make_exchange(fill):
            def exchange(own_rows):
                stack = torch.full((own_rows.shape[0], geom.n_chunks, c_max),
                                   fill, dtype=own_rows.dtype,
                                   device=own_rows.device)
                stack[:, 0] = own_rows
                for k, pairs in enumerate(geom.round_perms):
                    recv = mesh.permute(own_rows, pairs)
                    if store[k] < geom.n_chunks:
                        stack[:, int(store[k])] = recv
                return stack.reshape(own_rows.shape[0], -1)
            return exchange

        # static stacks, exchanged once: the group structure and the mask
        exchange = make_exchange(-1)
        T0s = exchange(cut_lab)
        Ms = make_exchange(False)(cut_m) if gather_mask else T0s >= 0
        groups = [make_group_max(s) for s in T0s]
        ses = torch.from_numpy(geom.stack_edge_src[mesh.rank]).to(mesh.device)
        sed = torch.from_numpy(geom.stack_edge_dst[mesh.rank]).to(mesh.device)
        real = ses < size
        ss, dd = ses.clamp(0, size - 1).long(), sed.clamp(0, size - 1).long()
        cut_maxes = [_cut_max_fn(*compact(real & M[ss] & M[dd], ss, dd))
                     for M in Ms]

        def refine(stack, b):
            return hook_propagate(stack, cut_maxes[b], groups[b][0],
                                  table_max_iter)

        stacks, _, exch_rounds, iters, ok = sharded_fixpoint_batch(
            cut_lab, exchange, refine, _reduce_any_fn(mesh),
            max_rounds=table_max_iter)

        # substitution: an owned label's slot, when it is a cut vertex,
        # lives in this stack (own chunk or an adjacent partition's);
        # interior roots are found by value over the static stack labels
        for b, (stackG, (_, perm, sorted_vals)) in enumerate(zip(stacks,
                                                                 groups)):
            o = owned[b]
            hit, slot = lookup(o)
            chunk = chunk_row.index_select(
                0, (slot // c_max).clamp(0, dec.nparts - 1))
            sidx = chunk * c_max + slot % c_max
            chased = torch.where(hit & (chunk >= 0), stackG.index_select(
                0, sidx.clamp(0, size - 1)), o)
            finals.append(value_substitute(o, chased, sorted_vals,
                                           stackG.index_select(0, perm)))
        table_iters, not_ok = iters, [int(not v) for v in ok]
        comm = [r + 1 for r in exch_rounds]  # +1: the static label/mask stack
        halo = size - c_max
        ghost_bytes = (_f32(halo * isz) * (_f32(exch_rounds) + 1.0)
                       + (_f32(halo) if gather_mask else 0.0))
        # evolving stack + static label stack + own row + bool mask stack
        table_bytes = _f32((2 * size + c_max) * isz + size).repeat(B)
        # over real slots (pad slots are mask False); summed as an integer,
        # exact where JAX's float32 psum is
        masked = mesh.all_reduce([read_int(M[:c_max].sum()) for M in Ms],
                                 dist.ReduceOp.SUM)
    # the sharded fixpoint's counts differ between ranks: pmax, as the
    # reference does (replicated counts are equal on every rank)
    ti, bad = _pmax_lists(mesh, table_iters, not_ok)
    stats = GraphDPCStats(
        local_iters=_i32(li),
        table_iters=_i32(ti),
        stitch_rounds=_i32(sr),
        ghost_bytes=ghost_bytes,
        masked_ghost_fraction=_f32(masked) / _f32(max(dec.n_cut, 1)),
        comm_phases=_i32(comm),
        pad_fraction=_f32(dec.pad_fraction).repeat(B),
        kernel_rounds=_i32(zeros),        # no fused grid kernel on graphs
        global_iters_saved=_i32(zeros),
        table_bytes_peak=table_bytes,
        exchange_rounds=_i32(exch_rounds),
        converged=_i32([1 - v for v in bad]),
    )
    return torch.stack(finals), stats


def _components(masks, decomp: GraphDecomp, mesh: DPCMesh, gather_mask,
                table_mode, table_max_iter, what, noun):
    """(B, n) global masks -> this rank's ((B, owned_counts[rank]) labels,
    batched stats), after the reference's checks in its order."""
    check_table_mode(table_mode)
    if len(mesh.names) != 1:
        raise ValueError(f"graph CC needs a 1-D mesh, got axes {mesh.names}")
    if mesh.layout[0] != decomp.nparts:
        raise ValueError(f"mesh has {mesh.layout[0]} devices but decomp "
                         f"has {decomp.nparts} partitions")
    if masks.shape[1] != decomp.n:
        raise ValueError(f"{noun} {masks.shape[1]} entries for {decomp.n} "
                         f"vertices")
    if masks.shape[0] == 0:
        raise ValueError("a batch needs at least one item")
    t = decomp.on_device(mesh.rank, mesh.device)
    # the ghosts' mask values ride the input (deviation (g1) in DESIGN.md):
    # this partition reads its owned + one-ring mask here
    local = masks.to(mesh.device).bool().index_select(
        1, t["gid"].clamp(min=0)) & t["valid"]
    labels, stats = _cc_partitions(local, decomp, mesh, gather_mask,
                                   table_mode, table_max_iter)
    check_converged(stats.converged, what, table_max_iter)
    return labels[:, :int(decomp.owned_counts[mesh.rank])], stats


def distributed_connected_components_graph(mask, decomp: GraphDecomp,
                                           mesh: DPCMesh,
                                           gather_mask: bool = True,
                                           table_mode: str = "replicated",
                                           table_max_iter: int = 64):
    """Mask-implicit connected components of a vertex-partitioned edge-list
    mesh (Alg. 3 + Alg. 2 on a table-driven decomposition).

    mask: the global (n,) mask (all-ones labels pure geometry), the same
    on every rank.  mesh: a 1-D mesh of `decomp.nparts` ranks
    (`make_dpc_mesh(nparts)`); rank p runs partition p.  table_mode picks
    the cut-table layout, "replicated" (one all-gather) or "sharded" (own
    cut row + one chunk per adjacent partition, permute rounds; deviation
    (s) in DESIGN.md).  Returns this rank's labels, (owned_counts[p],) in
    the order of `decomp.owned_gid[p]` (the largest vertex id of each
    component, -1 where unmasked; `assemble_graph_labels` gives the global
    array, equal to `connected_components_graph`'s), and GraphDPCStats
    equal on every rank.
    """
    labels, stats = _components(mask.reshape(1, -1), decomp, mesh,
                                gather_mask, table_mode, table_max_iter,
                                "distributed_connected_components_graph",
                                "mask has")
    return labels[0], _item(stats)


def distributed_connected_components_graph_batch(masks, decomp: GraphDecomp,
                                                 mesh: DPCMesh,
                                                 gather_mask: bool = True,
                                                 table_mode: str =
                                                 "replicated",
                                                 table_max_iter: int = 64):
    """Batched `distributed_connected_components_graph`: `masks` is a (B, n)
    stack of global masks over one decomposed mesh (many masks or
    thresholds of one geometry).  Returns this rank's (B,
    owned_counts[p]) labels and GraphDPCStats with a leading (B,) dim,
    each item equal to its single call; the collectives fire once for the
    batch (module docstring)."""
    return _components(masks.reshape(masks.shape[0], -1), decomp, mesh,
                       gather_mask, table_mode, table_max_iter,
                       "distributed_connected_components_graph_batch",
                       "masks have")


def assemble_graph_labels(parts, decomp: GraphDecomp) -> torch.Tensor:
    """The global (..., n) labels from every rank's part, in rank order
    (each (..., owned_counts[p]), tensors or numpy arrays): the inverse of
    the owned-set permutation.  On the host, for tests and checks."""
    parts = [p.cpu() if isinstance(p, torch.Tensor) else torch.from_numpy(
        np.asarray(p)) for p in parts]
    out = torch.empty(parts[0].shape[:-1] + (decomp.n,),
                      dtype=parts[0].dtype)
    for p, part in enumerate(parts):
        gid = torch.from_numpy(decomp.owned_gid[p, :decomp.owned_counts[p]])
        out[..., gid] = part
    return out

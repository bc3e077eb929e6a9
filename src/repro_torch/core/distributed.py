"""Distributed Path Compression (paper Alg. 1 + Alg. 2) on a block-decomposed
structured grid over `torch.distributed` (port of `repro/core/distributed.py`).

One process per block.  A `DPCMesh` lays a block layout over a process
group: rank r of the group owns the block whose coordinates are r unravelled
row-major in mesh-axis order, the order of JAX's `lax.all_gather` over the
mesh axes, on which the table layout of `BlockDecomp` rests.  Inputs and
outputs are rank-local: each rank passes its own block of the order field or
mask (`BlockDecomp.block_slices` cuts it) with the global grid shape, and
gets back its own block of labels, in global flat ids, and `DPCStats` whose
values are the same on every rank.  No rank builds the global grid.

Grid axis ``a`` (a < k) is split into ``layout[a]`` ceil-division blocks;
the other axes stay whole.  Each block carries one layer of ghost vertices
on every decomposed face, filled by an axis-by-axis halo exchange on the
progressively extended block (so corners arrive by two hops).  Extents that
do not divide are padded up to ``layout * local`` with inert sentinels:
order -1, mask False, label -1 in the boundary table (deviation (p) in
DESIGN.md).

Phases (MS manifolds):
  1. halo exchange of the order field (one send/recv pair per neighbour per
     mesh axis);
  2. steepest init on the extended block through the fused block-local
     kernel (`kernels.ops.fused_local_phase`), ghosts pretending to be maxima
     (Alg. 1 lines 6-8);
  3. local path compression to the block fixpoint;
  4. ONE global communication step: an all-gather of every owned boundary
     face into a replicated flat table (deviation (b) in DESIGN.md), or, with
     ``table_mode="sharded"``, own faces plus a one-hop halo resolved in
     outer exchange rounds (deviation (s));
  5. pointer doubling on the table;
  6. substitution of owned pointers that target a boundary vertex.

Connected components add the local stitch (Alg. 3) and, on the table, the
hook+propagate fixpoint of deviation (d2).

The collectives all go through `DPCMesh`: an axis shift and a general
permute (for `lax.ppermute`; the graph backend's exchange schedule uses the
latter), an all-gather and an all-reduce.  NCCL takes device
tensors.  Gloo is a host transport: with a gloo group and tensors on a
device the mesh copies them to the host and back explicitly, so times taken
over gloo include those copies.  The backend is the caller's choice.
Every rank issues the same collectives in the same order, an empty block
(the trailing blocks of a ragged grid) included.

Each of JAX's `lax.while_loop`s is a Python loop (`core/_table.py`), with
the same round counts; stats come back as 0-d CPU tensors in JAX's dtypes
(int32, float32).

The `_batch` entry points take a (B, *block) stack of one extent and give
(B, *block) labels and `DPCStats` whose fields have a leading (B,) dim, each
item equal to its single call.  A single call is the batch of one.  As under
JAX's `vmap`, each collective fires once for the whole stack: the halo
shifts, the table's all-gather, each exchange round of the sharded table
(for the items that have not reached their fixpoint) and the stats'
reduction.  The fused kernel, the local compression and the table's chase
run item by item, so each item keeps its own round counts.
"""
from __future__ import annotations

import math
from functools import cached_property, lru_cache

import numpy as np
import torch
import torch.distributed as dist

from .. import _meta
from .._device import resolve_device
from ._table import (TableView, chase_view, check_converged, check_table_mode,
                     make_group_max, hook_propagate, sharded_fixpoint_batch,
                     value_substitute)
from .pathcompress import path_compress
from .stats import DPCStats
from .steepest import id_dtype_for, neighbor_offsets, shift_fill

AXIS = "shards"                  # the 1-D layout's axis name (an int layout)
BLOCK_AXES = ("bx", "by", "bz")  # axis names of a tuple layout


# --- the mesh: a block layout over a process group ---------------------------


class DPCMesh:
    """A block layout over a process group of ``prod(layout)`` ranks.

    Rank r of `group` owns the block at ``np.unravel_index(r, layout)``
    (row-major in mesh-axis order).  `coords[a]` is the rank's coordinate
    along mesh axis a (JAX's `lax.axis_index`).  `device` is where the
    entry points run; the collectives below are the only communication of
    the distributed backends.  Each one adds its result-shape bytes to the
    active `_meta.counting`.  On the meta device (a dry run on a fake
    process group) the point-to-point exchanges send nothing: the shift
    returns its fill and the permute zeros, with their bytes counted.
    """

    def __init__(self, layout, names, group, device):
        self.layout = tuple(int(p) for p in layout)
        self.names = tuple(names)
        self.group = group
        self.device = device
        self.size = math.prod(self.layout)
        self.rank = dist.get_rank(group)
        if self.rank < 0:
            raise ValueError("this process is not a rank of the group")
        world = dist.get_world_size(group)
        if world != self.size:
            raise ValueError(f"layout {self.layout} needs {self.size} ranks; "
                             f"the group has {world}")
        self.coords = tuple(int(c) for c in np.unravel_index(self.rank,
                                                             self.layout))
        self.backend = dist.get_backend(group)
        # gloo moves host memory: device tensors are staged through it
        self.staged = self.backend == "gloo" and device.type != "cpu"

    def _global(self, r: int) -> int:
        """Global rank of rank r of the group."""
        return r if self.group is None else dist.get_global_rank(self.group, r)

    def peer(self, a: int, coord: int) -> int:
        """Global rank of the block one step along axis a at `coord`."""
        c = list(self.coords)
        c[a] = coord
        return self._global(int(np.ravel_multi_index(c, self.layout)))

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """`t` as it travels: contiguous, bool as uint8, on the host under
        gloo."""
        t = t.contiguous()
        if t.dtype == torch.bool:
            t = t.view(torch.uint8)
        return t.cpu() if self.staged else t

    @staticmethod
    def _unwire(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if like.dtype == torch.bool:
            w = w.view(torch.bool)
        return w.to(like.device)

    def shift(self, a: int, to_next, to_prev, fill):
        """Axis shift along mesh axis a (JAX's `lax.ppermute` pairs): send
        `to_next` to the block at coordinate +1 and `to_prev` to the one at
        -1; returns (from_prev, from_next), `fill` where the lattice ends.
        Both sides go in one `batch_isend_irecv`.  With layout 2 this is a
        swap: each rank sends once and receives once."""
        from_prev = torch.full_like(to_next, fill)
        from_next = torch.full_like(to_prev, fill)
        L, p = self.layout[a], self.coords[a]
        if L == 1:
            return from_prev, from_next
        for t in (from_prev, from_next):
            _meta.add_collective("collective-permute", _meta.nbytes(t))
        if self.device.type == "meta":
            return from_prev, from_next
        ops, recvs = [], []
        for coord, send, recv in ((p - 1, to_prev, from_prev),
                                  (p + 1, to_next, from_next)):
            if 0 <= coord < L:
                peer = self.peer(a, coord)
                buf = torch.empty_like(self._wire(recv))
                ops.append(dist.P2POp(dist.isend, self._wire(send), peer,
                                      self.group))
                ops.append(dist.P2POp(dist.irecv, buf, peer, self.group))
                recvs.append((recv, buf))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        for recv, buf in recvs:
            recv.copy_(self._unwire(buf, recv))
        return from_prev, from_next

    def permute(self, x: torch.Tensor, pairs) -> torch.Tensor:
        """JAX's `lax.ppermute`: `pairs` is a partial permutation of
        (source, destination) group ranks; this rank sends `x` to its
        destination and returns what its source sent, zeros when it has no
        source.  One `batch_isend_irecv`; a rank in no pair issues
        nothing."""
        pairs = [(int(s), int(d)) for s, d in pairs]
        if len({s for s, _ in pairs}) < len(pairs) \
                or len({d for _, d in pairs}) < len(pairs):
            raise ValueError(f"permute pairs {pairs} repeat a source or a "
                             f"destination")
        out = torch.zeros_like(x)
        _meta.add_collective("collective-permute", _meta.nbytes(out))
        if self.device.type == "meta":
            return out
        ops, buf = [], None
        for src, dst in pairs:
            if src == dst == self.rank:
                out.copy_(x)
                continue
            if src == self.rank:
                ops.append(dist.P2POp(dist.isend, self._wire(x),
                                      self._global(dst), self.group))
            if dst == self.rank:
                buf = torch.empty_like(self._wire(out))
                ops.append(dist.P2POp(dist.irecv, buf, self._global(src),
                                      self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if buf is not None:
            out.copy_(self._unwire(buf, out))
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(ranks, *x.shape): every rank's `x`, in rank order (JAX's
        `lax.all_gather` over all mesh axes)."""
        w = self._wire(x)
        # flat in and out: gloo takes the output as ranks x input along dim 0
        out = torch.empty(self.size * w.numel(), dtype=w.dtype,
                          device=w.device)
        _meta.add_collective("all-gather", _meta.nbytes(out))
        dist.all_gather_into_tensor(out, w.reshape(-1), group=self.group)
        return self._unwire(out.view((self.size,) + tuple(w.shape)), x)

    def all_reduce(self, values, op) -> list:
        """Python ints reduced over the ranks with `op` (`dist.ReduceOp.MAX`,
        MIN or SUM: JAX's pmax, pmin, psum), in one collective."""
        dev = torch.device("cpu") if self.staged else self.device
        t = torch.tensor([int(v) for v in values], dtype=torch.int64,
                         device=dev)
        _meta.add_collective("all-reduce", _meta.nbytes(t))
        dist.all_reduce(t, op=op, group=self.group)
        if t.is_meta:               # no value crossed: each rank's own
            return [int(v) for v in values]
        return t.tolist()

    def pmax(self, *values) -> list:
        return self.all_reduce(values, dist.ReduceOp.MAX)


def make_dpc_mesh(layout, group=None, device=None) -> DPCMesh:
    """Mesh for a block decomposition (the counterpart of JAX's
    `make_dpc_mesh`).

    layout: an int (1-D slabs on the "shards" axis) or a tuple of up to three
    per-axis block counts, e.g. (4, 2) or (2, 2, 2); mesh axis a decomposes
    grid axis a.  group: a process group of ``prod(layout)`` ranks (default:
    the world group of the initialised default process group).  device:
    where the entry points run, ``"cuda"`` unless given (`resolve_device`).
    """
    if isinstance(layout, (int, np.integer)):
        layout, names = (int(layout),), (AXIS,)
    else:
        layout = tuple(int(p) for p in layout)
        if not 1 <= len(layout) <= len(BLOCK_AXES):
            raise ValueError(f"layout {layout} must have 1..3 axes")
        names = BLOCK_AXES[:len(layout)]
    if min(layout) < 1:
        raise ValueError(f"layout {layout} must have positive block counts")
    if not dist.is_initialized():
        raise RuntimeError("make_dpc_mesh needs an initialised default "
                           "process group (torch.distributed."
                           "init_process_group)")
    return DPCMesh(layout, names, group, resolve_device(device))


# --- static decomposition geometry ------------------------------------------


def _stack(parts, xp, axis):
    return (torch.stack(parts, dim=axis) if xp is torch
            else np.stack(parts, axis=axis))


def _concat(parts, xp):
    return torch.cat(parts) if xp is torch else np.concatenate(parts)


class BlockDecomp:
    """Static geometry of an N-D block decomposition of a structured grid
    (a copy of the reference's, numpy for the host side and torch for
    lookups on the device).

    Grid axis a (a < k) is split into ``layout[a]`` blocks of the same
    extent ``local[a] = ceil(grid[a] / layout[a])``; the trailing cells
    (possibly whole trailing blocks) are padding.  The gathered boundary
    table is the concatenation, over decomposed axes a, of
    (nblocks, 2, face_size[a]) segments holding every block's lo/hi owned
    face along a, blocks row-major in mesh-axis order.
    """

    def __init__(self, grid_shape, layout, names):
        self.grid = tuple(int(x) for x in grid_shape)
        self.layout = tuple(int(p) for p in layout)
        self.names = tuple(names)
        self.ndim = len(self.grid)
        self.k = len(self.layout)
        if self.k > self.ndim:
            raise ValueError(f"mesh has {self.k} axes but grid is "
                             f"{self.ndim}-D")
        self.local = tuple(
            -(-self.grid[i] // self.layout[i]) if i < self.k
            else self.grid[i]
            for i in range(self.ndim))
        self.padded = tuple(
            self.local[i] * self.layout[i] if i < self.k else self.grid[i]
            for i in range(self.ndim))
        self.ragged = self.padded != self.grid
        self.ext = tuple(
            self.local[i] + 2 if i < self.k else self.local[i]
            for i in range(self.ndim))
        self.nblocks = math.prod(self.layout)
        self.size = math.prod(self.grid)
        # int64 past 2**31 vertices, as the reference under x64
        self.id_dtype = id_dtype_for(self.size)
        self.stride = tuple(math.prod(self.grid[i + 1:])
                            for i in range(self.ndim))
        self.bstride = tuple(math.prod(self.layout[a + 1:])
                             for a in range(self.k))
        self.face_stride, self.face_size, self.face_offset = [], [], []
        off = 0
        for a in range(self.k):
            st, acc = {}, 1
            for i in reversed([i for i in range(self.ndim) if i != a]):
                st[i] = acc
                acc *= self.local[i]
            self.face_stride.append(st)
            self.face_size.append(acc)
            self.face_offset.append(off)
            off += self.nblocks * 2 * acc
        self.table_size = off
        self.owned_slices = tuple(
            slice(1, self.local[i] + 1) if i < self.k else slice(None)
            for i in range(self.ndim))
        # in-domain table slots (pad slots excluded): f_a valid lo/hi face
        # positions along axis a, each of prod(grid[i != a]) cells
        self.n_valid_slots = 0
        for a in range(self.k):
            L = self.local[a]
            f = sum(int(b * L < self.grid[a]) + int(b * L + L - 1
                                                    < self.grid[a])
                    for b in range(self.layout[a]))
            self.n_valid_slots += f * (self.size // self.grid[a])
        self.pad_fraction = 1.0 - self.size / math.prod(self.padded)
        self._on_device = {}

    def block_slices(self, coords):
        """The slices of the global grid that the block at `coords` owns;
        on a ragged grid shorter than `local`, or empty."""
        out = []
        for i in range(self.ndim):
            if i < self.k:
                lo = min(coords[i] * self.local[i], self.grid[i])
                out.append(slice(lo, min(lo + self.local[i], self.grid[i])))
            else:
                out.append(slice(0, self.grid[i]))
        return tuple(out)

    def ghost_mask(self) -> np.ndarray:
        """Boolean ext-block array marking the ghost layers."""
        m = np.zeros(self.ext, bool)
        for a in range(self.k):
            idx = [slice(None)] * self.ndim
            idx[a] = 0
            m[tuple(idx)] = True
            idx[a] = self.ext[a] - 1
            m[tuple(idx)] = True
        return m

    def boundary_pos(self, g, xp=torch):
        """Map global flat ids to their canonical slot in the gathered
        boundary table: (is_boundary, flat slot), in g's dtype.  A vertex on
        several faces is canonicalised to the lowest decomposed axis.
        Defined for in-domain ids only (pad slots carry the sentinel -1 and
        never reach a lookup).  `xp` is torch or numpy."""
        xs = [(g // self.stride[i]) % self.grid[i] for i in range(self.ndim)]
        B = 0
        for a in range(self.k):
            B = B + (xs[a] // self.local[a]) * self.bstride[a]
        is_b = xp.zeros_like(g, dtype=xp.bool_ if xp is np else torch.bool)
        pos = xp.zeros_like(g)
        for a in reversed(range(self.k)):
            L = self.local[a]
            xin = xs[a] % L
            on = (xin == 0) | (xin == L - 1)
            # 1 on the hi face (and for L == 1, where both faces coincide)
            j = 1 if L == 1 else xin // (L - 1)
            r = 0
            for i in range(self.ndim):
                if i != a:
                    r = r + (xs[i] % self.local[i]) * self.face_stride[a][i]
            p = self.face_offset[a] + (B * 2 + j) * self.face_size[a] + r
            pos = xp.where(on, p, pos)
            is_b = is_b | on
        return is_b, pos

    @cached_property
    def boundary_coords(self) -> np.ndarray:
        """(table_size, ndim) int32 global coordinates of every table slot,
        built once per decomposition on the host."""
        return np.asarray(self.slot_coords(np), dtype=np.int32)

    def slot_coords(self, xp=torch):
        """(table_size, ndim) global coordinates of every table slot (prefer
        the cached `boundary_coords`)."""
        parts = []
        for a in range(self.k):
            F = self.face_size[a]
            s = xp.arange(self.nblocks * 2 * F, dtype=xp.int32)
            B, j, r = s // (2 * F), (s % (2 * F)) // F, s % F
            cols = []
            for i in range(self.ndim):
                if i == a:
                    c = ((B // self.bstride[a]) % self.layout[a]
                         * self.local[a] + j * (self.local[a] - 1))
                else:
                    c = (r // self.face_stride[a][i]) % self.local[i]
                    if i < self.k:
                        c = ((B // self.bstride[i]) % self.layout[i]
                             * self.local[i] + c)
                cols.append(c)
            parts.append(_stack(cols, xp, 1))
        return _concat(parts, xp)

    def on_device(self, name: str, device) -> torch.Tensor:
        """`boundary_coords` or `ghost_mask()` as a tensor on `device`,
        uploaded once per decomposition and device (on the meta device,
        its shape only: no host table is built)."""
        key = (name, str(device))
        if torch.device(device).type == "meta":
            if name == "coords":
                return torch.empty((self.table_size, self.ndim),
                                   dtype=torch.int32, device=device)
            return torch.empty(self.ext, dtype=torch.bool, device=device)
        if key not in self._on_device:
            host = self.boundary_coords if name == "coords" \
                else self.ghost_mask()
            self._on_device[key] = torch.from_numpy(host).to(device)
        return self._on_device[key]


@lru_cache(maxsize=128)
def _decomp_cached(grid, layout, names) -> BlockDecomp:
    return BlockDecomp(grid, layout, names)


def _decomp_for(mesh: DPCMesh, grid_shape) -> BlockDecomp:
    """One BlockDecomp per (grid, layout), shared by repeated calls."""
    return _decomp_cached(tuple(int(x) for x in grid_shape), mesh.layout,
                          mesh.names)


# --- helpers inside a block ----------------------------------------------------


def _pad_block(x, dec: BlockDecomp, mesh: DPCMesh, fill):
    """The rank's (B, *block) stack on the mesh's device, each block padded
    up to `dec.local` with the phase's inert sentinel (order -1 / mask
    False)."""
    want = tuple(s.stop - s.start for s in dec.block_slices(mesh.coords))
    if tuple(x.shape[1:]) != want:
        raise ValueError(f"rank {mesh.rank} owns the block "
                         f"{dec.block_slices(mesh.coords)} of the grid "
                         f"{dec.grid}, of shape {want}; got "
                         f"{tuple(x.shape[1:])}")
    if x.shape[0] == 0:
        raise ValueError("a batch needs at least one item")
    x = x.to(mesh.device)
    if want == dec.local:
        return x.contiguous()
    out = torch.full((x.shape[0],) + dec.local, fill, dtype=x.dtype,
                     device=mesh.device)
    out[(slice(None),) + tuple(slice(0, n) for n in want)] = x
    return out


def _owned_valid(dec: BlockDecomp, mesh: DPCMesh):
    """Boolean owned-block array marking in-domain (non-pad) cells."""
    total = None
    for a in range(dec.k):
        x = mesh.coords[a] * dec.local[a] + torch.arange(
            dec.local[a], device=mesh.device)
        shape = [1] * dec.ndim
        shape[a] = -1
        v = (x < dec.grid[a]).reshape(shape)
        total = v if total is None else total & v
    return total.expand(dec.local)


def _halo_extend(ext, a, mesh: DPCMesh, fill):
    """Extend the (B, *block) stack `ext` with one ghost slab per face along
    grid axis `a`, exchanged over mesh axis `a` (fill at the domain
    boundary).  Applied axis by axis, so later axes forward earlier ghosts
    into the corners."""
    d = a + 1
    lo, hi = mesh.shift(a, to_next=ext.narrow(d, ext.shape[d] - 1, 1),
                        to_prev=ext.narrow(d, 0, 1), fill=fill)
    return torch.cat([lo, ext, hi], dim=d)


def _extend(blocks, dec: BlockDecomp, mesh: DPCMesh, fill):
    """The (B, *ext) extended blocks: one shift pair a mesh axis for the
    whole stack."""
    for a in range(dec.k):
        blocks = _halo_extend(blocks, a, mesh, fill)
    return blocks


def _gid_of(local, dec: BlockDecomp, mesh: DPCMesh):
    """Global flat ids of extended-block positions given by their flat local
    ids (the reference's `_gid_map`, evaluated where it is read; ids < 0
    stay -1).  Out-of-domain ghost coordinates give ids that no pointer
    reaches: their order or mask fill keeps them off every path."""
    rest, g = local.to(dec.id_dtype).clamp(min=0), 0
    for i in reversed(range(dec.ndim)):
        x = rest % dec.ext[i]
        rest = rest // dec.ext[i]
        if i < dec.k:
            x = x + (mesh.coords[i] * dec.local[i] - 1)
        g = g + x * dec.stride[i]
    return torch.where(local >= 0, g, -1)


def _look_up(values, g, slot_of):
    """`g` taken through a table view: the entry of `values` at g's slot
    where `slot_of(g) -> (has a slot, slot)` gives one, else g itself; -1
    stays -1.  The table chase, the sharded view's lookup and the final
    substitution (Alg. 2 lines 27-33) are all this step."""
    ok, idx = slot_of(g.clamp(min=0))
    return torch.where((g >= 0) & ok,
                       values.index_select(0, idx.clamp(0,
                                                        values.numel() - 1)),
                       g)


def _through_roots(d, dec: BlockDecomp, mesh: DPCMesh, substitute):
    """The owned block's final labels, flat: `substitute` (global label ->
    final label, the table's substitution step) applied to the global id of
    each owned pointer's target, -1 where the pointer is -1.  After the
    local fixpoint every pointer targets a root (d[r] == r), so
    `substitute` runs on the roots only and the owned pointers read its
    results by one gather; the reference evaluates it on every owned
    vertex."""
    n = d.numel()
    roots = _meta.nonzero(d == torch.arange(n, dtype=d.dtype,
                                            device=d.device))
    final = torch.empty(n, dtype=dec.id_dtype, device=d.device)
    final[roots] = substitute(_gid_of(roots, dec, mesh))
    owned = d.reshape(dec.ext)[dec.owned_slices].reshape(-1)
    return torch.where(owned >= 0, final.index_select(0, owned.clamp(min=0)),
                       -1)


def _own_faces(owned, dec: BlockDecomp):
    """This rank's row chunk of the boundary table: the block's lo/hi face
    along each decomposed axis, flattened as one block's segment of the
    gathered table."""
    parts = []
    for a in range(dec.k):
        parts.append(owned.select(a, 0).reshape(-1))
        parts.append(owned.select(a, dec.local[a] - 1).reshape(-1))
    return torch.cat(parts)


def _faces(ds, dec: BlockDecomp, mesh: DPCMesh):
    """(B, rows) own faces of each item's local pointers, in global ids."""
    return torch.stack([_gid_of(_own_faces(d.reshape(dec.ext)[
        dec.owned_slices], dec), dec, mesh) for d in ds])


def _gather_table(faces, dec: BlockDecomp, mesh: DPCMesh):
    """The single communication phase: one all-gather of every rank's
    (B, rows) own faces (`_own_faces`), giving each item's table laid out
    as `BlockDecomp.boundary_pos` expects (per axis, every block's lo and
    hi face): (B, table_size)."""
    rows = mesh.all_gather(faces)                   # (nblocks, B, rows)
    parts = []
    for a in range(dec.k):
        lo = dec.face_offset[a] // dec.nblocks
        parts.append(rows[:, :, lo:lo + 2 * dec.face_size[a]].transpose(
            0, 1).reshape(faces.shape[0], -1))
    return torch.cat(parts, dim=1)


def _table_compress(T, dec: BlockDecomp, max_iter=64):
    """Pointer doubling on the gathered table (Alg. 2 lines 15-25); entries
    < 0 and non-boundary targets are fixed.  Returns (table, iters, ok)."""
    view, iters, ok = chase_view(TableView(
        T, lambda t: _look_up(t, t, dec.boundary_pos), T.numel()), max_iter)
    return view.values, iters, ok


def _cut_edges(coords, row_ok, slot_of, M, dec: BlockDecomp, connectivity):
    """(dst, src) slot pairs of every masked stencil edge between two slots
    of a view: `coords` (n, ndim) global coordinates of the view's slots,
    `row_ok` None or the slots whose coordinates are real, `slot_of(g)` ->
    (ok, slot) for global ids g, `M` the view's bool mask.  The edges are
    static for a call, so they are found once; the reference finds them in
    every round."""
    grid = torch.tensor(dec.grid, dtype=torch.int32, device=coords.device)
    dst, src = [], []
    for off in neighbor_offsets(dec.ndim, connectivity):
        nx = coords + torch.tensor(off, dtype=torch.int32,
                                   device=coords.device)
        ok = ((nx >= 0) & (nx < grid)).all(dim=1)
        if row_ok is not None:
            ok &= row_ok
        g = 0
        for i in range(dec.ndim):
            g = g + nx[:, i].clamp(0, dec.grid[i] - 1).to(
                dec.id_dtype) * dec.stride[i]
        in_view, slot = slot_of(g)
        slot = slot.clamp(0, M.numel() - 1).long()
        edge = _meta.nonzero(ok & in_view & M & M[slot])
        dst.append(edge)
        src.append(slot[edge])
    return torch.cat(dst), torch.cat(src)


def _cut_max_fn(dst, src):
    """max across the masked cut edges: best[v] = max(L[v], L[u]) over the
    edges (v, u), the reference's per-offset `where(max)` in one scatter."""
    def cut_max(L):
        return L.clone().scatter_reduce_(0, dst, L.index_select(0, src),
                                         "amax")
    return cut_max


# --- sharded boundary table (table_mode="sharded", deviation (s)) ------------


class _ShardGeom:
    """Geometry of the sharded boundary-table stack on one rank (deviation
    (s) in DESIGN.md §Table-sharding).

    The stack is `n_chunks` copies of the per-block face-row layout (`rows`
    = both faces of every decomposed axis, `_own_faces` order): chunk 0 the
    rank's own faces, the rest a one-hop halo of lattice-neighbour blocks.
    Axes of layout 1 add no halo; layout 2 adds one chunk (the swap
    partner); layout >= 3 lo and hi chunks, filled with inert sentinels at
    the lattice's ends.  Where the stencil reaches no diagonal block pair
    the chunk set is the von Neumann star (1 + sum(sz - 1) chunks), else the
    Moore product (prod(sz)), built by forwarding axis by axis.
    """

    def __init__(self, dec: BlockDecomp, mesh: DPCMesh, connectivity: int):
        self.dec, self.mesh = dec, mesh
        self.rows = dec.table_size // dec.nblocks
        self.local_off = [dec.face_offset[a] // dec.nblocks
                          for a in range(dec.k)]
        self.act = [a for a in range(dec.k) if dec.layout[a] > 1]
        self.sz = {a: (2 if dec.layout[a] == 2 else 3) for a in self.act}
        offs = neighbor_offsets(dec.ndim, connectivity)
        self.moore = any(
            sum(1 for a in self.act if off[a] != 0) >= 2 for off in offs)
        if self.moore:
            self.n_chunks = math.prod(self.sz[a] for a in self.act)
        else:
            self.n_chunks, self.vn_base = 1, {}
            for a in self.act:
                self.vn_base[a] = self.n_chunks
                self.n_chunks += self.sz[a] - 1
        self.stack_size = self.n_chunks * self.rows

    def exchange_fn(self, fill):
        """One halo-exchange round: (B, rows) own chunks -> (B, stack_size)
        stacks with the own chunk leading, one shift pair a mesh axis for
        the whole batch.  The Moore variant forwards the partial stack axis
        by axis, so diagonal chunks arrive by two hops; its chunk order is
        the reference's (`jnp.stack` along a growing axis)."""
        mesh = self.mesh

        def axis_parts(src, a):
            from_prev, from_next = mesh.shift(a, to_next=src, to_prev=src,
                                              fill=fill)
            if self.dec.layout[a] == 2:          # the swap partner's chunk
                return [from_prev if mesh.coords[a] == 1 else from_next]
            return [from_prev, from_next]

        if self.moore:
            def exchange(own):
                S = own
                for dims, a in enumerate(self.act):
                    S = torch.stack([S] + axis_parts(S, a), dim=dims + 1)
                return S.reshape(own.shape[0], -1)
        else:
            def exchange(own):
                chunks = [own]
                for a in self.act:
                    chunks.extend(axis_parts(own, a))
                return torch.cat(chunks, dim=1)
        return exchange

    def pos_to_stack(self, s):
        """Global table slot -> (in_stack, flat stack index); callers gate on
        `is_boundary` (and validity) before trusting either."""
        dec = self.dec
        row = torch.zeros_like(s)
        B = torch.zeros_like(s)
        for a in range(dec.k):
            F2 = 2 * dec.face_size[a]
            off = dec.face_offset[a]
            within = (s >= off) & (s < off + dec.nblocks * F2)
            t = torch.where(within, s - off, 0)
            row = torch.where(within, self.local_off[a] + t % F2, row)
            B = torch.where(within, t // F2, B)
        row, B = row.to(torch.int32), B.to(torch.int32)
        ok = torch.ones_like(row, dtype=torch.bool)
        chunk = torch.zeros_like(row)
        nnz = torch.zeros_like(row)
        pos = {}
        for a in self.act:
            d = (B // dec.bstride[a]) % dec.layout[a] - self.mesh.coords[a]
            if dec.layout[a] == 2:
                pa = (d != 0).to(torch.int32)
            else:
                ok &= d.abs() <= 1
                pa = torch.where(d == -1, 1, 2).to(torch.int32)
                pa = torch.where(d == 0, 0, pa)
            pos[a] = pa
            nnz = nnz + (pa > 0).to(torch.int32)
        if self.moore:
            for a in self.act:
                chunk = chunk * self.sz[a] + pos[a]
        else:
            ok &= nnz <= 1
            for a in self.act:
                chunk = chunk + torch.where(pos[a] > 0,
                                            self.vn_base[a] + pos[a] - 1, 0)
        return ok, chunk * self.rows + row

    def slot_of(self, g):
        """Global id -> (is a boundary slot in this stack, stack index)."""
        is_b, s = self.dec.boundary_pos(g)
        ok, idx = self.pos_to_stack(s)
        return is_b & ok, idx

    def _chunk_block_coords(self, ci: int):
        """Per-axis block coordinates of chunk `ci` on this rank."""
        dec, mesh = self.dec, self.mesh
        pos = {a: 0 for a in range(dec.k)}
        if self.moore:
            rest = ci
            for a in reversed(self.act):
                pos[a] = rest % self.sz[a]
                rest //= self.sz[a]
        else:
            for a in self.act:
                if self.vn_base[a] <= ci < self.vn_base[a] + self.sz[a] - 1:
                    pos[a] = ci - self.vn_base[a] + 1
        bc = []
        for a in range(dec.k):
            p = mesh.coords[a]
            if pos[a] == 0:
                bc.append(p)
            elif dec.layout[a] == 2:
                bc.append(1 - p)            # the swap partner
            else:
                bc.append(p - 1 if pos[a] == 1 else p + 1)
        return bc

    def stack_coords(self, coords):
        """(stack_size, ndim) global coordinates of every stack slot and a
        per-slot validity mask (False on lattice-edge fill chunks), rows
        gathered per chunk from the slot-coordinate table `coords`."""
        dec = self.dec
        r_i = torch.arange(self.rows, dtype=torch.int64, device=coords.device)
        parts, valids = [], []
        for ci in range(self.n_chunks):
            bc = self._chunk_block_coords(ci)
            valid = all(0 <= bc[a] < dec.layout[a] for a in range(dec.k))
            B = sum(min(max(bc[a], 0), dec.layout[a] - 1) * dec.bstride[a]
                    for a in range(dec.k))
            gidx = torch.zeros_like(r_i)
            for a in range(dec.k):
                lo = self.local_off[a]
                F2 = 2 * dec.face_size[a]
                within = (r_i >= lo) & (r_i < lo + F2)
                gidx = torch.where(
                    within, dec.face_offset[a] + B * F2 + (r_i - lo), gidx)
            parts.append(coords[gidx])
            valids.append(torch.full((self.rows,), valid, dtype=torch.bool,
                                     device=coords.device))
        return torch.cat(parts), torch.cat(valids)


def _reduce_any_fn(mesh: DPCMesh):
    """Each item's "changed" flag OR-ed over the ranks, one all-reduce for
    the batch."""
    def reduce_any(flags):
        return [v > 0 for v in mesh.pmax(*(bool(f) for f in flags))]
    return reduce_any


def _pmax_lists(mesh: DPCMesh, *lists):
    """Lists of per-item ints, each element reduced by max over the ranks,
    all in one all-reduce."""
    flat = mesh.pmax(*(v for values in lists for v in values))
    B = len(lists[0])
    return [flat[i * B:(i + 1) * B] for i in range(len(lists))]


def _i32(v):
    return torch.tensor(v, dtype=torch.int32)


def _f32(v):
    return torch.tensor(v, dtype=torch.float32)


def _item(stats):
    """Item 0 of batched stats: 0-d fields, a single call's stats."""
    return type(stats)(*(v[0] for v in stats))


# --- MS manifolds ------------------------------------------------------------


def _sharded_manifold_resolve(T0, dec: BlockDecomp, mesh: DPCMesh,
                              connectivity, max_iter: int):
    """Sharded replacement of steps 4-6 for manifolds: a neighbour-relay
    fixpoint on the own+halo stack, from the (B, rows) own faces `T0`.
    Each outer round rebuilds the view from fresh estimates and re-chases
    every own slot from its original one-hop pointer; it converges to the
    chains' terminals, the values the replicated chase gives (DESIGN.md
    §Table-sharding).  Returns each item's substitution (global label ->
    final label) with the geometry and the fixpoint's per-item counts."""
    geom = _ShardGeom(dec, mesh, connectivity)

    def lookup(t):
        return _look_up(t, t, geom.slot_of)

    def refine(stack, b):
        stack = stack.clone()
        stack[:geom.rows] = T0[b]
        view, iters, ok = chase_view(TableView(stack, lookup, geom.rows),
                                     max_iter)
        return view.values, iters, ok

    stacks, _, rounds, iters, ok = sharded_fixpoint_batch(
        T0, geom.exchange_fn(-1), refine, _reduce_any_fn(mesh),
        max_rounds=max_iter)
    subs = [lambda o, s=s: _look_up(s, o, geom.slot_of) for s in stacks]
    return subs, geom, rounds, iters, ok


def _manifold_block(orders, dec: BlockDecomp, mesh: DPCMesh, connectivity,
                    fused_impl: str, table_mode: str, table_max_iter: int):
    """(B, *local) padded order blocks -> ((B, *local) labels, DPCStats with
    (B,) fields).  Always the descending direction; the ascending manifold
    flips the order field first (keeps the -1 halo fill below every
    candidate)."""
    from ..kernels import ops   # lazy: the kernels import core.steepest
    B = orders.shape[0]

    # 1. order halo (fill -1: below every real order value, never steepest)
    ext = _extend(orders, dec, mesh, -1)

    # 2.+3a. fused steepest init + in-slab saturation in local ids, ghosts
    #    pretending to be maxima (Alg. 1 lines 6-8); 3. local compression
    #    to the block fixpoint; item by item
    ghost = dec.on_device("ghost", mesh.device)
    ds, kernel_rounds, local_iters = [], [], []
    for x in ext:
        d, r = ops.fused_local_phase(x, connectivity, mode="manifold",
                                     self_mask=ghost, impl=fused_impl)
        d, it = path_compress(d.reshape(-1))
        ds.append(d)
        kernel_rounds.append(r)
        local_iters.append(it)
    del ext, x, d

    # 4. the own faces in global ids; pad cells of a ragged block carry the
    #    sentinel -1
    faces = _faces(ds, dec, mesh)
    if dec.ragged:
        faces = torch.where(_own_faces(_owned_valid(dec, mesh), dec), faces,
                            -1)
    isz = torch.tensor([], dtype=dec.id_dtype).element_size()

    if table_mode == "replicated":
        # 4. the single communication phase + 5. table compression
        subs, table_iters, not_ok = [], [], []
        for T in _gather_table(faces, dec, mesh):
            T, it, ok = _table_compress(T, dec, table_max_iter)
            # Alg. 2 lines 27-33
            subs.append(lambda o, T=T: _look_up(T, o, dec.boundary_pos))
            table_iters.append(it)
            not_ok.append(int(not ok))
        exch_rounds = [0] * B
        comm = [1] * B
        ghost_bytes = _f32(dec.n_valid_slots * isz).repeat(B)
        table_bytes = _f32(dec.table_size * isz).repeat(B)
    else:
        subs, geom, exch_rounds, table_iters, ok = \
            _sharded_manifold_resolve(faces, dec, mesh, connectivity,
                                      table_max_iter)
        not_ok = [int(not o) for o in ok]
        comm = exch_rounds                 # one exchange phase per round
        halo = geom.stack_size - geom.rows
        ghost_bytes = _f32(halo * isz) * _f32(exch_rounds)
        table_bytes = _f32((geom.stack_size + geom.rows) * isz).repeat(B)

    # 6. final substitution
    finals = [_through_roots(d, dec, mesh, sub) for d, sub in zip(ds, subs)]
    final = torch.stack(finals)
    if dec.ragged:
        final = torch.where(_owned_valid(dec, mesh).reshape(-1), final, -1)

    # the table's counts are the same on every rank in replicated mode
    li, kr, ti, bad = _pmax_lists(mesh, local_iters, kernel_rounds,
                                  table_iters, not_ok)
    stats = DPCStats(
        local_iters=_i32(li),
        table_iters=_i32(ti),
        stitch_rounds=_i32([0] * B),
        ghost_bytes=ghost_bytes,
        masked_ghost_fraction=_f32([1.0] * B),
        pad_fraction=_f32(dec.pad_fraction).repeat(B),
        comm_phases=_i32(comm),
        kernel_rounds=_i32(kr),
        global_iters_saved=_i32([max(k - i, 0) for k, i in zip(kr, li)]),
        table_bytes_peak=table_bytes,
        exchange_rounds=_i32(exch_rounds),
        converged=_i32([1 - v for v in bad]),
    )
    return final.reshape((B,) + dec.local), stats


def _real(labels, dec: BlockDecomp, mesh: DPCMesh):
    """The padded (B, *local) labels cut to the block the rank owns."""
    want = dec.block_slices(mesh.coords)
    return labels[(slice(None),) + tuple(slice(0, s.stop - s.start)
                                         for s in want)].contiguous()


def _manifolds(orders, mesh, grid_shape, connectivity, descending,
               fused_impl, table_mode, table_max_iter, what):
    check_table_mode(table_mode)
    dec = _decomp_for(mesh, grid_shape)
    if not descending:
        # the GLOBAL grid's size, not the block's
        orders = dec.size - 1 - orders
    orders = _pad_block(orders, dec, mesh, -1)
    labels, stats = _manifold_block(orders, dec, mesh, connectivity,
                                    fused_impl, table_mode, table_max_iter)
    check_converged(stats.converged, what, table_max_iter)
    return _real(labels, dec, mesh), stats


def distributed_manifold(order, mesh: DPCMesh, grid_shape,
                         connectivity: int = 6, descending: bool = True,
                         fused_impl: str = "auto",
                         table_mode: str = "replicated",
                         table_max_iter: int = 64):
    """Descending (or ascending) manifold of a block-decomposed order field.

    order: this rank's block of the global int order field of extent
    `grid_shape` (`BlockDecomp.block_slices(mesh.coords)`; any extent, the
    grid is padded with inert sentinels, deviation (p) in DESIGN.md).
    Returns this rank's block of labels (global flat ids, on
    `mesh.device`) and DPCStats equal on every rank.  fused_impl selects
    the block-local phase (`kernels.ops.fused_local_phase`); table_mode
    picks the boundary-table layout, "replicated" (one all-gather) or
    "sharded" (own faces + one-hop halo, outer exchange rounds, deviation
    (s)); labels are bit-identical across all choices.
    """
    labels, stats = _manifolds(order[None], mesh, grid_shape, connectivity,
                               descending, fused_impl, table_mode,
                               table_max_iter, "distributed_manifold")
    return labels[0], _item(stats)


def distributed_manifold_batch(orders, mesh: DPCMesh, grid_shape,
                               connectivity: int = 6,
                               descending: bool = True,
                               fused_impl: str = "auto",
                               table_mode: str = "replicated",
                               table_max_iter: int = 64):
    """Batched `distributed_manifold`: `orders` is a (B, *block) stack of
    this rank's blocks of B order fields of one extent `grid_shape`;
    returns ((B, *block) labels, DPCStats with a leading (B,) dim), each
    item equal to its single call.  The collectives fire once for the
    batch (module docstring)."""
    return _manifolds(orders, mesh, grid_shape, connectivity, descending,
                      fused_impl, table_mode, table_max_iter,
                      "distributed_manifold_batch")


# --- connected components ----------------------------------------------------


def _ext_stitch(d, mask_ext, connectivity):
    """Stitch on the extended block in local ids (Alg. 3 lines 25-29):
    scatter-max at position out[v], reading each offset's target from the
    running `out` (not from `d`, as the pure path's stitch does) and
    requiring u's label >= 0, as the reference does.  The invalid pairs are
    dropped before the scatter: the reference sends them to a sentinel slot
    that its scatter drops."""
    out = d.clone()
    dg = d.reshape(mask_ext.shape)
    m = mask_ext.reshape(-1)
    for off in neighbor_offsets(mask_ext.ndim, connectivity):
        u_label = shift_fill(dg, off, -1).reshape(-1)
        valid = m & shift_fill(mask_ext, off, False).reshape(-1) \
            & (u_label >= 0)
        tgt = _meta.select(out, valid).long()
        out.scatter_reduce_(0, tgt, _meta.select(u_label, valid), "amax")
    return out


def _cc_local_fixpoint(d, mask_ext, connectivity, max_rounds=64):
    """(labels, stitch rounds, compression iters, first compression's
    iters)."""
    d, it0 = path_compress(d)
    rounds, its, changed = 0, it0, True
    while changed and rounds < max_rounds:
        nxt, it = path_compress(_ext_stitch(d, mask_ext, connectivity))
        changed = _meta.again((nxt != d).any())
        d, rounds, its = nxt, rounds + 1, its + it
    return d, rounds, its, it0


def _table_propagate(Tstar, Mflat, coords, dec: BlockDecomp, connectivity,
                     max_iter=64):
    """Hook + propagate on the gathered table (deviation (d2)): the fixpoint
    of (a) the max across masked stencil edges between boundary slots and
    (b) the max within equal-original-label groups.  Gives every boundary
    slot the largest label of its global component."""
    group_max, perm, sorted_vals = make_group_max(Tstar)
    cut_max = _cut_max_fn(*_cut_edges(coords, None, dec.boundary_pos, Mflat,
                                      dec, connectivity))
    L, iters, ok = hook_propagate(Tstar, cut_max, group_max, max_iter)
    return L, (perm, sorted_vals), iters, ok


def _cc_substitute(values, slot_of, sorted_vals, g_sorted):
    """CC's substitution (global label -> final label): chase the label
    through the table view `values`, then take its group's propagated
    maximum (value search)."""
    return lambda o: value_substitute(o, _look_up(values, o, slot_of),
                                      sorted_vals, g_sorted)


def _sharded_cc_resolve(T0, M0, coords, dec: BlockDecomp, mesh: DPCMesh,
                        connectivity, gather_mask: bool, max_iter: int):
    """Sharded replacement of CC steps 4-6 from the (B, rows) own faces'
    labels `T0` and mask `M0`: a max-flooding fixpoint on the own+halo
    stack (masked cut edges between in-stack slots + equal-original-label
    groups within the stack), whose fixpoint is each component's max vertex
    id, the value the replicated path computes.  The static label and mask
    stacks are exchanged once; each outer round exchanges only the evolving
    estimates.  Returns each item's substitution (global label -> final
    label), the (B, stack) mask stacks, the geometry and the fixpoint's
    per-item counts."""
    geom = _ShardGeom(dec, mesh, connectivity)
    exchange = geom.exchange_fn(-1)
    T0s = exchange(T0)                       # static: group structure
    if gather_mask:
        Ms = geom.exchange_fn(False)(M0)
    else:
        Ms = T0s >= 0                        # labels are -1 iff unmasked
    groups = [make_group_max(t) for t in T0s]
    scoords, svalid = geom.stack_coords(coords)
    cut_maxes = [_cut_max_fn(*_cut_edges(scoords, svalid, geom.slot_of, m,
                                         dec, connectivity)) for m in Ms]

    def refine(stack, b):
        return hook_propagate(stack, cut_maxes[b], groups[b][0], max_iter)

    stacks, _, rounds, iters, ok = sharded_fixpoint_batch(
        T0, exchange, refine, _reduce_any_fn(mesh), max_rounds=max_iter)

    # substitution: the flooded value at the own label's slot when it has
    # one, then the value search over the static stack labels (an interior
    # root shares its value with its piece's cut vertices)
    subs = [_cc_substitute(s, geom.slot_of, sorted_vals,
                           s.index_select(0, perm))
            for s, (_, perm, sorted_vals) in zip(stacks, groups)]
    return subs, Ms, geom, rounds, iters, ok


def _cc_block(masks, dec: BlockDecomp, mesh: DPCMesh, connectivity,
              gather_mask: bool, fused_impl: str, table_mode: str,
              table_max_iter: int):
    """(B, *local) padded mask blocks -> ((B, *local) labels, DPCStats with
    (B,) fields).  gather_mask=False drops the mask exchange: the boundary
    mask is exactly (T >= 0), labels being -1 where unmasked
    (bit-identical)."""
    from ..kernels import ops   # lazy: the kernels import core.steepest
    B = masks.shape[0]

    # 1. mask halo (fill False: the domain boundary is never masked)
    ext = _extend(masks, dec, mesh, False)

    # 2. fused init: largest masked neighbour id, masked ghosts pretending
    #    self, saturated in-slab by the kernel path; 3. local CC fixpoint
    #    (stitch + compress, Alg. 3); item by item
    ghost = dec.on_device("ghost", mesh.device)
    ds, kernel_rounds, stitch_rounds, local_iters, first = [], [], [], [], []
    for x in ext:
        d, r = ops.fused_local_phase(x, connectivity, mode="cc",
                                     self_mask=ghost, impl=fused_impl)
        d, sr, its, it0 = _cc_local_fixpoint(d.reshape(-1), x, connectivity)
        ds.append(d)
        kernel_rounds.append(r)
        stitch_rounds.append(sr)
        local_iters.append(its)
        first.append(it0)

    # 4. the own faces: labels in global ids (-1 where unmasked) and mask
    faces = _faces(ds, dec, mesh)
    mask_faces = torch.stack([_own_faces(x[dec.owned_slices], dec)
                              for x in ext])
    del ext, x, d
    isz = torch.tensor([], dtype=dec.id_dtype).element_size()
    coords = dec.on_device("coords", mesh.device)

    if table_mode == "replicated":
        # 4b. the single communication phase: labels (+ masks)
        T = _gather_table(faces, dec, mesh)
        M = _gather_table(mask_faces, dec, mesh) if gather_mask else T >= 0
        subs, table_iters, not_ok = [], [], []
        for t, m in zip(T, M):
            # 5a. positional chase (the paper's table compression)
            Tstar, chase_iters, chase_ok = _table_compress(t, dec,
                                                           table_max_iter)
            # 5b. hook + propagate (deviation (d2)): merge labels across
            #     cuts
            G, (perm, sorted_vals), prop_iters, prop_ok = _table_propagate(
                Tstar, m, coords, dec, connectivity, table_max_iter)
            # 6. substitution: chase the own label through the table, then
            #    take its group's propagated maximum (value search)
            subs.append(_cc_substitute(Tstar, dec.boundary_pos, sorted_vals,
                                       G.index_select(0, perm)))
            table_iters.append(chase_iters + prop_iters)
            not_ok.append(int(not (chase_ok and prop_ok)))
        comm, exch_rounds = [1] * B, [0] * B
        ghost_bytes = (_f32(dec.n_valid_slots * isz) + (
            _f32(dec.n_valid_slots) if gather_mask else 0.0)).repeat(B)
        table_bytes = _f32(dec.table_size * (isz + 1)).repeat(B)
        masked = [_meta.read_int(m.sum()) for m in M]
    else:
        # 4b-6. sharded: max-flooding on the own+halo stack (no gather)
        subs, Ms, geom, exch_rounds, table_iters, ok = _sharded_cc_resolve(
            faces, mask_faces, coords, dec, mesh, connectivity, gather_mask,
            table_max_iter)
        not_ok = [int(not o) for o in ok]
        comm = [r + 1 for r in exch_rounds]  # +1: the static label/mask stack
        halo = geom.stack_size - geom.rows
        ghost_bytes = (_f32(halo * isz) * (_f32(exch_rounds) + 1.0)
                       + (_f32(halo) if gather_mask else 0.0))
        # evolving stack + static label stack + own chunk + bool mask stack
        table_bytes = _f32((2 * geom.stack_size + geom.rows) * isz
                           + geom.stack_size).repeat(B)
        # over in-domain slots (pad slots are mask False); the count is
        # summed as an integer, exact where JAX's float32 psum is
        masked = mesh.all_reduce([_meta.read_int(m[:geom.rows].sum())
                                  for m in Ms],
                                 dist.ReduceOp.SUM)
    masked_frac = _f32(masked) / _f32(max(dec.n_valid_slots, 1))

    final = torch.stack([_through_roots(d, dec, mesh, sub)
                         for d, sub in zip(ds, subs)])
    li, sr, kr, i0, ti, bad = _pmax_lists(mesh, local_iters, stitch_rounds,
                                          kernel_rounds, first, table_iters,
                                          not_ok)
    stats = DPCStats(
        local_iters=_i32(li),
        table_iters=_i32(ti),
        stitch_rounds=_i32(sr),
        ghost_bytes=ghost_bytes,
        masked_ghost_fraction=masked_frac,
        pad_fraction=_f32(dec.pad_fraction).repeat(B),
        comm_phases=_i32(comm),
        kernel_rounds=_i32(kr),
        # the kernel pre-saturates the first compression only
        global_iters_saved=_i32([max(k - i, 0) for k, i in zip(kr, i0)]),
        table_bytes_peak=table_bytes,
        exchange_rounds=_i32(exch_rounds),
        converged=_i32([1 - v for v in bad]),
    )
    return final.reshape((B,) + dec.local), stats


def _components(masks, mesh, grid_shape, connectivity, gather_mask,
                fused_impl, table_mode, table_max_iter, what):
    check_table_mode(table_mode)
    dec = _decomp_for(mesh, grid_shape)
    masks = _pad_block(masks.bool(), dec, mesh, False)
    labels, stats = _cc_block(masks, dec, mesh, connectivity, gather_mask,
                              fused_impl, table_mode, table_max_iter)
    check_converged(stats.converged, what, table_max_iter)
    return _real(labels, dec, mesh), stats


def distributed_connected_components(mask, mesh: DPCMesh, grid_shape,
                                     connectivity: int = 6,
                                     gather_mask: bool = True,
                                     fused_impl: str = "auto",
                                     table_mode: str = "replicated",
                                     table_max_iter: int = 64):
    """Mask-implicit connected components of a block-decomposed grid (Alg. 3
    + Alg. 2).

    mask: this rank's block of the global mask of extent `grid_shape`
    (`BlockDecomp.block_slices(mesh.coords)`), read as bool; any extent
    works (padding is mask False).  Returns this rank's block of labels
    (the largest vertex id of the component, -1 where unmasked; global flat
    ids on `mesh.device`) and DPCStats equal on every rank.  gather_mask=
    False drops the redundant mask exchange; fused_impl and table_mode as in
    `distributed_manifold`.  Labels are bit-identical across all choices.
    """
    labels, stats = _components(mask[None], mesh, grid_shape, connectivity,
                                gather_mask, fused_impl, table_mode,
                                table_max_iter,
                                "distributed_connected_components")
    return labels[0], _item(stats)


def distributed_connected_components_batch(masks, mesh: DPCMesh, grid_shape,
                                           connectivity: int = 6,
                                           gather_mask: bool = True,
                                           fused_impl: str = "auto",
                                           table_mode: str = "replicated",
                                           table_max_iter: int = 64):
    """Batched `distributed_connected_components`: `masks` is a (B, *block)
    stack of this rank's blocks of B masks of one extent `grid_shape`;
    returns ((B, *block) labels, DPCStats with a leading (B,) dim), each
    item equal to its single call.  The collectives fire once for the
    batch (module docstring)."""
    return _components(masks, mesh, grid_shape, connectivity, gather_mask,
                       fused_impl, table_mode, table_max_iter,
                       "distributed_connected_components_batch")

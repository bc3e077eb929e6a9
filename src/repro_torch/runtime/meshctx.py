"""Logical-axis sharding context (port of `repro/runtime/meshctx.py`).

Model code names tensor dimensions by *logical* axes ("dp", "tp", "fsdp",
"sp", "ep_all"); the launcher binds a `Mesh` and this module translates
logical -> physical axes, dropping axes the mesh does not have.  With no
mesh bound (unit tests, one-process runs) every hint is a no-op, so model
code never branches on topology there.

Logical axes:
  dp   — batch/data parallel  -> ("pod", "data") when present
  fsdp — parameter sharding   -> ("data",)
  tp   — tensor/expert/vocab  -> ("model",)
  sp   — sequence parallel    -> ("model",)   (same physical axis as tp)
  ep_all — maximal sharding   -> ("pod", "data", "model") (long-context KV)

JAX's GSPMD turns a sharding annotation into collectives; PyTorch has no
such compiler, so a `Mesh` here is a named-axis view over the ranks of
`torch.distributed`, every rank holds its own block of each sharded
tensor, and the model calls the collectives itself.  Rank r sits at
``np.unravel_index(r, shape)`` (row-major in axis order, as JAX lays a
mesh's devices), and a dimension sharded over several axes is split into
their product of blocks, block index row-major in mesh-axis order (JAX's
order for a multi-axis `PartitionSpec` entry).

The collectives over a named axis or tuple of axes are autograd Functions
(Megatron's pairs): `all_gather` (backward: reduce-scatter), its inverse
`reduce_scatter` (backward: all-gather), `all_reduce` ("g": a sum forward,
identity backward), `copy_to` ("f": identity forward, a sum backward) and
`split` (this rank's block forward, all-gather backward).  Each axis subset
gets its process groups once, made in the same order on every rank.  NCCL
takes device tensors; gloo moves host memory, so with a gloo group and
tensors on a device every collective copies them to the host and back
explicitly (bfloat16 is summed in fp32 there), and the same code runs on
gloo ranks sharing one card and on NCCL ranks, one card each.  The backend
is the caller's choice; nothing falls back.  Every collective adds its
result-shape bytes on this rank to the active `_meta.counting` under
JAX's names (a reduce-scatter by its block, whatever gloo runs for it).
"""
from __future__ import annotations

import contextlib
import itertools
import math
import threading

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import _meta
from repro_torch._device import resolve_device
from repro_torch.tree import tree_map

LOGICAL_AXES = {
    "dp": ("pod", "data"),
    "fsdp": ("data",),
    "tp": ("model",),
    "sp": ("model",),
    "ep_all": ("pod", "data", "model"),
}

_state = threading.local()


class Mesh:
    """Named axes over the ranks of the default process group.

    shape: per-axis sizes, their product the world size (1 without an
    initialised process group); axis_names: one name per axis.  `shape`
    reads back as JAX's ``mesh.shape`` ({name: size}), `ranks` as its
    ``mesh.devices`` (the global ranks laid out in `shape`), `coords` as
    each axis's ``lax.axis_index``.  `device` is where the model's tensors
    live (``"cuda"`` unless given).
    """

    def __init__(self, shape, axis_names, device=None):
        sizes = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        if len(sizes) != len(self.axis_names):
            raise ValueError(f"mesh shape {sizes} and axis names "
                             f"{self.axis_names} differ in length")
        self.shape = dict(zip(self.axis_names, sizes))
        self.size = math.prod(sizes)
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world != self.size:
            raise ValueError(f"mesh {sizes} needs {self.size} ranks; the "
                             f"world has {world}")
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.ranks = np.arange(self.size).reshape(sizes)
        self.coords = dict(zip(self.axis_names, (
            int(c) for c in np.unravel_index(self.rank, sizes))))
        self.device = resolve_device(device)
        self.backend = dist.get_backend() if dist.is_initialized() else None
        # gloo moves host memory: device tensors are staged through it
        self.staged = self.backend == "gloo" and self.device.type != "cpu"
        self._groups = {}
        for k in range(1, len(sizes) + 1):
            for axes in itertools.combinations(self.axis_names, k):
                if self.axis_size(axes) > 1:
                    self._groups[axes] = self._make_group(axes)

    def __repr__(self):
        return f"Mesh({self.shape}, rank {self.rank}, {self.device})"

    def _make_group(self, axes):
        """This rank's process group over `axes` (its ranks in row-major
        order of their coordinates there).  Every rank creates every
        line's group, in one order, as `dist.new_group` needs."""
        if len(axes) == len(self.axis_names):
            return None                       # the whole world, in order
        moved = np.moveaxis(self.ranks, [self.axis_names.index(a)
                                         for a in axes],
                            range(-len(axes), 0))
        mine = None
        for line in moved.reshape(-1, self.axis_size(axes)):
            group = dist.new_group([int(r) for r in line])
            if self.rank in line:
                mine = group
        return mine

    def axes(self, axes) -> tuple:
        """`axes` (a name, a tuple of names or None) as a tuple in mesh
        order, without the axes this mesh lacks."""
        if axes is None:
            return ()
        if isinstance(axes, str):
            axes = (axes,)
        return tuple(a for a in self.axis_names if a in axes)

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self.axes(axes))

    def index(self, axes) -> int:
        """This rank's block index along `axes` (row-major over them)."""
        axes = self.axes(axes)
        if not axes:
            return 0
        return int(np.ravel_multi_index([self.coords[a] for a in axes],
                                        [self.shape[a] for a in axes]))

    def group(self, axes):
        return self._groups[self.axes(axes)]

    # --- raw collectives (no autograd) --------------------------------------

    def _wire(self, t: torch.Tensor, reduce: bool = False) -> torch.Tensor:
        """`t` as it travels, flat: contiguous, bool as uint8, on the host
        under gloo, where a bfloat16 sum runs in fp32 and a bfloat16 copy
        moves its bytes as uint8."""
        t = t.reshape(-1)
        if t.dtype == torch.bool:
            t = t.view(torch.uint8)
        if self.staged:
            t = t.cpu()
        if self.backend == "gloo" and t.dtype == torch.bfloat16:
            t = t.float() if reduce else t.view(torch.uint8)
        return t

    @staticmethod
    def _unwire(w: torch.Tensor, like: torch.Tensor, shape) -> torch.Tensor:
        """A flat wire tensor back as `like`'s kind, in `shape`."""
        if w.dtype == torch.uint8 and like.dtype in (torch.bool,
                                                     torch.bfloat16):
            w = w.view(like.dtype)
        return w.view(shape).to(device=like.device, dtype=like.dtype)

    def gather(self, x: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """Every rank's `x` along `axes`, concatenated on `dim` in block
        order."""
        n = self.axis_size(axes)
        if n == 1:
            return x
        w = self._wire(x)
        out = torch.empty(n * w.numel(), dtype=w.dtype, device=w.device)
        _meta.add_collective("all-gather", n * _meta.nbytes(x))
        dist.all_gather_into_tensor(out, w, group=self.group(axes))
        out = self._unwire(out, x, (n,) + tuple(x.shape))
        return torch.cat(out.unbind(0), dim)

    def scatter_sum(self, x: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """The sum of every rank's `x` along `axes`, this rank's block of it
        on `dim` (reduce-scatter; gloo sums the whole and cuts)."""
        n = self.axis_size(axes)
        if n == 1:
            return x
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"into {n} blocks")
        i, c = self.index(axes), x.shape[dim] // n
        _meta.add_collective("reduce-scatter", _meta.nbytes(x) // n)
        if self.backend == "nccl":
            w = x.movedim(dim, 0).contiguous()
            out = torch.empty((c,) + tuple(w.shape[1:]), dtype=w.dtype,
                              device=w.device)
            dist.reduce_scatter_tensor(out, w, group=self.group(axes))
            return out.movedim(0, dim)
        return self._reduce(x, axes, dist.ReduceOp.SUM).narrow(dim, i * c, c)

    def reduce(self, x: torch.Tensor, axes, op=dist.ReduceOp.SUM):
        """`x` reduced over `axes` with `op` (SUM, MAX, MIN)."""
        if self.axis_size(axes) == 1:
            return x
        _meta.add_collective("all-reduce", _meta.nbytes(x))
        return self._reduce(x, axes, op)

    def _reduce(self, x, axes, op):
        w = self._wire(x, reduce=True)
        if w.data_ptr() == x.data_ptr():
            w = w.clone()
        dist.all_reduce(w, op=op, group=self.group(axes))
        return self._unwire(w, x, x.shape)

    def block(self, x: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """This rank's block of `x` on `dim` along `axes`."""
        n = self.axis_size(axes)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"into {n} blocks over {self.axes(axes)}")
        c = x.shape[dim] // n
        return x.narrow(dim, self.index(axes) * c, c)

    def barrier(self):
        if dist.is_initialized():
            dist.barrier()

    # --- autograd collectives ------------------------------------------------

    def all_gather(self, x, axes, dim: int):
        """Gather on `dim`; backward: reduce-scatter of the gradient."""
        if self.axis_size(axes) == 1:
            return x
        return _AllGather.apply(x, self, axes, dim)

    def reduce_scatter(self, x, axes, dim: int):
        """Sum and keep this rank's block; backward: all-gather."""
        if self.axis_size(axes) == 1:
            return x
        return _ReduceScatter.apply(x, self, axes, dim)

    def all_reduce(self, x, axes):
        """Megatron's g: a sum forward, the gradient passed through."""
        if self.axis_size(axes) == 1:
            return x
        return _AllReduce.apply(x, self, axes)

    def copy_to(self, x, axes):
        """Megatron's f: identity forward, the gradient summed."""
        if self.axis_size(axes) == 1:
            return x
        return _CopyTo.apply(x, self, axes)

    def split(self, x, axes, dim: int):
        """This rank's block forward; backward: all-gather."""
        if self.axis_size(axes) == 1:
            return x
        return _Split.apply(x, self, axes, dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return mesh.gather(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.args
        return mesh.scatter_sum(g, axes, dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return mesh.scatter_sum(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.args
        return mesh.gather(g, axes, dim), None, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return mesh.reduce(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return x

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.args
        return mesh.reduce(g, axes), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return mesh.block(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.args
        return mesh.gather(g, axes, dim), None, None, None


# --- the bound mesh --------------------------------------------------------


def set_current_mesh(mesh: Mesh | None):
    _state.mesh = mesh


def get_current_mesh() -> Mesh | None:
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh: Mesh | None):
    prev = get_current_mesh()
    set_current_mesh(mesh)
    try:
        yield mesh
    finally:
        set_current_mesh(prev)


def logical_to_spec(logical, mesh) -> tuple:
    """Translate a tuple of logical axis names (or None) to JAX's
    PartitionSpec entries for `mesh` (anything with `axis_names`): per
    dimension None, one physical axis name, or a tuple of them, dropping
    physical axes the mesh lacks."""
    names = set(mesh.axis_names)
    out = []
    for l in logical:
        if l is None:
            out.append(None)
            continue
        phys = tuple(a for a in LOGICAL_AXES[l] if a in names)
        if not phys:
            out.append(None)
        elif len(phys) == 1:
            out.append(phys[0])
        else:
            out.append(phys)
    return tuple(out)


def local_block(x: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the whole tensor `x` under the physical `spec`
    (`logical_to_spec`'s entries); raises where a dimension does not
    split."""
    for d, axes in enumerate(spec):
        if axes is not None:
            x = mesh.block(x, axes, d)
    return x


def gather_blocks(x: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """The whole tensor from every rank's block `x` under `spec` (the
    inverse of `local_block`; no autograd)."""
    for d, axes in enumerate(spec):
        if axes is not None:
            x = mesh.gather(x, axes, d)
    return x


def shard_count(spec, mesh) -> int:
    """How many distinct blocks `spec` cuts a tensor into on `mesh`."""
    return math.prod(mesh.axis_size(a) for a in spec if a is not None)


def constrain(x, *logical):
    """JAX's sharding constraint by logical axes: a no-op without a bound
    mesh.  With one, `x` is taken to be whole (the same on every rank) and
    this rank's block of it under the logical spec is returned."""
    mesh = get_current_mesh()
    if mesh is None:
        return x
    return local_block(x, logical_to_spec(logical, mesh), mesh)


def sharded_norm_fn(specs, mesh):
    """The global norm of a gradient tree sharded under the logical `specs`
    (a tree of the same structure) on `mesh`, for the optimizers'
    `norm_fn`: each leaf's sum of squares divided by the ranks holding the
    same block, one sum over every rank."""
    def norm(grads):
        parts = []
        tree_map(lambda g, spec: parts.append(
            torch.sum(torch.square(g.float())) * (shard_count(
                logical_to_spec(spec, mesh), mesh) / mesh.size)),
            grads, specs)
        return torch.sqrt(mesh.reduce(sum(parts), mesh.axis_names))

    return norm

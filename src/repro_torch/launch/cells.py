"""Cell construction (port of `repro/launch/cells.py`): one (architecture x
input-shape) cell is a step function, the global shapes of its arguments
and their shardings on a mesh.  The dry run (`launch.dryrun`) traces every
cell's step on the meta device; the tests and `chip_smoke.py` feed the
same steps real tensors.

`arg_shapes` are meta tensors of JAX's global shapes and dtypes (a Python
int where JAX has a 0-d length), `arg_specs` the logical specs of JAX's
cells in the same tree (`runtime.meshctx`'s axes; `()` replicated; the
DPC cells' physical specs over their block axes, as JAX's), and `mesh` the
`runtime.meshctx.Mesh` the cell runs on.  `local(args)` cuts this rank's
blocks out of whole arguments (a DPC block by `BlockDecomp.block_slices`),
and `step_fn(*local)` runs this rank's program under the mesh: with real
tensors it is the launchers' step (`launch.train`'s for the LM, the
models' sharded paths, the distributed DPC entry points).

Where the cells part from JAX's on purpose:
  * the MoE cells bind `dp_shards` from the mesh, as JAX does, and a
    "global" dispatch becomes "shard_map": the port's "global" dispatch
    over several data shards raises (ROADMAP.md Queue 3); the cell's
    `note` says so;
  * the train steps return new tensors (the port's optimizers change
    nothing in place), so a donated argument is not reused: `launch.dryrun`
    records the donated bytes as JAX's alias bytes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import configs
from repro_torch.launch.mesh import make_block_mesh, make_flat_mesh
from repro_torch.models import bst, gnn, lm
from repro_torch.optim import adamw
from repro_torch.runtime.meshctx import (LOGICAL_AXES, local_block,
                                         logical_to_spec, sharded_norm_fn,
                                         use_mesh)
from repro_torch.tree import tree_map

META = torch.device("meta")


def S(shape, dtype):
    """A meta tensor: JAX's `ShapeDtypeStruct`."""
    return torch.empty(tuple(shape), dtype=dtype, device=META)


@dataclasses.dataclass
class Cell:
    arch_id: str
    shape_name: str
    family: str
    cfg: Any
    shape: dict
    step_fn: Callable
    arg_shapes: tuple           # tree of meta tensors (JAX's global shapes)
    arg_specs: tuple            # matching logical specs
    mesh: Any
    local_fn: Callable = None   # whole args -> this rank's args
    donate_argnums: tuple = ()
    note: str = ""
    opt: Any = None             # the train cells' optimizer
    decomp: Any = None          # the DPC cells' BlockDecomp / GraphDecomp

    @property
    def name(self):
        return f"{self.arch_id}:{self.shape_name}"

    def local(self, args):
        """This rank's blocks of the whole arguments `args`."""
        if self.local_fn is not None:
            return self.local_fn(args)
        return _cut(args, self.arg_specs, self.mesh)


def _cut(args, specs, mesh):
    """Each tensor leaf's block under its logical spec; other leaves pass."""
    return tree_map(lambda t, spec: local_block(
        t, logical_to_spec(spec, mesh), mesh)
        if isinstance(t, torch.Tensor) else t, args, specs)


def _replicated(tree):
    return tree_map(lambda _: (), tree)


def _dp_size(mesh) -> int:
    return mesh.axis_size(LOGICAL_AXES["dp"])


def _gen():
    return torch.Generator().manual_seed(0)


def _train_step(loss_fn, opt, mesh):
    """The launchers' step on this rank's blocks: (state, batch) -> (state,
    metrics), the loss's gradient by autograd and one optimizer update
    (new tensors), under `mesh`."""
    def step(state, batch):
        params, ostate = state
        with use_mesh(mesh):
            leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
            loss, metrics = loss_fn(leaves, batch)
            loss.backward()
            grads = tree_map(lambda t: t.grad, leaves)
            params, ostate, om = opt.update(grads, ostate, params)
        return (params, ostate), {
            "loss": loss.detach(),
            **{k: v.detach() for k, v in metrics.items()}, **om}
    return step


def _under(mesh, fn):
    def step(*args):
        with use_mesh(mesh):
            return fn(*args)
    return step


# --- LM cells -----------------------------------------------------------------


def _cache_logical(cfg, shape_name):
    """KV cache (L, B, Hkv, S, dh): context-parallel on the cache sequence;
    batch on dp when it shards (JAX's `_cache_logical`)."""
    if shape_name == "long_500k":
        return lm.LONG_CACHE_LOGICAL
    return lm.CACHE_LOGICAL


def build_lm_cell(arch_id, mod, shape_name, shape, mesh, smoke) -> Cell:
    cfg = mod.smoke_config() if smoke else mod.full_config()
    note = ""
    if cfg.moe is not None:
        # the shard-local dispatch needs the static dp size, as in JAX; a
        # global dispatch runs JAX's shard_map partition
        moe = dataclasses.replace(cfg.moe, dp_shards=_dp_size(mesh))
        if moe.dispatch == "global":
            moe = dataclasses.replace(moe, dispatch="shard_map")
            note = ("MoE dispatch shard_map (the port's global dispatch "
                    "over several data shards raises)")
        cfg = dataclasses.replace(cfg, moe=moe)
    b, sq = shape["batch"], shape["seq"]
    kind = shape["kind"]
    tok = S((b, sq), torch.int32)
    tok_spec = ("dp", None)
    params = lm.init_params(_gen(), cfg, device=META)
    pspec = lm.param_logical_specs(cfg)

    if kind == "train":
        opt = adamw(1e-4, moment_dtype=cfg.opt_moment_dtype,
                    norm_fn=lm.global_norm_fn(cfg, mesh))
        ostate = opt.init(params)
        ospec = {"m": pspec, "v": pspec, "step": ()}
        step = _train_step(lambda p, batch: lm.loss_fn(p, batch, cfg), opt,
                           mesh)
        return Cell(arch_id, shape_name, "lm", cfg, shape, step,
                    ((params, ostate), {"tokens": tok, "labels": tok}),
                    ((pspec, ospec), {"tokens": tok_spec,
                                      "labels": tok_spec}),
                    mesh, donate_argnums=(0,), note=note, opt=opt)

    if kind == "prefill":
        return Cell(arch_id, shape_name, "lm", cfg, shape,
                    _under(mesh, lambda p, t: lm.prefill(p, t, cfg)),
                    (params, tok), (pspec, tok_spec), mesh, note=note)

    # decode: one new token against a seq-long cache
    cache = lm.init_kv_cache(cfg, b, sq, device=META)
    clog = _cache_logical(cfg, shape_name)
    new_tok = S((b, 1), torch.int32)
    new_spec = ("dp", None) if b > 1 else (None, None)

    def step(p, c, t):
        with use_mesh(mesh):
            return lm.decode_step(p, dict(c, logical=clog), t, cfg)

    return Cell(arch_id, shape_name, "lm", cfg, shape, step,
                (params, cache, new_tok),
                (pspec, {"k": clog, "v": clog, "length": ()}, new_spec),
                mesh, donate_argnums=(1,), note=note)


# --- GNN cells ----------------------------------------------------------------


def _pad512(n: int) -> int:
    """A sharded leading dim rounded up to a 512 multiple, so the same cell
    runs on both production meshes (padding is masked)."""
    return ((n + 511) // 512) * 512


def _graph_shapes(arch, cfg, shp, smoke):
    """The cell's global graph batch (JAX's `_graph_shapes`): geometric
    models get positions and species, attribute models d_feat features."""
    kind = shp["kind"]
    if kind == "batched":
        n = shp["batch"] * shp["n_nodes"]
        e = shp["batch"] * shp["n_edges"]
        g = shp["batch"]
    elif kind == "sampled":
        n, e, g = shp["sample_nodes"], shp["sample_edges"], 1
    else:
        n, e, g = shp["n_nodes"], shp["n_edges"], 1
    n, e = _pad512(n), _pad512(e)
    t = 4 * e  # triplet budget (dimenet)
    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    base = {
        "senders": S((e,), i32), "receivers": S((e,), i32),
        "node_mask": S((n,), b8), "edge_mask": S((e,), b8),
        "graph_ids": S((n,), i32),
    }
    if arch == "gat":
        base["node_feat"] = S((n, shp.get("d_feat", 32)), f32)
        base["labels"] = S((n,), i32)
    elif arch == "meshgraphnet":
        base["node_feat"] = S((n, cfg.d_node_in), f32)
        base["edge_feat"] = S((e, cfg.d_edge_in), f32)
        base["labels"] = S((n, cfg.d_out), f32)
    else:  # geometric: schnet / dimenet
        base["node_feat"] = S((n, 1), f32)   # species
        base["positions"] = S((n, 3), f32)
        base["labels"] = S((g,), f32)
        if arch == "dimenet":
            base["triplet_src"] = S((t,), i32)
            base["triplet_dst"] = S((t,), i32)
            base["triplet_mask"] = S((t,), b8)
    return base, g


def _adapt_gnn_cfg(cfg, shp):
    if cfg.arch == "gat":
        return dataclasses.replace(cfg, d_in=shp.get("d_feat", 32),
                                   n_classes=shp.get("n_classes", 7))
    if cfg.arch == "meshgraphnet" and "d_feat" in shp:
        return dataclasses.replace(cfg, d_node_in=shp["d_feat"])
    return cfg


def build_gnn_cell(arch_id, mod, shape_name, shape, mesh, smoke) -> Cell:
    cfg = mod.smoke_config() if smoke else mod.full_config()
    cfg = _adapt_gnn_cfg(cfg, shape)
    graph, n_graphs = _graph_shapes(cfg.arch, cfg, shape, smoke)
    params = gnn.init_params(_gen(), cfg, device=META)
    opt = adamw(1e-4)
    ostate = opt.init(params)
    # graph arrays sharded over every mesh axis on the leading dim (padded
    # to 512 multiples); small per-graph arrays and the parameters whole
    total = mesh.size

    def gspec(v):
        if v.shape and v.shape[0] % total == 0:
            return ("ep_all",) + (None,) * (v.ndim - 1)
        return ()

    step = _train_step(lambda p, g: gnn.loss_fn(
        p, dict(g, n_graphs=n_graphs), cfg), opt, mesh)
    return Cell(arch_id, shape_name, "gnn", cfg, shape, step,
                ((params, ostate), graph),
                ((_replicated(params), _replicated(ostate)),
                 {k: gspec(v) for k, v in graph.items()}),
                mesh, donate_argnums=(0,), opt=opt)


# --- BST cells ----------------------------------------------------------------


def build_bst_cell(arch_id, mod, shape_name, shape, mesh, smoke) -> Cell:
    cfg = mod.smoke_config() if smoke else mod.full_config()
    b = shape["batch"]
    kind = shape["kind"]
    params = bst.init_params(_gen(), cfg, device=META)
    pspec = bst.param_logical_specs(cfg)
    i32 = torch.int32
    batch = {
        "hist_items": S((b, cfg.seq_len), i32),
        "target_item": S((b,), i32),
        "profile_ids": S((b, cfg.n_profile_fields), i32),
        "multihot_ids": S((b, cfg.n_multihot_fields, cfg.multihot_len), i32),
    }
    if kind == "train":
        batch["labels"] = S((b,), torch.float32)
    bspec = {k: ("dp",) + (None,) * (v.ndim - 1) for k, v in batch.items()}
    if b == 1:  # retrieval_cand: a singleton batch does not shard
        bspec = {k: (None,) * v.ndim for k, v in batch.items()}

    if kind == "train":
        opt = adamw(1e-3, norm_fn=sharded_norm_fn(pspec, mesh))
        ostate = opt.init(params)
        step = _train_step(lambda p, bt: bst.loss_fn(p, bt, cfg), opt, mesh)
        return Cell(arch_id, shape_name, "recsys", cfg, shape, step,
                    ((params, ostate), batch),
                    ((pspec, {"m": pspec, "v": pspec, "step": ()}), bspec),
                    mesh, donate_argnums=(0,), opt=opt)

    if kind == "serve":
        return Cell(arch_id, shape_name, "recsys", cfg, shape,
                    _under(mesh, lambda p, bt: bst.forward(p, bt, cfg)),
                    (params, batch), (pspec, bspec), mesh)

    # retrieval: the candidate axis sharded on "data" (1M % 512 != 0;
    # data = 16 divides it on both meshes)
    batch["candidates"] = S((b, shape["n_candidates"]), i32)
    bspec["candidates"] = (None, "fsdp")
    return Cell(arch_id, shape_name, "recsys", cfg, shape,
                _under(mesh, lambda p, bt: bst.retrieval_step(
                    p, bt, cfg, top_k=100)),
                (params, batch), (pspec, bspec), mesh)


# --- DPC cells (the paper's own workload) --------------------------------------


def build_dpc_cell(arch_id, mod, shape_name, shape, mesh, smoke) -> Cell:
    from repro_torch.core.distributed import (
        BlockDecomp, distributed_connected_components, distributed_manifold)
    cfg = mod.smoke_config() if smoke else mod.full_config()
    dims = tuple(shape["dims"])
    # the config's block decomposition when it matches the rank count,
    # else the flat 1-D slab mesh; ragged extents are padded and masked in
    # the core (deviation (p) in DESIGN.md)
    layout = tuple(getattr(cfg, "layout", ()) or ())
    n_dev = mesh.size
    if layout and math.prod(layout) == n_dev and len(layout) <= len(dims):
        dpc_mesh = make_block_mesh(layout, mesh)
        note = f"lowered on the {'x'.join(map(str, layout))} block mesh"
        if any(d % p for d, p in zip(dims, layout)):
            note += " (ragged extents, pad-and-mask)"
    else:
        dpc_mesh = make_flat_mesh(mesh)
        note = "lowered on the flattened 1-D mesh"
        if dims[0] % n_dev:
            note += " (ragged extents, pad-and-mask)"
    note += "; DPC loops costed one round each"
    names = dpc_mesh.names
    spec = tuple(nm if dims[i] % dpc_mesh.layout[i] == 0 else None
                 for i, nm in enumerate(names))
    spec += (None,) * (len(dims) - len(names))
    dec = BlockDecomp(dims, dpc_mesh.layout, names)

    def local(args):
        return (args[0][dec.block_slices(dpc_mesh.coords)],)

    if shape["kind"] == "dpc":
        inp = S(dims, torch.int32)

        def step(order):
            return distributed_manifold(order, dpc_mesh, dims,
                                        cfg.connectivity)
    else:
        inp = S(dims, torch.bool)

        def step(mask):
            return distributed_connected_components(
                mask, dpc_mesh, dims, cfg.connectivity,
                gather_mask=getattr(cfg, "gather_mask", True))

    return Cell(arch_id, shape_name, "dpc", cfg, shape, step, (inp,),
                (spec,), dpc_mesh, local_fn=local, note=note, decomp=dec)


def build_dpc_graph_cell(arch_id, mod, shape_name, shape, mesh,
                         smoke) -> Cell:
    """Distributed CC on an unstructured edge-list mesh: a 1-D vertex
    partition over the flattened mesh (the partition geometry is
    table-driven, so no block lattice applies)."""
    from repro_torch.core.distributed_graph import (
        GraphDecomp, distributed_connected_components_graph)
    from repro_torch.data import grid_edge_list
    from repro_torch.data.graphs import random_csr
    cfg = mod.smoke_config() if smoke else mod.full_config()
    if shape["kind"] == "graph_cc":
        n = math.prod(shape["dims"])
        senders, receivers = (t.numpy() for t in grid_edge_list(
            shape["dims"], cfg.connectivity, device="cpu"))
    else:  # graph_cc_random
        n = shape["n"]
        indptr, receivers = random_csr(n, shape["avg_degree"], seed=0)
        senders = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    dpc_mesh = make_flat_mesh(mesh)
    ndev = dpc_mesh.size
    dec = GraphDecomp(n, senders, receivers, ndev)
    geometry = bool(shape.get("geometry", False))

    def step(mask):
        # pure-geometry shapes label the mesh connectivity itself
        if geometry:
            mask = torch.ones_like(mask)
        return distributed_connected_components_graph(
            mask, dec, dpc_mesh, gather_mask=getattr(cfg, "gather_mask",
                                                     True))

    return Cell(arch_id, shape_name, "dpc_graph", cfg, shape, step,
                (S((n,), torch.bool),), ((None,),), dpc_mesh,
                local_fn=lambda args: args, decomp=dec,
                note=f"{ndev}-way vertex partition, "
                     f"{dec.table_size}-slot cut table, "
                     f"owned-pad {dec.pad_fraction:.3f}; DPC loops costed "
                     f"one round each")


# --- registry -----------------------------------------------------------------

_BUILDERS = {"lm": build_lm_cell, "gnn": build_gnn_cell,
             "recsys": build_bst_cell, "dpc": build_dpc_cell,
             "dpc_graph": build_dpc_graph_cell}


def build_cell(arch_id: str, shape_name: str, mesh, smoke: bool = False,
               cfg_transform=None) -> Cell:
    """The cell of `arch_id` x `shape_name` on `mesh` (a
    `runtime.meshctx.Mesh`); cfg_transform(cfg) -> cfg builds a variant
    (`launch.perf`)."""
    mod = configs.get(arch_id)
    shapes = mod.SMOKE_SHAPES if smoke else mod.SHAPES
    if shape_name not in shapes:
        raise KeyError(f"{arch_id} has no shape {shape_name}; "
                       f"options: {list(shapes)}")
    if cfg_transform is not None:
        mod = _TransformedModule(mod, cfg_transform)
    return _BUILDERS[mod.FAMILY](arch_id, mod, shape_name,
                                 shapes[shape_name], mesh, smoke)


class _TransformedModule:
    def __init__(self, mod, transform):
        self._mod = mod
        self._transform = transform

    def __getattr__(self, name):
        return getattr(self._mod, name)

    def full_config(self):
        return self._transform(self._mod.full_config())

    def smoke_config(self):
        return self._transform(self._mod.smoke_config())


def all_cells(include_dpc: bool = True):
    """The full assignment matrix: 10 archs x 4 shapes (+ DPC cells)."""
    out = []
    for arch in configs.ARCH_IDS:
        if arch in ("dpc_grid", "dpc_graph") and not include_dpc:
            continue
        mod = configs.get(arch)
        for shape_name in mod.SHAPES:
            out.append((arch, shape_name))
    return out

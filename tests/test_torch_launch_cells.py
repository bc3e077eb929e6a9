"""`repro_torch.launch.cells` and the kernels' meta rules (`_meta`,
`kernels.ops` on meta tensors) against the JAX package, on the CPU.

The port's cells are built on its production meshes over a fake process
group of 256 and 512 ranks in this process (`launch.dryrun.fake_world`,
torch's "fake" backend: no rank runs), every cell of `all_cells()` at its
full config (the `dpc_graph` cells at their smoke shapes: their host
decomposition is the cell's build, not a shape), and each cell's global
argument shapes, dtypes and logical specs are held to JAX's builder
helpers: `jax.eval_shape` of the inits, `cells._graph_shapes`,
`cells._cache_logical`, the models' `param_logical_specs`.  No 256-device
JAX program is compiled (that fails under jax 0.9.0, ROADMAP.md Queue 3).

The smoke cells' steps on a one-rank mesh equal the unsharded functions
(the LM step within 1e-5, BST logits and the GNN loss within 1e-6, DPC
labels exactly), with JAX's `test_dpc_graph_cell_smoke` as the
`dpc_graph` counterpart.  Each kernel's meta outputs have its plain
version's shapes and dtypes and its count is its formula.
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.configs as jconfigs
from repro.launch import cells as jcells
from repro.models import bst as jbst
from repro.models import gnn as jgnn
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
import repro_torch.configs as pconfigs
from repro_torch import _meta
from repro_torch.kernels import ops
from repro_torch.launch import cells as pcells
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import bst as pbst
from repro_torch.models import gnn as pgnn
from repro_torch.models import lm as plm
from repro_torch.optim import adamw, global_norm
from repro_torch.runtime.meshctx import Mesh
from repro_torch.tree import tree_map, tree_map_with_names

MESHES = {"pod256": (False, 256), "pod2x256": (True, 512)}


def test_all_cells_are_jax():
    assert pcells.all_cells() == jcells.all_cells()
    assert pcells.all_cells(False) == jcells.all_cells(False)


# --- global shapes and specs ---------------------------------------------------


def _leaf(t):
    if isinstance(t, torch.Tensor):
        return tuple(t.shape), str(t.dtype).removeprefix("torch.")
    return (), "int"                      # the cache's length


def _pflat(tree):
    out = {}
    tree_map_with_names(lambda n, t: out.__setitem__(n, _leaf(t)), tree)
    return out


def _jflat(tree):
    """name -> (shape, dtype) of a JAX tree of ShapeDtypeStructs, a stacked
    leaf under its own name."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        out[name] = (tuple(leaf.shape), jnp.dtype(leaf.dtype).name)
    return out


def _unstack(jflat, pflat):
    """JAX's leaves with each layer-stacked one ("layers/wq", (L, ...))
    split into the port's per-layer names ("layers/0/wq")."""
    out = {}
    for name, (shape, dt) in jflat.items():
        if name in pflat:
            out[name] = (shape, dt)
            continue
        parts = name.split("/")
        pos = next(p for p in range(1, len(parts))
                   if "/".join(parts[:p] + ["0"] + parts[p:]) in pflat)
        for i in range(shape[0]):
            out["/".join(parts[:pos] + [str(i)] + parts[pos:])] = (
                shape[1:], dt)
    return out


def _same_tree(port, jax_tree):
    p = _pflat(port)
    j = _unstack(_jflat(jax_tree), p)
    assert p == j, sorted(set(p.items()) ^ set(j.items()))[:6]


@functools.lru_cache(maxsize=None)
def _jparams(arch, shape_name):
    mod = jconfigs.get(arch)
    cfg = mod.full_config()
    key = jax.random.PRNGKey(0)
    if mod.FAMILY == "lm":
        return jax.eval_shape(functools.partial(jlm.init_params, cfg=cfg),
                              key)
    if mod.FAMILY == "recsys":
        return jax.eval_shape(functools.partial(jbst.init_params, cfg=cfg),
                              key)
    cfg = jcells._adapt_gnn_cfg(cfg, mod.SHAPES[shape_name])
    return jax.eval_shape(functools.partial(jgnn.init_params, cfg=cfg), key)


def _lm_checks(cell, arch, shape_name):
    jmod = jconfigs.get(arch)
    jcfg, shape = jmod.full_config(), jmod.SHAPES[shape_name]
    b, sq = shape["batch"], shape["seq"]
    jparams = _jparams(arch, shape_name)
    jspec = jlm.param_logical_specs(jcfg)
    pspec = plm.param_logical_specs(cell.cfg)
    for k in ("embed", "ln_f", "unembed"):
        assert tuple(jspec[k]) == pspec[k]
    for layer in pspec["layers"]:
        assert {k: tuple(v[1:]) for k, v in jspec["layers"].items()} == layer
    kind = shape["kind"]
    if kind == "train":
        (params, ostate), batch = cell.arg_shapes
        (ps, os_), bs = cell.arg_specs
        _same_tree(params, jparams)
        jopt = jax.eval_shape(jadamw(1e-4, moment_dtype=jcfg.opt_moment_dtype
                                     ).init, jparams)
        _same_tree(ostate, jopt)
        assert ps == pspec and os_ == {"m": pspec, "v": pspec, "step": ()}
        assert {k: _leaf(v) for k, v in batch.items()} == {
            "tokens": ((b, sq), "int32"), "labels": ((b, sq), "int32")}
        assert bs == {"tokens": ("dp", None), "labels": ("dp", None)}
    elif kind == "prefill":
        params, tok = cell.arg_shapes
        _same_tree(params, jparams)
        assert _leaf(tok) == ((b, sq), "int32")
        assert cell.arg_specs == (pspec, ("dp", None))
    else:
        params, cache, tok = cell.arg_shapes
        _same_tree(params, jparams)
        jcache = _jflat(jax.eval_shape(functools.partial(
            jlm.init_kv_cache, jcfg, b, sq)))
        assert _leaf(cache["k"]) == jcache["k"]
        assert _leaf(cache["v"]) == jcache["v"]
        assert jcache["length"] == ((), "int32") and cache["length"] == 0
        clog = jcells._cache_logical(jcfg, shape_name)
        assert cell.arg_specs[1] == {"k": clog, "v": clog, "length": ()}
        assert _leaf(tok) == ((b, 1), "int32")
        assert cell.arg_specs[2] == (("dp", None) if b > 1 else (None, None))
    if jcfg.moe is not None:
        assert cell.cfg.moe.dp_shards == cell.mesh.axis_size(("pod", "data"))
        assert cell.cfg.moe.dispatch == "shard_map" and "shard_map" in \
            cell.note


def _gnn_checks(cell, arch, shape_name):
    jmod = jconfigs.get(arch)
    shp = jmod.SHAPES[shape_name]
    jcfg = jcells._adapt_gnn_cfg(jmod.full_config(), shp)
    jgraph, _ = jcells._graph_shapes(jcfg.arch, jcfg, shp, False)
    (params, ostate), graph = cell.arg_shapes
    _same_tree(params, _jparams(arch, shape_name))
    assert {k: _leaf(v) for k, v in graph.items()} == {
        k: (tuple(v.shape), jnp.dtype(v.dtype).name)
        for k, v in jgraph.items()}
    total = cell.mesh.size
    for k, v in jgraph.items():
        want = (("ep_all",) + (None,) * (len(v.shape) - 1)
                if v.shape[0] % total == 0 else ())
        assert cell.arg_specs[1][k] == want, k
    specs = []
    tree_map(lambda _, s: specs.append(s), cell.arg_shapes[0],
             cell.arg_specs[0])
    assert set(specs) == {()}             # parameters and moments whole


def _bst_checks(cell, shape_name):
    jcfg = jconfigs.get("bst").full_config()
    shape = jconfigs.get("bst").SHAPES[shape_name]
    params = cell.arg_shapes[0][0] if shape["kind"] == "train" \
        else cell.arg_shapes[0]
    _same_tree(params, _jparams("bst", shape_name))
    jspec = jbst.param_logical_specs(jcfg)
    pspec = pbst.param_logical_specs(cell.cfg)
    assert _norm_specs(jspec) == _norm_specs(pspec)
    b = shape["batch"]
    batch = cell.arg_shapes[1]
    want = {"hist_items": (b, jcfg.seq_len), "target_item": (b,),
            "profile_ids": (b, jcfg.n_profile_fields),
            "multihot_ids": (b, jcfg.n_multihot_fields, jcfg.multihot_len)}
    if shape["kind"] == "train":
        want["labels"] = (b,)
    if shape["kind"] == "retrieval":
        want["candidates"] = (b, shape["n_candidates"])
        assert cell.arg_specs[1]["candidates"] == (None, "fsdp")
    assert {k: _leaf(v)[0] for k, v in batch.items()} == want
    for k, v in cell.arg_specs[1].items():
        if k != "candidates":
            assert v == (("dp",) if b > 1 else (None,)) + \
                (None,) * (len(want[k]) - 1), k


def _norm_specs(tree):
    if isinstance(tree, dict):
        return {k: _norm_specs(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_norm_specs(v) for v in tree]
    return tuple(tree)


@pytest.fixture(scope="module")
def built():
    """Every cell on both production meshes: {mesh: {(arch, shape): cell}}
    (full configs; dpc_graph at smoke shapes)."""
    out = {}
    for label, (multi_pod, size) in MESHES.items():
        with fake_world(size):
            mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
            out[label] = {(a, s): pcells.build_cell(
                a, s, mesh, smoke=(a == "dpc_graph"))
                for a, s in pcells.all_cells()}
    return out


@pytest.mark.parametrize("label", list(MESHES))
@pytest.mark.parametrize("family", ["lm", "gnn", "recsys", "dpc",
                                    "dpc_graph"])
def test_cell_shapes_and_specs_are_jax(built, label, family):
    n = 0
    for (arch, shape_name), cell in built[label].items():
        if pconfigs.get(arch).FAMILY != family:
            continue
        n += 1
        assert cell.family == family
        assert cell.name == f"{arch}:{shape_name}"
        if family == "lm":
            _lm_checks(cell, arch, shape_name)
        elif family == "gnn":
            _gnn_checks(cell, arch, shape_name)
        elif family == "recsys":
            _bst_checks(cell, shape_name)
        elif family == "dpc":
            shp = jconfigs.get(arch).SHAPES[shape_name]
            dt = "int32" if shp["kind"] == "dpc" else "bool"
            assert _leaf(cell.arg_shapes[0]) == (tuple(shp["dims"]), dt)
            layout = cell.mesh.layout
            want = (8, 8, 4) if label == "pod256" else (512,)
            assert layout == want and ("block" in cell.note) == (
                label == "pod256")
        else:
            shp = jconfigs.get(arch).SMOKE_SHAPES[shape_name]
            n_v = shp.get("n") or int(np.prod(shp["dims"]))
            assert _leaf(cell.arg_shapes[0]) == ((n_v,), "bool")
            assert cell.mesh.layout == (MESHES[label][1],)
    assert n == {"lm": 20, "gnn": 16, "recsys": 4, "dpc": 6,
                 "dpc_graph": 5}[family]


@pytest.mark.parametrize("label", list(MESHES))
def test_every_lm_cell_builds_at_full_config(built, label):
    """The four archs with 8 KV heads included: their "model" axis of 16
    ranks is more than their KV heads."""
    kv8 = {a for a in ("llama3_2_1b", "minitron_8b", "stablelm_12b",
                       "kimi_k2_1t")
           if pconfigs.get(a).full_config().n_kv_heads == 8}
    assert len(kv8) == 4
    for (arch, shape_name), cell in built[label].items():
        if cell.family == "lm":
            local = cell.local(cell.arg_shapes)
            params = local[0][0] if shape_name == "train_4k" else local[0]
            wk = params["layers"][0]["wk"]
            cfg = cell.cfg
            assert wk.shape == (cfg.d_model // 16,
                                cfg.n_kv_heads * cfg.head_dim // 16)


def test_multi_pod_cuts_the_batch_further(built):
    """JAX's `test_multi_pod_actually_uses_pod_axis` rule: the per-rank
    argument bytes on 2 x 256 are no larger than on 256."""
    for arch in ("kimi_k2_1t", "stablelm_12b"):
        got = {}
        for label in MESHES:
            cell = built[label][(arch, "train_4k")]
            got[label] = sum(map(_meta.nbytes, [
                t for t in torch.utils._pytree.tree_leaves(
                    cell.local(cell.arg_shapes))
                if isinstance(t, torch.Tensor)]))
        assert got["pod2x256"] <= got["pod256"], (arch, got)


# --- smoke cells on one rank == the unsharded functions ----------------------


def _one_rank():
    return Mesh((1, 1), ("data", "model"), "cpu")


def test_lm_train_cell_on_one_rank_is_the_unsharded_step():
    cell = pcells.build_cell("llama3_2_1b", "train_4k", _one_rank(),
                             smoke=True)
    cfg = cell.cfg
    gen = torch.Generator().manual_seed(5)
    params = plm.init_params(gen, cfg)
    toks = torch.randint(0, cfg.vocab, (4, 32), generator=gen)
    batch = {"tokens": toks, "labels": toks.roll(1, 1)}
    (new, _), metrics = cell.step_fn((params, cell.opt.init(params)), batch)
    leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, _ = plm.loss_fn(leaves, batch, cfg)
    loss.backward()
    opt = adamw(1e-4, norm_fn=global_norm)
    want, _, _ = opt.update(tree_map(lambda t: t.grad, leaves),
                            opt.init(params), params)
    assert abs(float(metrics["loss"]) - float(loss)) <= 1e-5
    errs = []
    tree_map(lambda a, b: errs.append(float((a - b).abs().max())), new, want)
    assert max(errs) <= 1e-5


def test_bst_and_gnn_cells_on_one_rank_are_unsharded():
    from repro_torch.data import graphs, recsys
    from repro_torch.interop import gnn_batch_from_numpy
    mesh = _one_rank()
    cell = pcells.build_cell("bst", "serve_p99", mesh, smoke=True)
    params = pbst.init_params(torch.Generator().manual_seed(1), cell.cfg)
    batch = {k: torch.as_tensor(v)
             for k, v in recsys.bst_batch(cell.cfg, 16, 2).items()}
    got = cell.step_fn(params, batch)
    assert float((got - pbst.forward(params, batch, cell.cfg)).abs().max()
                 ) <= 1e-6
    cell = pcells.build_cell("gat_cora", "full_graph_sm", mesh, smoke=True)
    params = pgnn.init_params(torch.Generator().manual_seed(1), cell.cfg)
    graph = gnn_batch_from_numpy(graphs.cora_like(
        2, 40, 120, cell.cfg.d_in, cell.cfg.n_classes), "cpu")
    graph.pop("n_graphs")
    _, metrics = cell.step_fn((params, cell.opt.init(params)), graph)
    want, _ = pgnn.loss_fn(params, dict(graph, n_graphs=1), cell.cfg)
    assert abs(float(metrics["loss"]) - float(want)) <= 1e-6


@contextlib.contextmanager
def _gloo_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_dpc_cells_on_one_rank_are_the_pure_path(tmp_path):
    from repro_torch.core.connected_components import \
        connected_components_grid
    from repro_torch.core.distributed_graph import assemble_graph_labels
    from repro_torch.core.ms_segmentation import descending_manifold
    rng = np.random.default_rng(0)
    with _gloo_one(tmp_path):
        mesh = _one_rank()
        for shape_name in ("cc_ragged", "grid_ragged"):
            cell = pcells.build_cell("dpc_grid", shape_name, mesh,
                                     smoke=True)
            dims = cell.arg_shapes[0].shape
            if shape_name == "cc_ragged":
                x = torch.from_numpy(rng.random(dims) < 0.6)
                want = connected_components_grid(x, 6, "ref").labels
            else:
                x = torch.from_numpy(rng.permutation(int(np.prod(dims)))
                                     .astype(np.int32).reshape(dims))
                want = descending_manifold(x, 6, "ref")[0]
            labels, stats = cell.step_fn(*cell.local((x,)))
            assert torch.equal(labels.reshape(dims).long(),
                               want.reshape(dims).long()), shape_name
            assert "flattened 1-D mesh" in cell.note
        # JAX's test_dpc_graph_cell_smoke, plus the pure path's labels
        for shape_name in pconfigs.get("dpc_graph").SMOKE_SHAPES:
            cell = pcells.build_cell("dpc_graph", shape_name, mesh,
                                     smoke=True)
            n = cell.arg_shapes[0].shape[0]
            mask = torch.from_numpy(rng.random(n) < 0.5)
            labels, stats = cell.step_fn(*cell.local((mask,)))
            labels = assemble_graph_labels([labels], cell.decomp)
            assert labels.shape == (n,)
            if cell.shape.get("geometry"):
                assert bool((labels >= 0).all())
            else:
                assert bool((labels[~mask] == -1).all())
                assert bool((labels[mask] >= 0).all())
            assert int(stats.comm_phases) <= 1


# --- the kernels on meta tensors ----------------------------------------------


def _meta_vs_plain(fn, *real, **kw):
    """(meta outputs, plain outputs, counts) of `fn` on meta copies of the
    real inputs and on the real CPU inputs."""
    metas = [t.to("meta") if isinstance(t, torch.Tensor) else t
             for t in real]
    with _meta.counting() as cm:
        got = fn(*metas, **kw)
    with _meta.counting() as cr:
        want = fn(*real, **kw)
    assert cr.kernel_calls == {} and cr.kernel_flops == 0   # no meta branch
    return got, want, cm


def _same_outputs(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        if isinstance(w, torch.Tensor):
            assert g.is_meta and g.shape == w.shape and g.dtype == w.dtype


def test_pointer_kernels_meta_rule():
    gen = torch.Generator().manual_seed(0)
    shape = (5, 6, 7)
    n = 5 * 6 * 7
    order = torch.randperm(n, generator=gen).to(torch.int32).reshape(shape)
    mask = torch.rand(shape, generator=gen) < 0.5
    for field, mode, per in ((order, "manifold", 8), (mask, "cc", 5)):
        got, want, c = _meta_vs_plain(ops.fused_local_phase, field, 6,
                                      mode=mode)
        _same_outputs(got, want)
        assert got[1] == 1                      # one round is costed
        assert c.kernel_calls == {f"fused_local_phase/{mode}": 1}
        assert c.kernel_flops == n * 7 and c.kernel_bytes == n * per
    got, want, c = _meta_vs_plain(ops.steepest_neighbor, order, 26)
    _same_outputs(got, want)
    assert (c.kernel_flops, c.kernel_bytes) == (n * 27, 8 * n)
    d = torch.randint(0, 100, (100,), dtype=torch.int32, generator=gen)
    got, want, c = _meta_vs_plain(ops.block_pathcompress, d, 3, 32)
    _same_outputs(got, want)
    assert (c.kernel_flops, c.kernel_bytes) == (300, 800)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_model_kernels_meta_rule(dtype):
    gen = torch.Generator().manual_seed(1)
    q = torch.randn(2, 4, 12, 16, generator=gen).to(dtype)
    k = torch.randn(2, 2, 20, 16, generator=gen).to(dtype)
    v = torch.randn(2, 2, 20, 16, generator=gen).to(dtype)
    got, want, c = _meta_vs_plain(ops.flash_attention, q, k, v, causal=True,
                                  check_tiles=False)
    _same_outputs(got, want)
    pairs = sum(min(i + 8 + 1, 20) for i in range(12))
    size = q.element_size()
    assert c.kernel_flops == 4 * 2 * 4 * 16 * pairs
    assert c.kernel_bytes == size * (2 * q.numel() + k.numel() + v.numel())
    table = torch.randn(50, 8, generator=gen).to(dtype)
    ids = torch.randint(-1, 50, (3, 4), generator=gen)
    got, want, c = _meta_vs_plain(ops.embedding_bag, table, ids)
    _same_outputs(got, want)
    assert c.kernel_flops == 3 * 4 * 8
    assert c.kernel_bytes == ids.numel() * 8 + 12 * 8 * size + 3 * 8 * size


def test_visible_pairs_counts_the_bottom_right_causal_mask():
    for sq, sk in ((1, 1), (5, 9), (9, 5), (12, 20), (7, 7), (16, 3)):
        want = sum(max(0, min(i + sk - sq + 1, sk)) for i in range(sq))
        assert _meta.visible_pairs(sq, sk, True) == want, (sq, sk)
        assert _meta.visible_pairs(sq, sk, False) == sq * sk


def test_meta_loops_run_once_and_real_loops_are_exact():
    from repro_torch.core.pathcompress import path_compress
    d = torch.tensor([1, 2, 3, 4, 5, 5], dtype=torch.int32)
    out, iters = path_compress(d)
    assert iters == 4 and out.tolist() == [5] * 6
    out, iters = path_compress(d.to("meta"))
    assert iters == 1 and out.is_meta and out.shape == d.shape
    assert _meta.nonzero(torch.tensor([0, 1, 1])).tolist() == [1, 2]
    assert _meta.nonzero(torch.ones(4, device="meta")).shape == (4,)

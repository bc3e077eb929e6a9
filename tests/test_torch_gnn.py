"""The port's GNN substrate (`repro_torch.models.gnn`, the GNN configs, the
GNN parts of `repro_torch.data.graphs`, `interop.gnn_params_from_jax` /
`gnn_batch_from_numpy`, `examples/gnn_cc_pipeline_torch.py`) against the
JAX package, on the CPU.

The same seeded numpy data go through both packages; JAX's parameters
cross to the port by `gnn_params_from_jax`.  Each arch's JAX reference
(apply, loss and aux, every gradient, one AdamW step) is computed once, by
one jitted function, in a module fixture.

Tolerances: the data and the DPC-CC labels bit for bit; fp32 outputs and
losses within 1e-5 of the tensor's largest |value| (sums in other orders);
every gradient leaf within 1e-4 of its largest |value|; `acc` equal; the
parameters after one AdamW step within 1e-6 of JAX's when both apply it
to the same (JAX's) gradients, and within 2 lr where each package steps on
its own gradients (AdamW's first step is lr times the gradient's sign, so
a gradient that is zero up to rounding may step either way); DimeNet with
bf16 messages within 8 bf16 ulps of the largest |energy|.
"""
import contextlib
import dataclasses
import functools
import importlib.util
import io
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as jconfigs
from repro.data import graphs as jgraphs
from repro.models import gnn as jgnn
from repro import optim as joptim
import repro_torch.configs as pconfigs
from repro_torch import optim
from repro_torch.data import graphs as pgraphs
from repro_torch.interop import gnn_batch_from_numpy, gnn_params_from_jax
from repro_torch.models import gnn as pgnn
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_names

ARCHS = ("gat_cora", "schnet", "meshgraphnet", "dimenet")
ALIASES = {"gat_cora": ("gat-cora",), "schnet": (), "meshgraphnet": (),
           "dimenet": ()}
OUT_TOL, GRAD_TOL, LR = 1e-5, 1e-4, 1e-3
EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _within(got, want, tol, what=""):
    """max |got - want| <= tol * max |want| (tol alone where want is 0)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max(initial=0)), 1.0 if not want.size
                else 0.0) or 1.0
    err = float(np.abs(got - want).max(initial=0))
    assert err <= tol * scale, (what, err, scale)


def _jax_batch(b):
    return {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
            for k, v in b.items()}


def _batch(arch, full=False):
    """A small seeded batch of the arch's kind (numpy, JAX's generators);
    `full` gives GAT cora's 1,433 features."""
    if arch == "gat_cora":
        return jgraphs.cora_like(3, 40 if full else 48, 160,
                                 1433 if full else 16, 7)
    if arch in ("schnet", "dimenet"):
        return jgraphs.molecule_batch(3 if full else 6, 8, 18, seed=1)
    return jgraphs.mesh_grid_graph(4 if full else 5, 5 if full else 6, seed=2)


@functools.lru_cache(maxsize=None)
def _jitted(name, cfg, n_graphs=None):
    """JAX's `init_params` / `apply` / loss-and-gradients of `cfg`, jitted
    once a (config, n_graphs) for the whole module."""
    if name == "init":
        return jax.jit(functools.partial(jgnn.init_params, cfg=cfg))

    def run(p, b):
        b = dict(b, n_graphs=n_graphs)
        if name == "apply":
            return jgnn.apply(p, b, cfg)
        (loss, aux), grads = jax.value_and_grad(
            jgnn.loss_fn, has_aux=True)(p, b, cfg)
        return loss, aux, grads

    return jax.jit(run)


def _jax(name, cfg, params, batch):
    """`_jitted(name)` on a numpy batch; results as numpy."""
    b = {k: v for k, v in batch.items() if k != "n_graphs"}
    out = _jitted(name, cfg, batch["n_graphs"])(params, b)
    return jax.tree.map(np.asarray, out)


def _params(cfg, seed):
    """JAX's parameters of `cfg` (numpy) and the port's copy of them."""
    jp = jax.tree.map(np.asarray,
                      _jitted("init", cfg)(jax.random.PRNGKey(seed)))
    return jp, gnn_params_from_jax(jp, "cpu")


def _torch_leaves(tree):
    return tree_map(lambda t: t.detach().clone().requires_grad_(), tree)


def _port_loss_and_grads(params, batch, cfg):
    leaves = _torch_leaves(params)
    loss, aux = pgnn.loss_fn(leaves, batch, cfg)
    loss.backward()
    return loss.detach(), aux, tree_map(lambda t: t.grad, leaves)


class Ref:
    """One arch at its smoke config in both packages: JAX's parameters,
    batch, and results of one jitted function, the port's copies."""

    def __init__(self, arch):
        self.jcfg = jconfigs.get(arch).smoke_config()
        self.pcfg = pconfigs.get(arch).smoke_config()
        self.batch = _batch(arch)
        self.jp, self.pp = _params(self.jcfg, 0)
        self.pb = gnn_batch_from_numpy(self.batch, "cpu")
        cfg, opt = self.jcfg, joptim.adamw(LR)
        n_graphs = self.batch["n_graphs"]

        @jax.jit
        def run(p, b):
            b = dict(b, n_graphs=n_graphs)
            (loss, aux), grads = jax.value_and_grad(
                jgnn.loss_fn, has_aux=True)(p, b, cfg)
            new_p, _, om = opt.update(grads, opt.init(p), p)
            return jgnn.apply(p, b, cfg), loss, aux, grads, new_p, om

        jb = {k: v for k, v in _jax_batch(self.batch).items()
              if k != "n_graphs"}
        out = jax.tree.map(np.asarray, run(self.jp, jb))
        self.out, self.loss, self.aux, grads, new_p, self.om = out
        self.grads = gnn_params_from_jax(grads, "cpu")
        self.new_params = gnn_params_from_jax(new_p, "cpu")


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    return Ref(request.param)


# --- configs -----------------------------------------------------------------


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_jax_copies(arch):
    jmod = jconfigs.get(arch)
    for name in (arch,) + ALIASES[arch] + (arch.replace("_", "-"),):
        pmod = pconfigs.get(name)
        assert pmod.__name__ == f"repro_torch.configs.{arch}"
        assert pmod.FAMILY == jmod.FAMILY == "gnn"
        assert pmod.SHAPES == jmod.SHAPES
        assert pmod.SMOKE_SHAPES == jmod.SMOKE_SHAPES
    for make in ("full_config", "smoke_config"):
        jc, pc = getattr(jmod, make)(), getattr(pmod, make)()
        jf = _fields(jc)
        assert list(_fields(pc)) == list(jf)
        for k, v in _fields(pc).items():
            want = jf[k]
            if k == "msg_dtype":
                v, want = str(v).removeprefix("torch."), jnp.dtype(want).name
            assert v == want, (arch, make, k)
        assert type(pc) is pgnn.ARCHS[pc.arch][0]


# --- data ----------------------------------------------------------------------


def _same_arrays(got, want):
    assert list(got) == list(want)
    for k in want:
        a, b = got[k], want[k]
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert np.array_equal(a, b), k
        else:
            assert type(a) is type(b) and a == b, k


@pytest.mark.parametrize("args", [dict(), dict(seed=5, n_nodes=300,
                                               n_edges=999, d_feat=33,
                                               n_classes=4)])
def test_cora_like_equals_jax(args):
    _same_arrays(pgraphs.cora_like(**args), jgraphs.cora_like(**args))


@pytest.mark.parametrize("args", [
    dict(batch=4, n_nodes=10, n_edges=24, seed=3),
    dict(batch=3, n_nodes=9, n_edges=20, n_species=5, seed=4,
         max_triplets_per_graph=7)])
def test_molecule_batch_equals_jax(args):
    _same_arrays(pgraphs.molecule_batch(**args),
                 jgraphs.molecule_batch(**args))


@pytest.mark.parametrize("max_triplets", [5, 200])
def test_build_triplets_equals_jax(max_triplets):
    """Cut at max_triplets, and padded (pads at edge 0, mask 0)."""
    rng = np.random.default_rng(6)
    s = rng.integers(0, 12, 40).astype(np.int32)
    r = rng.integers(0, 12, 40).astype(np.int32)
    got = pgraphs.build_triplets(s, r, 12, max_triplets)
    want = jgraphs.build_triplets(s, r, 12, max_triplets)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_mesh_grid_graph_equals_jax():
    _same_arrays(pgraphs.mesh_grid_graph(7, 5, seed=9, d_node_in=3,
                                         d_edge_in=2, d_out=4),
                 jgraphs.mesh_grid_graph(7, 5, seed=9, d_node_in=3,
                                         d_edge_in=2, d_out=4))


def _samplers(seed=1):
    indptr, indices = pgraphs.random_csr(500, 6, seed=seed)
    return (pgraphs.NeighborSampler(indptr, indices, (4, 3), seed=seed),
            jgraphs.NeighborSampler(indptr, indices, (4, 3), seed=seed))


def test_neighbor_sampler_equals_jax():
    ps, js = _samplers()
    assert ps.max_sample_nodes(16) == js.max_sample_nodes(16) == 16 * 17
    assert ps.max_sample_edges(16) == js.max_sample_edges(16)
    seeds = np.random.default_rng(0).integers(0, 500, 16)
    for _ in range(2):                     # the sampler's rng advances
        for a, b in zip(ps.sample(seeds), js.sample(seeds)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_sampled_batch_equals_jax():
    ps, js = _samplers(2)
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((500, 8)).astype(np.float32)
    labels = rng.integers(0, 5, 500)
    for step in (0, 4):
        got = pgraphs.sampled_batch(ps, feats, labels, 12, step=step)
        want = jgraphs.sampled_batch(js, feats, labels, 12, step=step)
        _same_arrays(got, want)
        assert not got["edge_mask"].all()          # padded edges present


def test_component_labels_equal_jax():
    ps, js = _samplers(4)
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((500, 4)).astype(np.float32)
    labels = rng.integers(0, 3, 500)
    b = pgraphs.sampled_batch(ps, feats, labels, 10, step=1)
    got = pgraphs.component_labels(b, "cpu")
    want = jgraphs.component_labels(
        jgraphs.sampled_batch(js, feats, labels, 10, step=1))
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert len(np.unique(got[got >= 0])) > 1


# --- interop -------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_params_cross_bit_for_bit_in_port_order(arch):
    """`gnn_params_from_jax` keeps every tensor's bits; MeshGraphNet's
    stacked layers become a list of per-layer dicts.  The port's own init
    has the same tree: names, key order, shapes and dtypes."""
    jcfg = jconfigs.get(arch).smoke_config()
    jp, pp = _params(jcfg, 0)
    own = pgnn.init_params(torch.Generator().manual_seed(1),
                           pconfigs.get(arch).smoke_config())

    def names(tree):
        out = []
        tree_map_with_names(lambda n, t: out.append(
            (n, tuple(t.shape), t.dtype)), tree)
        return out

    assert names(pp) == names(own)
    if arch == "meshgraphnet":
        assert len(pp["layers"]) == jcfg.n_layers
        for i, lp in enumerate(pp["layers"]):
            for part in ("edge_mlp", "node_mlp"):
                for got, want in zip(lp[part], jp["layers"][part]):
                    for k in ("w", "b"):
                        assert np.array_equal(got[k].numpy(), want[k][i])
    else:
        flat = jax.tree_util.tree_leaves(jp)
        assert len(flat) == len(tree_leaves(pp))
        for got, want in zip(tree_leaves(pp), flat):
            assert got.dtype == torch.float32
            assert np.array_equal(got.numpy(), want)


def test_batch_from_numpy_keeps_n_graphs_and_cuts_to_32_bits():
    b = dict(jgraphs.molecule_batch(2, 6, 10, seed=0),
             positions=np.zeros((12, 3)), senders=np.arange(20))
    t = gnn_batch_from_numpy(b, "cpu")
    assert t["n_graphs"] == 2 and type(t["n_graphs"]) is int
    assert t["positions"].dtype == torch.float32
    assert t["senders"].dtype == torch.int32
    assert t["node_mask"].dtype == torch.bool
    assert t["triplet_src"].dtype == torch.int32


def test_entry_points_need_a_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    b = jgraphs.cora_like(0, 10, 20, 4, 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gnn_batch_from_numpy(b)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pgraphs.component_labels(b)


# --- init ------------------------------------------------------------------------


def _full_width(arch):
    """(JAX's, the port's) `full_config()` of `arch`, MeshGraphNet and
    DimeNet cut to 2 layers / blocks (the widths are full)."""
    depth = {"meshgraphnet": {"n_layers": 2}, "dimenet": {"n_blocks": 2}}
    return tuple(dataclasses.replace(c.full_config(), **depth.get(arch, {}))
                 for c in (jconfigs.get(arch), pconfigs.get(arch)))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_draws_at_jax_scales(arch):
    """At full width (MeshGraphNet and DimeNet cut to 2 layers / blocks):
    every weight matrix is a truncated normal on [-2, 2] times 1/sqrt(fan
    in) (`dense_init`), every bias 0, the species tables a normal times
    0.1, as JAX draws them (the same distributions, not the same
    values)."""
    jcfg, pcfg = _full_width(arch)
    jp = _params(jcfg, 0)[1]
    pp = pgnn.init_params(torch.Generator().manual_seed(0), pcfg)
    seen = []

    def check(name, got):
        want = dict(pairs)[name]
        key = name.rsplit("/", 1)[-1]
        if key == "b":
            assert not got.any(), name
        elif key == "embed":
            assert abs(float(got.std()) - float(want.std())) < 0.15 * 0.1
            assert abs(float(got.std()) - 0.1) < 0.15 * 0.1
        else:
            fan_in = got.shape[1] if key in ("a_src", "a_dst") else \
                got.shape[0]
            scale = 1 / math.sqrt(fan_in)
            assert float(got.abs().max()) <= 2 * scale * (1 + 1e-6), name
            if got.numel() >= 256:
                assert abs(float(got.std()) / scale - 0.8796) < 0.1, name
                assert abs(float(got.std()) - float(want.std())) \
                    < 0.1 * float(want.std()), name
        seen.append(name)
        return got

    pairs = []
    tree_map_with_names(lambda n, t: pairs.append((n, t)), jp)
    tree_map_with_names(check, pp)
    assert len(seen) == len(pairs)
    # the generator's device is the parameters' device
    assert all(t.device.type == "cpu" for t in tree_leaves(pp))


# --- the models ----------------------------------------------------------------


def test_apply_loss_and_aux_vs_jax(ref):
    out = pgnn.apply(ref.pp, ref.pb, ref.pcfg)
    _within(out, ref.out, OUT_TOL, "apply")
    loss, aux = pgnn.loss_fn(ref.pp, ref.pb, ref.pcfg)
    _within(loss, ref.loss, OUT_TOL, "loss")
    assert set(aux) == set(ref.aux)
    if "acc" in aux:
        assert float(aux["acc"]) == float(ref.aux["acc"])


def test_gradients_vs_jax(ref):
    loss, _, grads = _port_loss_and_grads(ref.pp, ref.pb, ref.pcfg)
    _within(loss, ref.loss, OUT_TOL, "loss")
    names = []
    tree_map_with_names(lambda n, t: names.append(n), grads)
    for name, got, want in zip(names, tree_leaves(grads),
                               tree_leaves(ref.grads)):
        assert bool(torch.isfinite(got).all()), name
        _within(got, want, GRAD_TOL, name)


def test_adamw_step_vs_jax(ref):
    """The port's AdamW on JAX's gradients == JAX's step; on the port's own
    gradients within 2 lr of it (and most leaves much closer)."""
    opt = optim.adamw(LR)
    new, _, om = opt.update(ref.grads, opt.init(ref.pp), ref.pp)
    for got, want in zip(tree_leaves(new), tree_leaves(ref.new_params)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-6)
    _within(om["grad_norm"], ref.om["grad_norm"], 1e-6)
    _, _, grads = _port_loss_and_grads(ref.pp, ref.pb, ref.pcfg)
    own, _, _ = opt.update(grads, opt.init(ref.pp), ref.pp)
    for got, want in zip(tree_leaves(own), tree_leaves(ref.new_params)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=2 * LR)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_forward_vs_jax(arch):
    """Each arch's forward at full width (2 layers / blocks deep) on a tiny
    graph (GAT: cora's 1,433 features)."""
    jcfg, pcfg = _full_width(arch)
    batch = _batch(arch, full=True)
    jp, pp = _params(jcfg, 0)
    want = _jax("apply", jcfg, jp, batch)
    got = pgnn.apply(pp, gnn_batch_from_numpy(batch, "cpu"), pcfg)
    _within(got, want, OUT_TOL, arch)


def test_mgn_remat_changes_nothing(monkeypatch):
    """MeshGraphNet's layers under `torch.utils.checkpoint` (gradients on)
    give the loss and gradients of the plain loop, bit for bit."""
    cfg = pconfigs.get("meshgraphnet").smoke_config()
    params = pgnn.init_params(torch.Generator().manual_seed(3), cfg)
    batch = gnn_batch_from_numpy(jgraphs.mesh_grid_graph(4, 6, seed=1),
                                 "cpu")
    calls = []
    remat = pgnn._remat

    def counted(fn, *args):
        calls.append(fn)
        return remat(fn, *args)

    monkeypatch.setattr(pgnn, "_remat", counted)
    loss, _, grads = _port_loss_and_grads(params, batch, cfg)
    assert len(calls) == cfg.n_layers
    monkeypatch.setattr(pgnn, "_remat", lambda fn, *args: fn(*args))
    loss2, _, grads2 = _port_loss_and_grads(params, batch, cfg)
    assert torch.equal(loss, loss2)
    for a, b in zip(tree_leaves(grads), tree_leaves(grads2)):
        assert torch.equal(a, b)


# --- the cases -------------------------------------------------------------------


def test_segment_softmax_empty_and_fully_masked_segments():
    """Segment 1 has no edge (max -inf, read as 0), segment 3's edges are
    all masked (max -1e30): both give 0; (E,) and (E, H) logits."""
    rng = np.random.default_rng(7)
    seg = np.array([0, 0, 2, 2, 2, 3, 3, 4], np.int32)
    mask = np.array([1, 1, 1, 0, 1, 0, 0, 1], bool)
    for shape in ((8,), (8, 3)):
        logits = (rng.standard_normal(shape) * 30).astype(np.float32)
        for m in (None, mask):
            want = jgnn.segment_softmax(
                jnp.asarray(logits), jnp.asarray(seg), 6,
                None if m is None else jnp.asarray(m if len(shape) == 1
                                                   else m[:, None]))
            got = pgnn.segment_softmax(
                torch.from_numpy(logits), torch.from_numpy(seg), 6,
                None if m is None else torch.from_numpy(m))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7)
            if m is not None:
                assert not got[5:7].any()


def test_gat_on_a_sampled_batch_with_padded_edges():
    """A minibatch_lg-style batch: padded edges at node max_n - 1, mask 0,
    labels only on the seeds.  Loss, acc and gradients as JAX's."""
    ps, js = _samplers(3)
    rng = np.random.default_rng(8)
    feats = rng.standard_normal((500, 16)).astype(np.float32)
    labels = rng.integers(0, 7, 500)
    b = pgraphs.sampled_batch(ps, feats, labels, 8, step=2)
    assert not b["edge_mask"].all()
    jcfg = jconfigs.get("gat_cora").smoke_config()
    pcfg = pconfigs.get("gat_cora").smoke_config()
    jp, pp = _params(jcfg, 5)
    jl, jaux, jgr = _jax("grad", jcfg, jp, b)
    loss, aux, grads = _port_loss_and_grads(
        pp, gnn_batch_from_numpy(b, "cpu"), pcfg)
    _within(loss, jl, OUT_TOL, "loss")
    assert float(aux["acc"]) == float(jaux["acc"])
    for got, want in zip(tree_leaves(grads),
                         tree_leaves(gnn_params_from_jax(jgr, "cpu"))):
        _within(got, want, GRAD_TOL)


@pytest.fixture(scope="module")
def dimenet_case():
    jcfg = jconfigs.get("dimenet").smoke_config()
    b = jgraphs.molecule_batch(4, 8, 16, seed=2, max_triplets_per_graph=24)
    return (jcfg, b) + _params(jcfg, 6)


@pytest.mark.parametrize("chunks", [1, 4, 5])
def test_dimenet_triplet_chunks_vs_jax(dimenet_case, chunks):
    """T = 96: 4 chunks of 24, and 5 (not a divisor) runs as one chunk.
    Energies and gradients as JAX's; the chunked loss equals one chunk's
    within rounding."""
    jcfg, b, jp, pp = dimenet_case
    assert len(b["triplet_src"]) == 96
    jcfg = dataclasses.replace(jcfg, triplet_chunks=chunks)
    pcfg = dataclasses.replace(pconfigs.get("dimenet").smoke_config(),
                               triplet_chunks=chunks)
    jl, _, jgr = _jax("grad", jcfg, jp, b)
    pb = gnn_batch_from_numpy(b, "cpu")
    loss, _, grads = _port_loss_and_grads(pp, pb, pcfg)
    _within(loss, jl, OUT_TOL, "loss")
    _within(pgnn.apply(pp, pb, pcfg), _jax("apply", jcfg, jp, b), OUT_TOL,
            "energies")
    for got, want in zip(tree_leaves(grads),
                         tree_leaves(gnn_params_from_jax(jgr, "cpu"))):
        _within(got, want, GRAD_TOL)


def test_dimenet_bf16_messages_vs_jax(dimenet_case):
    """msg_dtype bfloat16 (m and w_kj cast before the product, the triplet
    sum in bf16, cast back after it): energies within 8 bf16 ulps of the
    largest |energy|, and near the fp32 model's."""
    jcfg, b, jp, pp = dimenet_case
    for chunks in (1, 4):
        jc = dataclasses.replace(jcfg, msg_dtype=jnp.bfloat16,
                                 triplet_chunks=chunks)
        pc = dataclasses.replace(pconfigs.get("dimenet").smoke_config(),
                                 msg_dtype=torch.bfloat16,
                                 triplet_chunks=chunks)
        want = _jax("apply", jc, jp, b)
        got = pgnn.apply(pp, gnn_batch_from_numpy(b, "cpu"), pc)
        assert got.dtype == torch.float32
        top = float(np.abs(want).max())
        ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
        assert float(np.abs(got.numpy() - want).max()) <= 8 * ulp
        f32 = _jax("apply", jcfg, jp, b)
        assert float(np.abs(got.numpy() - f32).max()) <= 0.1 * top


def test_ids_out_of_range_follow_jax():
    """Edge ids outside [0, n): a gather wraps a negative id once and clamps
    (h[snd], att_d[rcv], pos[...], vec[t_kj]); a segment sum or max drops
    it.  GAT and DimeNet (triplet ids too) equal JAX's, and the raw
    segment ops do."""
    b = jgraphs.cora_like(1, 30, 80, 16, 7)
    b["senders"][:6] = [-1, -31, -70, 30, 99, 5]
    b["receivers"][6:12] = [-1, -29, 30, 45, -100, 7]
    jcfg = jconfigs.get("gat_cora").smoke_config()
    jp, pp = _params(jcfg, 7)
    pcfg = pconfigs.get("gat_cora").smoke_config()
    _within(pgnn.apply(pp, gnn_batch_from_numpy(b, "cpu"), pcfg),
            _jax("apply", jcfg, jp, b), OUT_TOL, "gat")

    m = jgraphs.molecule_batch(2, 6, 12, seed=3, max_triplets_per_graph=20)
    m["senders"][:3] = [-1, 12, -20]
    m["receivers"][3:5] = [12, -13]
    m["triplet_src"][:3] = [-1, 24, 99]
    m["triplet_dst"][3:6] = [-2, 24, -99]
    jcfg = jconfigs.get("dimenet").smoke_config()
    jp, pp = _params(jcfg, 8)
    pcfg = pconfigs.get("dimenet").smoke_config()
    _within(pgnn.apply(pp, gnn_batch_from_numpy(m, "cpu"), pcfg),
            _jax("apply", jcfg, jp, m), OUT_TOL, "dimenet")

    data = np.arange(12, dtype=np.float32).reshape(6, 2)
    seg = np.array([0, -1, 3, 4, 2, -5], np.int32)
    gather, ids = pgnn._ids(torch.from_numpy(seg), 4)
    np.testing.assert_array_equal(
        pgnn.segment_sum(torch.from_numpy(data), ids, 4).numpy(),
        np.asarray(jax.ops.segment_sum(data, seg, num_segments=4)))
    np.testing.assert_array_equal(
        gather.numpy(), np.asarray(jnp.arange(4)[jnp.asarray(seg)]))
    np.testing.assert_allclose(
        pgnn.segment_softmax(torch.from_numpy(data[:, 0]),
                             torch.from_numpy(seg), 4).numpy(),
        np.asarray(jgnn.segment_softmax(data[:, 0], seg, 4)), rtol=1e-6)


def test_labels_past_the_classes_read_nan_as_jax():
    b = jgraphs.cora_like(2, 20, 60, 16, 7)
    b["labels"][3] = 9
    jcfg = jconfigs.get("gat_cora").smoke_config()
    jp, pp = _params(jcfg, 9)
    jl = _jax("grad", jcfg, jp, b)[0]
    pl, _ = pgnn.loss_fn(pp, gnn_batch_from_numpy(b, "cpu"),
                         pconfigs.get("gat_cora").smoke_config())
    assert np.isnan(float(jl)) and math.isnan(float(pl))


def test_gaussian_rbf_centres_are_jax_linspace():
    """SchNet's 300 centres on [0, 10] are jnp.linspace's float32 values
    bit for bit (torch.linspace's differ in the last bit of many)."""
    for n, stop in ((300, 10.0), (16, 10.0), (7, 5.0), (50, 3.0)):
        got = pgnn._centres(stop, n, "cpu").numpy()
        assert np.array_equal(got, np.asarray(jnp.linspace(0.0, stop, n)))


# --- the example twin ------------------------------------------------------------


def _load_example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_pipeline_twin_counts_equal_jax_example():
    """`examples/gnn_cc_pipeline_torch.py --device cpu --steps 3` samples
    the nodes and finds the DPC components that JAX's example prints for
    its first three steps."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _load_example("gnn_cc_pipeline").main()
    want = [(int(line.split()[3]), int(line.split()[6]))
            for line in out.getvalue().splitlines()
            if line.startswith("step ")]
    with contextlib.redirect_stdout(io.StringIO()):
        got = _load_example("gnn_cc_pipeline_torch").main(
            ["--device", "cpu", "--steps", "3"])
    assert [(r["nodes"], r["components"]) for r in got] == want[:3]
    assert all(math.isfinite(r["loss"]) for r in got)

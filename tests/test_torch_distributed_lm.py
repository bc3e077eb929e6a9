"""The port's LM on a mesh (`runtime.meshctx`, `launch.mesh`, the sharded
paths of `models.lm`, `checkpoint`, `launch.train`) against JAX's
single-device results, on the CPU.

One gloo group of 8 CPU ranks, mesh (2, 4) over ("data", "model"), runs
`tests/torch_lm_ranks.py` once for the module, while this process computes
JAX's references.  JAX's own sharded test (`tests/test_distributed_lm.py`)
fails under jax 0.9.0 (ROADMAP.md Queue 3), so the targets are JAX's
unsharded results on JAX's test configuration (2 layers, d_model 64, 8/4
heads, d_head 8, d_ff 128, vocab 128, tokens (4, 32), AdamW 1e-3):

  * one sharded AdamW step, FSDP and sequence parallelism each on and
    off: loss within 2e-4 of JAX's step (JAX's test's bound), the
    updated parameters within 1e-5 (a sign flip of a near-zero gradient
    moves a weight by 2 lr = 2e-3; none happens here);
  * context-parallel decode of JAX's prefill cache (max_len 40, the
    sequence over ("data", "model"), 5 positions a rank) against JAX's
    `decode_step`: logits within 1e-5 (JAX's test allows 2e-3), cache
    length 33;
  * the shard_map MoE on the deepseek smoke config (16 experts, 4 a
    rank) against JAX's `_moe_ffn_local` with dp_shards 2: y within 1e-5,
    aux within 1e-6;
  * every rank holds 1 / (its spec's blocks) of each leaf;
  * the training state saved on (2, 4) and loaded on (4, 2): bit for bit;
  * `launch.train.main` on the 8 ranks (llama smoke on a (4, 2) mesh,
    deepseek smoke on the default (1, 8) through one `--chaos` restart,
    which restores the step-5 checkpoint onto the mesh) from JAX's
    weights against a JAX step loop without a mesh: eval loss within 1e-4
    relative;
  * the llama3.2-1b smoke config on (1, 8), 8 "model" ranks over its 4
    KV heads: one AdamW step within 2e-4 (loss) and 1e-5 (parameters) of
    JAX's unsharded step and of the port's on one rank;
  * BST's smoke config on (2, 4) (tables row-sharded over "model", the
    batch over "data"): logits and loss within 1e-5 of the largest
    |value|, every gradient leaf within 1e-4 of its largest, retrieval ids
    equal, against JAX and against one rank;
  * the four GNN smoke configs on (2, 4), every node, edge and triplet
    array split over the 8 ranks (batches padded to multiples of 8 by
    `data.graphs.pad_graph`, JAX computing on the same padded batch):
    outputs and loss within 1e-5 of the largest |value|, every gradient
    leaf within 1e-4 of its largest, against JAX and one rank.
"""
import dataclasses
import math
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as jconfigs
from repro import optim as joptim
from repro.models import lm as jlm
from repro_torch.interop import lm_params_from_jax
import repro_torch.configs as pconfigs
from repro_torch.models import bst as pbst
from repro_torch.models import gnn as pgnn
from repro_torch.models import lm as plm
from repro_torch.runtime.meshctx import logical_to_spec
from repro_torch.tree import tree_map, tree_map_with_names

from repro.data import recsys as jrecsys
from repro.models import bst as jbst
from repro_torch.data.graphs import pad_graph
from repro_torch.interop import (bst_params_from_jax, gnn_batch_from_numpy,
                                 gnn_params_from_jax)
from torch_lm_ranks import (COMBOS, GNN_ARCHS, LAUNCH, LAUNCH_ARGS, LR,
                            MESH, WORLD, lm_test_config)
from test_torch_gnn import _batch as _gnn_batch
from test_torch_gnn import _jax as _gnn_jax
from test_torch_train import _jax_step_loop

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "..", "src")
RANKS_TIMEOUT_S = 300
MOE_T = 32


def _jax_cfg(**kw):
    return jlm.LMConfig(name="t", n_layers=2, d_model=64, n_heads=8,
                        n_kv_heads=4, d_ff=128, vocab=128, d_head=8,
                        loss_chunks=2, **kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _to_jax(params, stacked=False):
    """A port parameter tree as JAX's: numpy leaves, the per-layer list
    "layers" stacked on a leading axis where JAX scans it."""
    tree = tree_map(lambda t: t.detach().numpy(), params)
    if stacked:
        tree["layers"] = jax.tree.map(lambda *xs: np.stack(xs),
                                      *tree["layers"])
    return tree


def _jax_moe_cfg():
    cfg = jconfigs.get("deepseek-moe-16b").smoke_config()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch="local", dp_shards=MESH[0]))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the ranks' records, JAX's references)."""
    out = tmp_path_factory.mktemp("lm_ranks")
    jcfg = _jax_cfg()
    key = jax.random.PRNGKey(0)
    params = jlm.init_params(key, jcfg)
    toks = jax.random.randint(key, (4, 32), 0, jcfg.vocab)
    logits, cache = jax.jit(lambda p, t: jlm.prefill(p, t, jcfg, 40))(
        params, toks)
    nxt = jnp.argmax(logits, -1)[:, None]
    mcfg = _jax_moe_cfg()
    mparams = jlm.init_params(jax.random.PRNGKey(1), mcfg)
    mlayer = jax.tree.map(lambda a: a[1], mparams["layers"])
    mx = np.random.default_rng(7).standard_normal(
        (MOE_T, mcfg.d_model)).astype(np.float32)
    launch_params = {
        arch: lm_params_from_jax(_np(jlm.init_params(
            jax.random.PRNGKey(0), jconfigs.get(arch).smoke_config())), "cpu")
        for arch in LAUNCH}
    # the models' weights drawn by the port (fast) and carried to JAX
    gen = torch.Generator().manual_seed(2)
    kv_cfg = jconfigs.get("llama3.2-1b").smoke_config()
    kv_pp = plm.init_params(gen, pconfigs.get("llama3.2-1b").smoke_config())
    kv_params = _to_jax(kv_pp, stacked=True)
    kv_toks = jax.random.randint(jax.random.PRNGKey(3), (4, 16), 0,
                                 kv_cfg.vocab)
    bcfg = jconfigs.get("bst").smoke_config()
    bpp = pbst.init_params(gen, pconfigs.get("bst").smoke_config())
    bparams = _to_jax(bpp)
    bbatch = jrecsys.bst_batch(bcfg, 16, 5)
    bretr = {k: v for k, v in jrecsys.retrieval_batch(bcfg, 1, 800, 6)
             .items()}
    gnn_in = {}
    for arch in GNN_ARCHS:
        pp = pgnn.init_params(gen, pconfigs.get(arch).smoke_config())
        gnn_in[arch] = (jconfigs.get(arch).smoke_config(), _to_jax(
            pp, stacked=arch == "meshgraphnet"), pp,
            pad_graph(_gnn_batch(arch), WORLD))
    torch.save({
        "dense_params": lm_params_from_jax(_np(params), "cpu"),
        "tokens": torch.from_numpy(np.asarray(toks)),
        "cache_k": torch.from_numpy(np.asarray(cache["k"])),
        "cache_v": torch.from_numpy(np.asarray(cache["v"])),
        "cache_length": int(cache["length"]),
        "next": torch.from_numpy(np.asarray(nxt)),
        "moe_layer": {k: torch.from_numpy(np.asarray(v))
                      for k, v in mlayer.items()},
        "moe_x": torch.from_numpy(mx),
        **{f"launch_params/{a}": p for a, p in launch_params.items()},
        "kv_params": kv_pp,
        "kv_tokens": torch.from_numpy(np.asarray(kv_toks)),
        "bst_params": bpp,
        "bst_batch": {k: torch.from_numpy(v) for k, v in bbatch.items()},
        "bst_retrieval": {k: torch.from_numpy(v) for k, v in bretr.items()},
        **{f"gnn_params/{a}": g[2] for a, g in gnn_in.items()},
        **{f"gnn_batch/{a}": gnn_batch_from_numpy(g[3], "cpu")
           for a, g in gnn_in.items()},
    }, out / "inputs.pt")

    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [_SRC, _HERE, os.environ.get("PYTHONPATH", "")]))
    logs = [open(out / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(_HERE, "torch_lm_ranks.py"), str(r),
         str(WORLD), str(out / "store"), str(out)], env=env, stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(WORLD)]
    try:
        ref = _references(params, toks, cache, nxt, mlayer, mx)
        ref.update(_model_references(kv_cfg, kv_params, kv_toks, bcfg,
                                     bparams, bbatch, bretr, gnn_in))
        deadline = time.monotonic() + RANKS_TIMEOUT_S
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    failed = {r: (out / f"rank{r}.log").read_text()[-3000:]
              for r, p in enumerate(procs) if p.returncode != 0}
    assert not failed, failed
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=True)
             for r in range(WORLD)]
    return ranks, ref


def _references(params, toks, cache, nxt, mlayer, mx):
    """JAX's unsharded step per (fsdp, seq_shard), its decode step, its
    local-dispatch MoE and its launcher's step loop per arch."""
    ref = {}
    batch = {"tokens": toks, "labels": toks}
    opt = joptim.adamw(LR)
    for fsdp, sp in COMBOS:
        cfg = _jax_cfg(fsdp=fsdp, seq_shard=sp)

        def step(p, b, cfg=cfg):
            (l, _), g = jax.value_and_grad(jlm.loss_fn, has_aux=True)(
                p, b, cfg)
            p, _, _ = opt.update(g, opt.init(p), p)
            return p, l

        new, loss = jax.jit(step)(params, batch)
        ref[f"step/{int(fsdp)}/{int(sp)}"] = (
            float(loss), lm_params_from_jax(_np(new), "cpu"))
    ref["decode"] = np.asarray(jax.jit(
        lambda p, c, t: jlm.decode_step(p, c, t, _jax_cfg()))(
        params, cache, nxt)[0])
    y, aux = jax.jit(lambda x, lp: jlm._moe_ffn_local(
        x, lp, _jax_moe_cfg()))(mx, mlayer)
    ref["moe"] = (np.asarray(y), float(aux))
    a = LAUNCH_ARGS
    for arch in LAUNCH:
        ref[f"launch/{arch}"] = _jax_step_loop(
            arch, a["steps"], a["batch"], a["seq"], a["lr"], seed=0)[1]
    return ref


def _model_references(kv_cfg, kv_params, kv_toks, bcfg, bparams, bbatch,
                      bretr, gnn_in):
    """JAX's unsharded AdamW step of the KV case, BST's logits, loss,
    gradients and retrieval, each GNN's output, loss and gradients."""
    opt = joptim.adamw(LR)

    def step(p, b):
        (l, _), g = jax.value_and_grad(jlm.loss_fn, has_aux=True)(
            p, b, kv_cfg)
        p, _, _ = opt.update(g, opt.init(p), p)
        return p, l, g

    new, loss, grads = jax.jit(step)(kv_params, {"tokens": kv_toks,
                                                 "labels": kv_toks})
    ref = {"kv": (float(loss), lm_params_from_jax(_np(new), "cpu"),
                  lm_params_from_jax(_np(grads), "cpu"))}
    (bl, _), bg = jax.jit(jax.value_and_grad(
        lambda p, b: jbst.loss_fn(p, b, bcfg), has_aux=True))(bparams,
                                                              bbatch)
    ref["bst"] = {
        "logits": np.asarray(jax.jit(lambda p, b: jbst.forward(p, b, bcfg))(
            bparams, {k: v for k, v in bbatch.items() if k != "labels"})),
        "loss": float(bl), "grads": bst_params_from_jax(_np(bg), "cpu"),
        "retrieval": _np(jax.jit(lambda p, b: jbst.retrieval_step(
            p, b, bcfg, top_k=100))(bparams, bretr))}
    for arch, (gcfg, jp, _, batch) in gnn_in.items():
        loss, _, grads = _gnn_jax("loss", gcfg, jp, batch)
        ref[f"gnn/{arch}"] = (_gnn_jax("apply", gcfg, jp, batch),
                              float(loss), gnn_params_from_jax(grads, "cpu"))
    return ref


def _record(ranks, name, rank=0):
    errors = {r: out["errors"][name] for r, out in enumerate(ranks)
              if name in out["errors"]}
    assert not errors, errors
    return ranks[rank][name]


def _flat(tree):
    out = {}
    tree_map_with_names(lambda n, t: out.__setitem__(n, t), tree)
    return out


@pytest.mark.parametrize("fsdp,sp", COMBOS)
def test_sharded_step_matches_jax_unsharded_step(world, fsdp, sp):
    ranks, ref = world
    name = f"step/{int(fsdp)}/{int(sp)}"
    got = _record(ranks, name)
    want_loss, want_params = ref[name]
    assert abs(got["loss"] - want_loss) < 2e-4, (got["loss"], want_loss)
    losses = {_record(ranks, name, r)["loss"] for r in range(WORLD)}
    assert len(losses) == 1, losses            # the same on every rank
    want = _flat(want_params)
    for leaf, t in _flat(got["params"]).items():
        err = float((t.float() - want[leaf].float()).abs().max())
        assert err <= 1e-5, (leaf, err)


@pytest.mark.parametrize("fsdp,sp", COMBOS)
def test_each_rank_holds_its_share_of_every_leaf(world, fsdp, sp):
    ranks, _ = world
    name = f"step/{int(fsdp)}/{int(sp)}"
    cfg = dataclasses.replace(lm_test_config(), fsdp=fsdp)
    tree = plm.param_logical_specs(cfg)
    specs = {k: tree[k] for k in ("embed", "ln_f", "unembed")}
    specs.update({f"layers/{i}/{k}": v for i, lp in enumerate(tree["layers"])
                  for k, v in lp.items()})
    mesh_sizes = dict(zip(("data", "model"), MESH))

    class Names:
        axis_names = ("data", "model")

    for r in range(WORLD):
        numel = _record(ranks, name, r)["numel"]
        assert set(numel) == set(specs)
        for leaf, (local, whole) in numel.items():
            spec = logical_to_spec(specs[leaf], Names)
            blocks = math.prod(mesh_sizes[a] for a in spec if a is not None)
            assert local * blocks == whole, (leaf, local, whole, spec)


def test_context_parallel_decode_matches_jax_decode_step(world):
    ranks, ref = world
    got = _record(ranks, "decode")
    assert got["length"] == 33
    assert got["block"] == (2, 4, 4, 5, 8)     # 40 positions over 8 ranks
    np.testing.assert_allclose(got["logits"].numpy(), ref["decode"],
                               rtol=0, atol=1e-5)
    for r in range(WORLD):
        assert torch.equal(_record(ranks, "decode", r)["logits"],
                           got["logits"])


def test_shard_map_moe_matches_jax_local_dispatch(world):
    ranks, ref = world
    got = _record(ranks, "moe")
    y, aux = ref["moe"]
    assert float(np.abs(got["y"].numpy() - y).max()) <= 1e-5
    assert abs(got["aux"] - aux) <= 1e-6


def test_checkpoint_saved_on_2x4_loads_on_4x2_bit_for_bit(world):
    ranks, _ = world
    for r in range(WORLD):
        got = _record(ranks, "ckpt", r)
        assert got["step"] == 1 and got["files"] == ["step_0000000001"]
        for saved, loaded in zip(got["saved"], got["loaded"]):
            a, b = _flat(saved), _flat(loaded)
            assert set(a) == set(b)
            for leaf in a:
                assert a[leaf].dtype == b[leaf].dtype
                assert torch.equal(a[leaf], b[leaf]), leaf


@pytest.mark.parametrize("arch", list(LAUNCH))
def test_launcher_on_eight_ranks_matches_jax_step_loop(world, arch):
    ranks, ref = world
    got = _record(ranks, f"launch/{arch}")
    want = ref[f"launch/{arch}"]
    assert got["report"]["restarts"] == int(LAUNCH[arch][1])
    assert abs(got["loss"] - want) <= 1e-4 * abs(want), (got["loss"], want)
    assert got["files"] == ["step_0000000005", "step_0000000010"]
    assert {_record(ranks, f"launch/{arch}", r)["loss"]
            for r in range(WORLD)} == {got["loss"]}


def test_launch_meshes_on_eight_ranks(world):
    ranks, _ = world
    for r in range(WORLD):
        got = _record(ranks, "meshes", r)
        assert got["flat"][:2] == ((8,), ("shards",))
        assert got["flat"][2] == (r,)
        assert got["block"][:2] == ((2, 2, 2), ("bx", "by", "bz"))
        assert got["block"][2] == tuple(int(c) for c in np.unravel_index(
            r, (2, 2, 2)))
        assert got["smoke"] == ((("data", 1), ("model", 8)), r)
        assert got["mesh"] == ({"data": r // 4, "model": r % 4}, r // 4, r)
        assert got["block_bad"] == ("layout (2, 2) needs 4 devices but "
                                    "mesh has 8")
        assert "needs 256 ranks" in got["production"]
        assert "world has 8" in got["production"]


def _scaled_err(got, want):
    """max |got - want| over max |want| (as numpy / tensors)."""
    got = torch.as_tensor(np.asarray(got, dtype=np.float32)) \
        if not isinstance(got, torch.Tensor) else got.detach().float()
    want = torch.as_tensor(np.asarray(want, dtype=np.float32)) \
        if not isinstance(want, torch.Tensor) else want.detach().float()
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(want.abs().max()) if want.numel() else 1.0
    return float((got - want).abs().max()) / (scale or 1.0)


def _leaves_within(got, want, tol):
    a, b = _flat(got), _flat(want)
    assert set(a) == set(b)
    for leaf in a:
        assert _scaled_err(a[leaf], b[leaf]) <= tol, (leaf, _scaled_err(
            a[leaf], b[leaf]))


def test_model_ranks_beyond_kv_heads_match_jax_and_one_rank(world):
    """8 "model" ranks over 4 KV heads: each rank all-gathers its layer's
    wk / wv columns and takes its query heads' KV head.  The first AdamW
    step moves a weight by about lr sign(g), so the gradients are held
    too: a wk / wv gradient summed twice over the ranks sharing a head
    has the right sign."""
    ranks, ref = world
    got = _record(ranks, "kv")
    want_loss, want, want_grads = ref["kv"]
    one_loss, one, one_grads = got["one"]
    for loss in (want_loss, one_loss):
        assert abs(got["loss"] - loss) < 2e-4, (got["loss"], loss)
    for grads in (want_grads, one_grads):
        _leaves_within(got["grads"], grads, 1e-4)
    for target in (want, one):
        w = _flat(target)
        for leaf, t in _flat(got["params"]).items():
            err = float((t.float() - w[leaf].float()).abs().max())
            assert err <= 1e-5, (leaf, err)
    assert {_record(ranks, "kv", r)["loss"] for r in range(WORLD)} == {
        got["loss"]}


def test_sharded_bst_matches_jax_and_one_rank(world):
    ranks, ref = world
    got, want = _record(ranks, "bst"), ref["bst"]
    for target in (want, got["one"]):
        assert _scaled_err(got["logits"], target["logits"]) <= 1e-5
        assert abs(got["loss"] - target["loss"]) <= 1e-5 * abs(
            target["loss"])
        _leaves_within(got["grads"], target["grads"], 1e-4)
        vals, ids = target["retrieval"]
        assert np.array_equal(got["retrieval"][1].numpy(), np.asarray(ids))
        assert _scaled_err(got["retrieval"][0], vals) <= 1e-5
    for r in range(WORLD):
        other = _record(ranks, "bst", r)
        assert torch.equal(other["logits"], got["logits"])
        assert torch.equal(other["retrieval"][1], got["retrieval"][1])


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_sharded_gnn_matches_jax_and_one_rank(world, arch):
    ranks, ref = world
    got = _record(ranks, f"gnn/{arch}")
    out, loss, grads = ref[f"gnn/{arch}"]
    for t_out, t_loss, t_grads in ((out, loss, grads), (
            got["one"]["out"], got["one"]["loss"], got["one"]["grads"])):
        assert _scaled_err(got["out"], t_out) <= 1e-5
        assert abs(got["loss"] - t_loss) <= 1e-5 * max(abs(t_loss), 1.0)
        _leaves_within(got["grads"], t_grads, 1e-4)
    assert got["aux"] == got["one"]["aux"]
    assert {_record(ranks, f"gnn/{arch}", r)["loss"]
            for r in range(WORLD)} == {got["loss"]}


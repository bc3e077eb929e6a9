"""`repro_torch.runtime.meshctx` and `repro_torch.launch.mesh` against JAX's
`repro.runtime.meshctx` and `repro.launch.mesh`, in one process (no
process group: meshes of one rank; the 8-rank layouts are held in
`tests/test_torch_distributed_lm.py`).

JAX's `logical_to_spec` reads only `mesh.axis_names`, so a stand-in object
with that attribute serves for the 2-D and the multi-pod axis sets.  On a
one-rank mesh every collective is the identity, so the LM's sharded paths
(`models.lm`'s `_sh_*`, bound by `use_mesh`) run with whole tensors and
must give the unsharded results: loss and every gradient within 1e-6,
prefill and decode logits within 1e-5.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.launch import cells as jcells
from repro.launch import mesh as jmesh
from repro.models import lm as jlm
from repro.runtime import meshctx as jctx
import repro_torch.configs as pconfigs
from repro_torch.launch import mesh as pmesh
from repro_torch.models import lm as plm
from repro_torch.runtime import meshctx as pctx
from repro_torch.tree import tree_leaves, tree_map

ARCHS = ["llama3.2-1b", "deepseek-moe-16b", "kimi-k2-1t-a32b",
         "stablelm-12b", "minitron-8b"]


class _Axes:
    def __init__(self, *names):
        self.axis_names = names


AXIS_SETS = [("data", "model"), ("pod", "data", "model"), ("model",),
             ("shards",)]


def test_logical_axes_are_jax():
    assert pctx.LOGICAL_AXES == jctx.LOGICAL_AXES


@pytest.mark.parametrize("axes", AXIS_SETS)
@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_translate_as_jax(arch, fsdp, axes):
    """Every leaf's logical spec is JAX's (the layers' without JAX's
    leading scan dim) and `logical_to_spec` gives JAX's PartitionSpec."""
    jcfg = dataclasses.replace(jconfigs.get(arch).smoke_config(), fsdp=fsdp)
    pcfg = dataclasses.replace(pconfigs.get(arch).smoke_config(), fsdp=fsdp)
    jspec = jlm.param_logical_specs(jcfg)
    pspec = plm.param_logical_specs(pcfg)
    mesh = _Axes(*axes)
    pairs = [(jspec[k], pspec[k]) for k in ("embed", "ln_f", "unembed")]
    assert len(pspec["layers"]) == pcfg.n_layers
    for layer in pspec["layers"]:
        assert set(layer) == set(jspec["layers"])
        for k, spec in layer.items():
            assert jspec["layers"][k][0] is None
            pairs.append((jspec["layers"][k][1:], spec))
    for j, p in pairs:
        assert tuple(j) == tuple(p)
        assert pctx.logical_to_spec(p, mesh) == tuple(
            jctx.logical_to_spec(j, mesh))


@pytest.mark.parametrize("axes", AXIS_SETS)
@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
def test_cache_specs_are_jax_cells(axes, shape):
    cfg = jconfigs.get("llama3.2-1b").smoke_config()
    want = jcells._cache_logical(cfg, shape)
    got = plm.LONG_CACHE_LOGICAL if shape == "long_500k" \
        else plm.CACHE_LOGICAL
    assert got == want
    assert pctx.logical_to_spec(got, _Axes(*axes)) == tuple(
        jctx.logical_to_spec(want, _Axes(*axes)))


def test_constrain_without_a_mesh_is_a_no_op():
    x = torch.arange(12.0).reshape(3, 4)
    assert pctx.get_current_mesh() is None
    assert pctx.constrain(x, "dp", "tp") is x
    assert pctx.constrain(x) is x


def test_use_mesh_binds_and_restores():
    mesh = pmesh.make_smoke_mesh(device="cpu")
    with pctx.use_mesh(mesh) as m:
        assert m is mesh and pctx.get_current_mesh() is mesh
        with pctx.use_mesh(None):
            assert pctx.get_current_mesh() is None
        assert pctx.get_current_mesh() is mesh
    assert pctx.get_current_mesh() is None


def test_smoke_mesh_of_one_rank():
    mesh = pmesh.make_smoke_mesh(device="cpu")
    assert mesh.axis_names == ("data", "model")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.size == 1
    assert mesh.coords == {"data": 0, "model": 0}
    assert mesh.ranks.tolist() == [[0]]
    x = torch.arange(6.0).reshape(2, 3)
    assert pctx.constrain(x, "dp", "tp") is x      # bound below
    with pctx.use_mesh(mesh):
        assert torch.equal(pctx.constrain(x, "dp", "tp"), x)
    for fn in (mesh.all_gather, mesh.reduce_scatter, mesh.split):
        assert fn(x, "model", 1) is x
    assert mesh.all_reduce(x, "model") is x and mesh.copy_to(x, "data") is x


def test_mesh_raises_for_another_world_size():
    with pytest.raises(ValueError, match="needs 256 ranks; the world has 1"):
        pmesh.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="needs 512 ranks; the world has 1"):
        pmesh.make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(ValueError, match="needs 2 ranks"):
        pmesh.make_smoke_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="differ in length"):
        pctx.Mesh((1,), ("data", "model"), "cpu")


def test_block_mesh_message_is_jax():
    jm = jax.make_mesh((1, 1), ("data", "model"))
    with pytest.raises(ValueError) as want:
        jmesh.make_block_mesh((2, 2), jm)
    with pytest.raises(ValueError) as got:
        pmesh.make_block_mesh((2, 2), pmesh.make_smoke_mesh(device="cpu"))
    assert str(got.value) == str(want.value)


class _TP:
    """A stand-in mesh of `model` x `data` ranks for `check_mesh`."""

    def __init__(self, model, data=1):
        self.sizes = {"model": model, "data": data}

    def axis_size(self, axes):
        return self.sizes[axes]


def test_check_mesh_names_what_does_not_split():
    cfg = pconfigs.get("llama3.2-1b").smoke_config()      # 16/4 heads
    plm.check_mesh(cfg, _TP(4, 2))
    # fewer KV heads than "model" ranks: each rank takes the one it uses
    plm.check_mesh(cfg, _TP(8))
    six = dataclasses.replace(cfg, n_heads=24, n_kv_heads=6)
    with pytest.raises(ValueError, match="n_kv_heads = 6"):
        plm.check_mesh(six, _TP(8))
    with pytest.raises(ValueError, match="d_model = 64"):
        plm.check_mesh(cfg, _TP(1, 3))
    plm.check_mesh(dataclasses.replace(cfg, fsdp=False), _TP(1, 3))
    moe = pconfigs.get("deepseek-moe-16b").smoke_config()  # 16 experts
    with pytest.raises(ValueError, match="n_experts = 16"):
        plm.check_mesh(moe, _TP(32))


def _one_rank(arch, sp):
    cfg = pconfigs.get(arch).smoke_config()
    cfg = dataclasses.replace(cfg, seq_shard=sp)
    gen = torch.Generator().manual_seed(3)
    params = plm.init_params(gen, cfg)
    toks = torch.randint(0, cfg.vocab, (2, 8), generator=gen)
    return cfg, params, toks, pmesh.make_smoke_mesh(device="cpu")


@pytest.mark.parametrize("sp", [True, False])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-moe-16b"])
def test_sharded_loss_on_one_rank_equals_unsharded(arch, sp):
    cfg, params, toks, mesh = _one_rank(arch, sp)
    batch = {"tokens": toks, "labels": toks.roll(1, 1)}

    def grads(bound):
        leaves = tree_map(lambda t: t.detach().clone().requires_grad_(),
                          params)
        with pctx.use_mesh(bound):
            loss, aux = plm.loss_fn(leaves, batch, cfg)
        loss.backward()
        return loss, aux, [t.grad for t in tree_leaves(leaves)]

    want, waux, wg = grads(None)
    got, gaux, gg = grads(mesh)
    assert abs(float(got) - float(want)) <= 1e-6
    assert abs(float(gaux["aux"]) - float(waux["aux"])) <= 1e-6
    for a, b in zip(gg, wg):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-moe-16b"])
def test_sharded_prefill_and_decode_on_one_rank_equal_unsharded(arch):
    cfg, params, toks, mesh = _one_rank(arch, True)
    with torch.no_grad():
        want, wcache = plm.prefill(params, toks, cfg, max_len=12)
        with pctx.use_mesh(mesh):
            got, cache = plm.prefill(params, toks, cfg, max_len=12)
        assert cache["logical"] == plm.CACHE_LOGICAL
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
        nxt = want.argmax(-1)[:, None]
        for _ in range(3):
            want, wcache = plm.decode_step(params, wcache, nxt, cfg)
            with pctx.use_mesh(mesh):
                got, cache = plm.decode_step(params, cache, nxt, cfg)
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
            nxt = want.argmax(-1)[:, None]
        assert cache["length"] == wcache["length"] == 11
        torch.testing.assert_close(cache["k"], wcache["k"], rtol=0,
                                   atol=1e-6)

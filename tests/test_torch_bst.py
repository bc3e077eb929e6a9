"""The port's BST (`repro_torch.models.bst`, `repro_torch.data.recsys`,
`repro_torch.configs.bst`) against the JAX package, on the CPU.

The JAX model's weights (`repro.models.bst.init_params`) cross by
`interop.bst_params_from_jax`; the batches are `data/recsys.py`'s numpy
arrays, equal in both packages for a seed.  On the CPU the multi-hot bags
run the `segment_bag` kernel's plain version.  Tolerances: logits and the
towers within rtol 1e-5 / atol 1e-6 (fp32; the bags and the pool sum in
other orders than XLA's, ~4e-7 seen on logits up to ~0.6); retrieval ids
exactly JAX's, in `lax.top_k`'s order (equal scores lowest index first),
scores within 1e-6.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs.bst as jconf
from repro.data import recsys as jrecsys
from repro.models import bst as jbst
import repro_torch.configs as pconfigs
from repro_torch.data import recsys
from repro_torch.interop import bst_params_from_jax
from repro_torch.kernels import segment_bag as bag_mod
from repro_torch.models import bst as pbst

TOL = dict(rtol=1e-5, atol=1e-6)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(tol or TOL))


class Model:
    def __init__(self):
        self.jcfg = jconf.smoke_config()
        self.pcfg = pconfigs.get("bst").smoke_config()
        self.jp = jbst.init_params(jax.random.PRNGKey(1), self.jcfg)
        self.pp = bst_params_from_jax(jax.tree.map(np.asarray, self.jp), "cpu")
        cfg = self.jcfg
        self.forward = jax.jit(lambda p, b: jbst.forward(p, b, cfg))
        self.tower = jax.jit(lambda p, b: jbst.user_tower(p, b, cfg))
        self.retrieve = jax.jit(lambda p, b: jbst.retrieval_step(p, b, cfg))


@pytest.fixture(scope="module")
def model():
    return Model()


def _jbatch(b):
    return {k: v for k, v in b.items() if k != "labels"}


def test_config_and_batches_are_jax_copies():
    jc, pc = jconf.smoke_config(), pconfigs.get("bst").smoke_config()
    for make in ("full_config", "smoke_config"):
        jf = dataclasses.asdict(getattr(jconf, make)())
        pf = dataclasses.asdict(getattr(pconfigs.get("bst"), make)())
        assert str(pf.pop("param_dtype")) == "torch.float32"
        assert jnp.dtype(jf.pop("param_dtype")).name == "float32"
        assert pf == jf
    assert pconfigs.get("bst").SHAPES == jconf.SHAPES
    for seed in (0, 3):
        for want, got in ((jrecsys.bst_batch(jc, 64, seed),
                           recsys.bst_batch(pc, 64, seed)),
                          (jrecsys.retrieval_batch(jc, 2, 300, seed),
                           recsys.retrieval_batch(pc, 2, 300, seed))):
            assert want.keys() == got.keys()
            for k in want:
                assert want[k].dtype == got[k].dtype
                assert np.array_equal(want[k], got[k]), k


@pytest.mark.parametrize("shape", ["serve_p99", "serve_bulk"])
def test_forward_vs_jax(model, shape):
    n = jconf.SMOKE_SHAPES[shape]["batch"]
    b = recsys.bst_batch(model.pcfg, n, seed=0)
    logits = pbst.forward(model.pp, recsys.to_tensors(b, "cpu"), model.pcfg)
    assert logits.shape == (n,) and logits.dtype == torch.float32
    _close(logits, model.forward(model.jp, _jbatch(b)))


def test_user_tower_and_bags_vs_jax(model):
    b = recsys.bst_batch(model.pcfg, 32, seed=4)
    got = pbst.user_tower(model.pp, recsys.to_tensors(b, "cpu"), model.pcfg)
    for g, w in zip(got, model.tower(model.jp, _jbatch(b))):
        _close(g, w)
    table = model.jp["multihot_embed"]
    ids = np.random.default_rng(5).integers(-1, table.shape[0],
                                            (20, 6)).astype(np.int32)
    ids[3] = -1                                     # an empty bag
    for mode in ("sum", "mean"):
        _close(pbst.embedding_bag(model.pp["multihot_embed"],
                                  torch.from_numpy(ids), mode=mode),
               jbst.embedding_bag(table, ids, mode=mode))
    with pytest.raises(ValueError, match="mode"):
        pbst.embedding_bag(model.pp["multihot_embed"], torch.from_numpy(ids),
                           mode="max")


def test_retrieval_step_vs_jax(model):
    """retrieval_cand at the smoke shape: 2048 candidates drawn from 1024
    items, so equal scores abound (duplicates) and the order of ties
    decides the ids."""
    shape = jconf.SMOKE_SHAPES["retrieval_cand"]
    b = recsys.retrieval_batch(model.pcfg, shape["batch"],
                               shape["n_candidates"], seed=0)
    vals, ids = pbst.retrieval_step(model.pp, recsys.to_tensors(b, "cpu"),
                                    model.pcfg)
    jvals, jids = model.retrieve(model.jp, _jbatch(b))
    assert ids.dtype == torch.int32 and ids.shape == (1, 100)
    assert np.array_equal(ids.numpy(), np.asarray(jids))
    _close(vals, jvals)
    assert len(np.unique(b["candidates"][0])) < shape["n_candidates"]


def test_retrieval_ties_keep_lax_top_k_order(model):
    """Every candidate row equal: all scores tie, and `lax.top_k` returns
    the lowest indices first (torch.topk orders ties otherwise)."""
    pp = dict(model.pp, item_embed=model.pp["item_embed"].clone())
    jp = dict(model.jp)
    row = pp["item_embed"][7].clone()
    pp["item_embed"][100:] = row
    jp["item_embed"] = jnp.asarray(pp["item_embed"].numpy())
    b = recsys.retrieval_batch(model.pcfg, 2, 500, seed=1)
    b["candidates"] = np.random.default_rng(2).integers(
        100, model.pcfg.item_vocab, (2, 500)).astype(np.int32)
    vals, ids = pbst.retrieval_step(pp, recsys.to_tensors(b, "cpu"),
                                    model.pcfg, top_k=10)
    jvals, jids = model.retrieve(jp, _jbatch(b))
    assert np.array_equal(ids.numpy(), np.asarray(jids)[:, :10])
    assert np.array_equal(ids.numpy(), b["candidates"][:, :10])


def test_multihot_id_past_the_table_adds_nothing_where_jax_gives_nan(model):
    """Reference fault (ROADMAP.md Queue 3): a multi-hot id of field 1 at
    or above `multihot_vocab` indexes past the concatenated table; JAX's
    `jnp.take` fills that row with NaN, so the whole logit is NaN.  The
    port's bag (kernel and plain version) skips the id: its logit equals
    JAX's with the id replaced by a -1 pad."""
    b = recsys.bst_batch(model.pcfg, 8, seed=6)
    b["multihot_ids"][2, 1, 0] = model.pcfg.multihot_vocab + 5
    jlog = np.asarray(model.forward(model.jp, _jbatch(b)))
    assert np.isnan(jlog[2]) and not np.isnan(np.delete(jlog, 2)).any()
    got = pbst.forward(model.pp, recsys.to_tensors(b, "cpu"), model.pcfg)
    b["multihot_ids"][2, 1, 0] = -1
    _close(got, model.forward(model.jp, _jbatch(b)))


def test_impl_plain_and_dispatch(model):
    b = recsys.to_tensors(recsys.bst_batch(model.pcfg, 16, seed=7), "cpu")
    before = dict(bag_mod.launches)
    auto = pbst.forward(model.pp, b, model.pcfg)
    assert torch.equal(auto, pbst.forward(model.pp, b, model.pcfg,
                                          impl="plain"))
    assert bag_mod.launches == before          # the CPU launches nothing
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        pbst.forward(model.pp, b, model.pcfg, impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        pbst.forward(model.pp, b, model.pcfg, impl="nope")
    if not torch.cuda.is_available():          # "cuda" is the default
        with pytest.raises(RuntimeError, match="CUDA"):
            recsys.to_tensors(recsys.bst_batch(model.pcfg, 2))

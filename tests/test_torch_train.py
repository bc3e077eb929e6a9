"""Training on the port (`lm.loss_fn`, `bst.loss_fn`, the kernels'
gradients in `kernels.ops`, `repro_torch.optim`, `data.tokens`,
`checkpoint`, `runtime.driver`, `launch.train`) against the JAX package,
on the CPU.

On the CPU `ops.flash_attention` and `ops.embedding_bag` run the kernels'
plain versions inside the same `autograd.Function`s as on the card, so the
hand-written backwards (`ops.attention_backward`, `ops.bag_backward`) are
what these tests differentiate.  Tolerances: losses and every gradient leaf
within rtol 1e-4 / atol 1e-6 (fp32; the chunked attention backward and
XLA's sum in other orders); the attention backward within 2e-6 of
`jax.grad` of `mha_ref` and of autograd through the plain version; one
optimizer step within 1e-6; schedules within 1 ulp; the codecs exact and
the error-feedback residual within 1e-7; token batches, checkpoints and
the driver's restart bit for bit.  The launcher is held to a JAX step loop
built from the same pieces, since JAX's own launcher raises under jax
0.9.0 (ROADMAP.md Queue 3): eval loss within 1e-4.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as jconfigs
import repro.configs.bst as jbst_conf
from repro.data.tokens import TokenStream as JTokenStream
from repro.kernels import ref as jref
from repro.models import bst as jbst, lm as jlm
from repro import optim as joptim
import repro_torch.configs as pconfigs
from repro_torch import optim
from repro_torch.checkpoint import CheckpointManager, load_pytree, save_pytree
from repro_torch.data import recsys
from repro_torch.data.tokens import TokenStream
from repro_torch.interop import bst_params_from_jax, lm_params_from_jax
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as ptrain
from repro_torch.models import bst as pbst, lm as plm
from repro_torch.runtime.driver import InjectedFailure, TrainDriver
from repro_torch.tree import tree_leaves, tree_map

TOL = dict(rtol=1e-4, atol=1e-6)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or TOL))


def _requires_grad(tree):
    return tree_map(lambda t: t.detach().clone().requires_grad_(), tree)


# --- the LM and BST losses and their gradients --------------------------------


@pytest.mark.parametrize("arch", ["llama3_2_1b", "deepseek_moe_16b"])
def test_lm_loss_and_grads_vs_jax(arch):
    """`lm.loss_fn` (remat on, JAX's default) and every gradient leaf
    against `jax.value_and_grad`; the same, bit for bit, with remat off and
    with the attention and the loss checkpointed too (remat_attn,
    remat_loss)."""
    jcfg = jconfigs.get(arch).smoke_config()
    pcfg = pconfigs.get(arch).smoke_config()
    assert pcfg.remat
    jp = jlm.init_params(jax.random.PRNGKey(2), jcfg)
    tok = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 17)).astype(
        np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:].copy()}
    batch["labels"][0, 3] = -1                      # a padded label
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, b, jcfg), has_aux=True))(jp, batch)
    grads = []
    for knobs in ({}, {"remat": False},
                  {"remat_attn": True, "remat_loss": True}):
        pp = _requires_grad(lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                               "cpu"))
        loss, metrics = plm.loss_fn(
            pp, {k: torch.from_numpy(v) for k, v in batch.items()},
            dataclasses.replace(pcfg, **knobs))
        loss.backward()
        grads.append(tree_map(lambda t: t.grad, pp))
        _close(loss, jl)
        _close(metrics["ce"], jm["ce"])
        assert abs(float(metrics["aux"].detach()) - float(jm["aux"])) <= 1e-6
    for other in grads[1:]:
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(grads[0]),
                                                     tree_leaves(other)))
    g = grads[0]
    for k in ("embed", "unembed", "ln_f"):
        _close(g[k], jg[k])
    for i, lp in enumerate(g["layers"]):
        assert set(lp) == set(jg["layers"])
        for k, v in lp.items():
            _close(v, jg["layers"][k][i])
            assert float(v.abs().max()) > 0, (i, k)


def test_bst_loss_and_grads_vs_jax():
    """`bst.loss_fn` (the logistic loss, the acc metric) and every gradient
    leaf, the multi-hot table's through `bag_backward`."""
    jcfg = jbst_conf.smoke_config()
    pcfg = pconfigs.get("bst").smoke_config()
    jp = jbst.init_params(jax.random.PRNGKey(1), jcfg)
    b = recsys.bst_batch(pcfg, 64, seed=2)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jbst.loss_fn(p, b, jcfg), has_aux=True))(jp)
    pp = _requires_grad(bst_params_from_jax(jax.tree.map(np.asarray, jp),
                                            "cpu"))
    loss, metrics = pbst.loss_fn(pp, recsys.to_tensors(b, "cpu"), pcfg)
    loss.backward()
    _close(loss, jl)
    assert float(metrics["acc"]) == float(jm["acc"])
    for got, want in zip(tree_leaves(tree_map(lambda t: t.grad, pp)),
                         jax.tree.leaves(jg)):
        _close(got, want)
    assert float(pp["multihot_embed"].grad.abs().max()) > 0


# --- the kernels' gradients ----------------------------------------------------


@pytest.mark.parametrize("b,h,hkv,sq,sk,d,causal,block_k", [
    (2, 4, 2, 33, 33, 8, True, 7),
    (1, 6, 3, 9, 50, 16, True, None),
    (2, 2, 2, 20, 31, 4, False, 8),
    (1, 4, 1, 40, 17, 8, True, 5),       # Sq > Sk: 23 rows see no key
])
def test_attention_backward(b, h, hkv, sq, sk, d, causal, block_k):
    """dq, dk, dv of the kernel's attention against autograd through its
    plain version (every case) and `jax.grad` of `mha_ref` (where every
    row sees a key); GQA heads summed into their kv head."""
    rng = np.random.default_rng(sq)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, hkv, sk, d)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    got = ops.attention_backward(*map(torch.from_numpy, (q, k, v, do)),
                                 causal, block_k)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    ref.flash_attention_kernel_ref(*leaves, causal=causal).backward(
        torch.from_numpy(do))
    for g, t in zip(got, leaves):
        _close(g, t.grad, rtol=2e-6, atol=2e-6)
    if sq <= sk:
        jg = jax.grad(lambda *a: jnp.sum(jref.mha_ref(*a, causal=causal)
                                         * do), argnums=(0, 1, 2))(q, k, v)
        for g, w in zip(got, jg):
            _close(g, w, rtol=2e-6, atol=2e-6)
    # the Function behind ops.flash_attention runs the same backward, at
    # its default chunk
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=causal, check_tiles=False)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    out.backward(torch.from_numpy(do))
    default = ops.attention_backward(*map(torch.from_numpy, (q, k, v, do)),
                                     causal)
    for g, t in zip(default, leaves):
        assert torch.equal(g, t.grad)


def test_attention_backward_bf16_and_chunking():
    """bf16 inputs give bf16 gradients (computed in fp32); the chunk size
    changes nothing beyond fp32 rounding."""
    rng = np.random.default_rng(3)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   for s in ((1, 4, 64, 8), (1, 2, 64, 8), (1, 2, 64, 8),
                             (1, 4, 64, 8)))
    whole = ops.attention_backward(q, k, v, do, True, 64)
    for block_k in (1, 9, 32):
        for a, w in zip(ops.attention_backward(q, k, v, do, True, block_k),
                        whole):
            _close(a, w, rtol=1e-5, atol=1e-6)
    half = ops.attention_backward(*(t.bfloat16() for t in (q, k, v, do)),
                                  True)
    assert all(g.dtype == torch.bfloat16 for g in half)
    leaves = [t.bfloat16().requires_grad_() for t in (q, k, v)]
    ref.flash_attention_kernel_ref(*leaves, causal=True).backward(
        do.bfloat16())
    for g, t in zip(half, leaves):
        tol = 1e-2 * float(t.grad.float().abs().max())
        _close(g, t.grad, rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bag_backward(dtype):
    """The table's gradient: each bag's gradient added to its ids' rows in
    fp32, cast once; -1 pads and ids >= V add nothing (the forward's rule).
    fp32: equal to autograd through the plain version and to `jax.grad` of
    JAX's oracle on the valid ids within 1e-6.  bf16: within one bf16 ulp
    (rtol 2^-8) of the fp32 gradient of the same bf16 values (autograd
    through the plain version adds in bf16, rounding at every add)."""
    rng = np.random.default_rng(0)
    table = rng.standard_normal((50, 6)).astype(np.float32)
    ids = rng.integers(-1, 50, (12, 5)).astype(np.int32)
    ids[0, 0], ids[4, 2], ids[7] = 50, 73, -1        # past V; an empty bag
    dout = torch.from_numpy(rng.standard_normal((12, 6)).astype(np.float32))
    dout = dout.to(dtype).float()                     # exact in both dtypes
    t = torch.from_numpy(table).to(dtype).requires_grad_()
    out = ops.embedding_bag(t, torch.from_numpy(ids))
    assert type(out.grad_fn).__name__ == "_SegmentBagBackward"
    out.backward(dout.to(dtype))
    assert t.grad.dtype == dtype
    plain = torch.from_numpy(table).requires_grad_()
    ref.segment_bag_ref(plain, torch.from_numpy(ids)).backward(dout)
    if dtype == torch.float32:
        _close(t.grad, plain.grad, rtol=1e-6, atol=1e-6)
        valid = np.where(ids < 50, ids, -1)
        jg = jax.grad(lambda tb: jnp.sum(jbst.embedding_bag(tb, valid)
                                         * dout.numpy()))(table)
        _close(t.grad, jg, rtol=1e-6, atol=1e-6)
    else:
        _close(t.grad, plain.grad, rtol=2 ** -8, atol=0)
    unused = [i for i in range(50) if i not in ids]
    assert float(t.grad[unused].float().abs().sum()) == 0


def test_plain_and_ref_impls_differentiate_their_ops():
    """impl="plain" and "ref" stay autograd through their own ops."""
    q = torch.randn(1, 2, 5, 4, requires_grad=True)
    for impl in ("plain", "ref"):
        out = ops.flash_attention(q, q[:, :1], q[:, :1], causal=True,
                                  impl=impl, check_tiles=False)
        assert "FlashAttention" not in type(out.grad_fn).__name__
    table = torch.randn(7, 3, requires_grad=True)
    ids = torch.tensor([[0, 6, -1]])
    for impl in ("plain", "ref"):
        out = ops.embedding_bag(table, ids, impl=impl)
        assert "SegmentBag" not in type(out.grad_fn).__name__


# --- optim -------------------------------------------------------------------


def _param_trees(seed):
    rng = np.random.default_rng(seed)
    shapes = {"a": (5, 3), "layers": [{"w": (4,), "z": (2, 2)},
                                      {"w": (4,), "z": (2, 2)}]}
    return jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32),
                        shapes, is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("which", ["adamw", "adamw_noclip", "sgd"])
def test_optimizer_steps_vs_jax(which):
    """Three steps from the same gradients within 1e-6, metrics included;
    the state mirrors the tree and nothing is changed in place."""
    params = _param_trees(0)
    sched = (joptim.warmup_cosine(0.05, 2, 10),
             optim.warmup_cosine(0.05, 2, 10))
    if which == "sgd":
        jopt, popt = joptim.sgd(sched[0], grad_clip=0.5), optim.sgd(
            sched[1], grad_clip=0.5)
    else:
        clip = 0.0 if which == "adamw_noclip" else 1.0
        jopt = joptim.adamw(sched[0], weight_decay=0.1, grad_clip=clip)
        popt = optim.adamw(sched[1], weight_decay=0.1, grad_clip=clip)
    jp, js = params, jopt.init(params)
    pp = tree_map(torch.from_numpy, params)
    ps = popt.init(pp)
    before = [t.clone() for t in tree_leaves((pp, ps))]
    for step in range(3):
        g = _param_trees(10 + step)
        jp, js, jm = jopt.update(g, js, jp)
        new_pp, new_ps, pm = popt.update(tree_map(torch.from_numpy, g), ps,
                                         pp)
        if step == 0:
            assert all(torch.equal(a, b) for a, b in zip(
                before, tree_leaves((pp, ps))))
        pp, ps = new_pp, new_ps
        for got, want in zip(tree_leaves((pp, ps)), jax.tree.leaves((jp, js))):
            _close(got, want, rtol=1e-6, atol=1e-6)
        for k in ("grad_norm", "lr"):
            _close(pm[k], jm[k], rtol=1e-6, atol=1e-6)
    assert ps["step"].dtype == torch.int32 and int(ps["step"]) == 3


def test_apply_updates_and_clip_keep_dtypes():
    p = {"w": torch.tensor([1.0, 2.0], dtype=torch.bfloat16)}
    u = {"w": torch.tensor([2.0 ** -9, 0.25])}
    out = optim.apply_updates(p, u)["w"]
    want = joptim.apply_updates({"w": jnp.asarray([1.0, 2.0], jnp.bfloat16)},
                                {"w": jnp.asarray([2.0 ** -9, 0.25])})["w"]
    assert out.dtype == torch.bfloat16
    _close(out, want, rtol=0, atol=0)
    g = {"a": torch.tensor([3.0, 4.0])}
    clipped, norm = optim.clip_by_global_norm(g, 1.0)
    jc, jn = joptim.clip_by_global_norm({"a": jnp.asarray([3.0, 4.0])}, 1.0)
    _close(clipped["a"], jc["a"], rtol=1e-7, atol=0)
    assert float(norm) == float(jn) == 5.0


def test_schedules_within_one_ulp():
    """Warmup steps bit for bit; the cosine part within one ulp of the
    peak lr: torch's and XLA's fp32 cos differ by an ulp at some steps
    (e.g. step 82 of (3e-3, 20, 100)), which 1 + cos near -1 turns into 2
    ulps of the (small) value there, never more than an ulp of the peak."""
    steps = np.arange(0, 120, dtype=np.int32)
    for peak, warmup, total in ((3e-3, 20, 100), (1.0, 0, 50), (0.5, 10, 10)):
        got = optim.warmup_cosine(peak, warmup, total)(
            torch.from_numpy(steps)).numpy()
        want = np.asarray(joptim.warmup_cosine(peak, warmup, total)(
            jnp.asarray(steps)))
        assert np.array_equal(got[:warmup], want[:warmup])
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=np.spacing(np.float32(peak)))
    got = optim.constant(0.1)(torch.tensor(3, dtype=torch.int32))
    assert float(got) == float(joptim.constant(0.1)(jnp.int32(3)))


def test_codecs_exact_and_error_feedback():
    rng = np.random.default_rng(5)
    g = rng.standard_normal((40, 25)).astype(np.float32)
    g[3, 4] = g[7, 1]                                  # tied magnitudes
    got = optim.int8_compress_decompress(torch.from_numpy(g))
    assert np.array_equal(got.numpy(), np.asarray(
        joptim.int8_compress_decompress(jnp.asarray(g))))
    for frac in (0.01, 0.1, 0.5):
        kept, mass = optim.topk_compress_decompress(torch.from_numpy(g), frac)
        jkept, jmass = joptim.topk_compress_decompress(jnp.asarray(g), frac)
        assert np.array_equal(kept.numpy(), np.asarray(jkept))
        _close(mass, jmass, rtol=1e-6, atol=0)
    grads = {"a": g, "b": [g[:5] * 3]}
    for codec in ("int8", "topk"):
        jef, pef = None, None
        for _ in range(3):
            jc, jef = joptim.compressed_gradients(grads, jef, codec, 0.05)
            pc, pef = optim.compressed_gradients(
                tree_map(torch.from_numpy, grads), pef, codec, 0.05)
            for a, b in zip(tree_leaves(pc), jax.tree.leaves(jc)):
                _close(a, b, rtol=0, atol=1e-7)
            for a, b in zip(tree_leaves(pef.residual),
                            jax.tree.leaves(jef.residual)):
                _close(a, b, rtol=0, atol=1e-7)
    with pytest.raises(ValueError):
        optim.compressed_gradients(tree_map(torch.from_numpy, grads), None,
                                   "fp4")


# --- data, checkpoints, the driver ----------------------------------------------


def test_token_stream_is_jax_copy():
    for args in ((64, 4, 16, 3, 0), (128, 2, 33, 0, 7)):
        a, b = TokenStream(*args), JTokenStream(*args)
        assert np.array_equal(a.perm, b.perm)
        for _ in range(3):
            x, y = next(a), next(b)
            for k in ("tokens", "labels"):
                assert x[k].dtype == y[k].dtype
                assert np.array_equal(x[k], y[k])
        assert a.state() == b.state() == args[4] + 3


def _state():
    gen = torch.Generator().manual_seed(0)
    return ({"embed": torch.randn(6, 4, generator=gen).bfloat16(),
             "layers": [{"w": torch.randn(3, generator=gen)}]},
            {"step": torch.tensor(7, dtype=torch.int32),
             "m": [torch.randn(2, 2, generator=gen, dtype=torch.float64)]})


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_checkpoint_round_trip_bf16_bit_for_bit(tmp_path):
    state = _state()
    save_pytree(str(tmp_path / "ck"), state, step=7, extra={"note": "x"})
    with open(tmp_path / "ck" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["dtypes"]["0/embed"] == "bfloat16"
    assert manifest["keys"] == sorted(["0/embed", "0/layers/0/w", "1/m/0",
                                       "1/step"])
    with np.load(tmp_path / "ck" / "arrays.npz") as z:
        assert z["0/embed"].dtype == np.uint16
    template = tree_map(torch.zeros_like, state)
    back = load_pytree(str(tmp_path / "ck"), template)
    for a, b in zip(tree_leaves(back), tree_leaves(state)):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
    bad = ({"embed": torch.zeros(5, 4), "layers": [{"w": torch.zeros(3)}]},
           template[1])
    with pytest.raises(ValueError, match="shape"):
        load_pytree(str(tmp_path / "ck"), bad)
    with pytest.raises(KeyError, match="missing"):
        load_pytree(str(tmp_path / "ck"), (template[0], {"other": 1}))
    # a template leaf decides the restored dtype
    f32 = load_pytree(str(tmp_path / "ck"), tree_map(
        lambda t: torch.zeros(t.shape), template))
    assert f32[0]["embed"].dtype == torch.float32
    assert torch.equal(f32[0]["embed"], state[0]["embed"].float())


def test_checkpoint_manager_staging_retention_async(tmp_path):
    """A stale .tmp stage is neither a checkpoint nor in the way; the last
    `keep_last` steps are kept; `save` copies to the host before it
    returns, so changing the state afterwards changes no file."""
    mgr = CheckpointManager(str(tmp_path), keep_last=2, async_write=True)
    os.makedirs(tmp_path / "step_0000000004.tmp")
    assert mgr.steps() == [] and mgr.restore(_state()) == (None, None)
    state = _state()
    for step in (1, 2, 3, 4):
        mgr.save(step, state, extra={"step": step})
        state[0]["layers"][0]["w"].add_(1.0)          # after the snapshot
    mgr.wait()
    assert mgr.steps() == [3, 4] and mgr.latest_step() == 4
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))
    got, manifest = mgr.restore(tree_map(torch.zeros_like, _state()))
    assert manifest["step"] == 4 and manifest["extra"] == {"step": 4}
    assert torch.equal(got[0]["layers"][0]["w"],
                       _state()[0]["layers"][0]["w"] + 3)
    got, _ = mgr.restore(tree_map(torch.zeros_like, _state()), step=3)
    assert torch.equal(got[0]["layers"][0]["w"],
                       _state()[0]["layers"][0]["w"] + 2)


def test_driver_restart_resumes_exactly(tmp_path):
    """JAX's `test_driver_restart_resumes_exactly` on the port: a failure
    at step 33 restores step 30 and ends bit-equal to a clean run; the
    initial state is never changed in place."""
    target = torch.from_numpy(np.random.default_rng(0).standard_normal(8)
                              .astype(np.float32))
    params0 = {"w": torch.zeros(8)}
    opt = optim.adamw(0.05, weight_decay=0.0)

    def step_fn(state, batch):
        params, ostate = state
        g = {"w": 2 * (params["w"] - target) + batch["noise"]}
        params, ostate, _ = opt.update(g, ostate, params)
        return (params, ostate), {"loss": torch.sum((params["w"] - target)
                                                    ** 2)}

    def make_data(start):
        def gen():
            step = start
            while True:
                rng = np.random.default_rng(step)
                yield {"noise": torch.tensor(rng.standard_normal() * 0.01,
                                             dtype=torch.float32)}
                step += 1
        return gen()

    def run(inject, subdir):
        mgr = CheckpointManager(str(tmp_path / subdir), keep_last=3,
                                async_write=False)
        fail = {"armed": inject}

        def injector(step):
            if fail["armed"] and step == 33:
                fail["armed"] = False
                return True
            return False

        drv = TrainDriver(step_fn=step_fn,
                          init_state=(params0, opt.init(params0)),
                          make_data=make_data, ckpt=mgr, ckpt_every=10,
                          failure_injector=injector, log_every=0,
                          verbose=False)
        return drv.run(50)

    clean, rep0 = run(False, "clean")
    faulty, rep1 = run(True, "faulty")
    assert rep0["restarts"] == 0 and rep1["restarts"] == 1
    for a, b in zip(tree_leaves(clean), tree_leaves(faulty)):
        assert torch.equal(a, b)
    assert float((clean[0]["w"] - target).abs().max()) < 0.1
    assert torch.equal(params0["w"], torch.zeros(8))

    def always(step):
        return True

    drv = TrainDriver(step_fn=step_fn, init_state=(params0,
                                                   opt.init(params0)),
                      make_data=make_data,
                      ckpt=CheckpointManager(str(tmp_path / "x")),
                      failure_injector=always, max_restarts=2, verbose=False)
    with pytest.raises(InjectedFailure):
        drv.run(5)


# --- the launcher ----------------------------------------------------------------


def _jax_step_loop(arch, steps, batch, seq, lr, seed):
    """What JAX's launcher runs, without its mesh: `lm.loss_fn`, AdamW with
    warmup-cosine, `TokenStream`; returns (params, the 4-batch eval
    loss)."""
    cfg = jconfigs.get(arch).smoke_config()
    if seq % cfg.loss_chunks:
        cfg = dataclasses.replace(cfg, loss_chunks=1)
    params = jlm.init_params(jax.random.PRNGKey(seed), cfg)
    opt = joptim.adamw(joptim.warmup_cosine(lr, 20, steps), weight_decay=0.01)

    @jax.jit
    def step_fn(state, b):
        p, o = state
        (loss, _), grads = jax.value_and_grad(jlm.loss_fn, has_aux=True)(
            p, b, cfg)
        p, o, _ = opt.update(grads, o, p)
        return p, o

    state = (params, opt.init(params))
    stream = JTokenStream(cfg.vocab, batch, seq, seed=seed)
    for _ in range(steps):
        state = step_fn(state, next(stream))
    stream = JTokenStream(cfg.vocab, batch, seq, seed=seed, start_step=10_000)
    loss = jax.jit(lambda p, b: jlm.loss_fn(p, b, cfg)[0])
    return params, np.mean([float(loss(state[0], next(stream)))
                            for _ in range(4)])


@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-moe-16b"])
def test_launch_train_matches_jax_step_loop(arch, tmp_path, monkeypatch):
    """`launch.train.main(--device cpu --smoke)` from JAX's initial weights
    (carried over in place of the port's own draw) ends at JAX's eval loss;
    a checkpoint every 10 steps."""
    steps, batch, seq, lr = 24, 4, 16, 3e-3
    jparams, jloss = _jax_step_loop(arch, steps, batch, seq, lr, seed=0)
    carried = lm_params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    monkeypatch.setattr(ptrain.lm, "init_params", lambda gen, cfg: carried)
    loss, report = ptrain.main([
        "--arch", arch, "--smoke", "--steps", str(steps), "--batch",
        str(batch), "--seq", str(seq), "--lr", str(lr), "--device", "cpu",
        "--ckpt-dir", str(tmp_path), "--ckpt-every", "10"])
    assert report["restarts"] == 0
    assert abs(loss - jloss) <= 1e-4 * abs(jloss), (loss, jloss)
    assert sorted(os.listdir(tmp_path)) == ["step_0000000010",
                                            "step_0000000020"]


def test_launch_train_chaos_equals_clean_run(tmp_path):
    """--chaos fails at 60% of the steps (18 of 30), restores step 10 and
    ends at the clean run's eval loss bit for bit; a non-LM arch raises."""
    argv = ["--smoke", "--steps", "30", "--batch", "4", "--seq", "16",
            "--device", "cpu", "--ckpt-every", "10"]
    clean, rep0 = ptrain.main(argv + ["--ckpt-dir", str(tmp_path / "a")])
    chaos, rep1 = ptrain.main(argv + ["--ckpt-dir", str(tmp_path / "b"),
                                      "--chaos"])
    assert rep0["restarts"] == 0 and rep1["restarts"] == 1
    assert clean == chaos
    with pytest.raises(ValueError, match="LM archs"):
        ptrain.main(["--arch", "bst", "--smoke", "--device", "cpu"])

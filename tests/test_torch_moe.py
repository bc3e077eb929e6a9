"""The port's MoE FFN (`repro_torch.models.lm`) and the MoE configs against
the JAX package, on the CPU.

JAX's weights (`repro.models.lm.init_params`) cross by
`interop.lm_params_from_jax`; the same seeded numpy tokens go through both
packages at the `deepseek_moe_16b` and `kimi_k2_1t` smoke configs (16
experts, top-2, 2 and 1 shared).  Tolerances: the dispatch tables exactly
equal (source tokens and fp32 weights, bit for bit); the MoE FFN's output
within rtol 1e-5 / atol 1e-5 (fp32; the port's combine is `index_add`,
JAX's `.at[table].add`, summing a token's experts in another order) and
its aux loss within 1e-6; prefill, decode and forward as
`tests/test_torch_lm.py` holds the dense LMs: within 1e-5, greedy tokens
equal.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as jconfigs
from repro.models import lm as jlm
import repro_torch.configs as pconfigs
from repro_torch.interop import lm_params_from_jax
from repro_torch.models import lm as plm

ARCHS = ("deepseek_moe_16b", "kimi_k2_1t")
TOL = dict(rtol=1e-5, atol=1e-5)
MAX_LEN = 24
GEN = 3


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or TOL))


def _tokens(b, s, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _dispatch(cfg, dispatch, dp_shards=1):
    moe = dataclasses.replace(cfg.moe, dispatch=dispatch, dp_shards=dp_shards)
    return dataclasses.replace(cfg, moe=moe)


class Arch:
    """One MoE config in both packages, JAX's functions jitted."""

    def __init__(self, name):
        self.jcfg = jconfigs.get(name).smoke_config()
        self.pcfg = pconfigs.get(name).smoke_config()
        self.jp = jlm.init_params(jax.random.PRNGKey(0), self.jcfg)
        self.pp = lm_params_from_jax(jax.tree.map(np.asarray, self.jp), "cpu")
        cfg = self.jcfg
        self.prefill = jax.jit(lambda p, t: jlm.prefill(p, t, cfg,
                                                        max_len=MAX_LEN))
        self.decode = jax.jit(lambda p, c, t: jlm.decode_step(p, c, t, cfg))
        self.forward = jax.jit(lambda p, t: jlm.forward(p, t, cfg))

    def layer(self, i):
        """(JAX's layer-i params, the port's)."""
        return (jax.tree.map(lambda a: a[i], self.jp["layers"]),
                self.pp["layers"][i])


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    return Arch(request.param)


# --- the dispatch ----------------------------------------------------------


@pytest.mark.parametrize("T,E,k,C,seed", [
    (16, 4, 2, 3, 0),        # 32 slots into 12: most experts overflow
    (10, 8, 3, 4, 1),
    (7, 16, 2, 1, 2),        # decode-like: one slot an expert
    (24, 4, 1, 12, 3),       # room for every slot
])
def test_dispatch_tables_exactly_jax(T, E, k, C, seed):
    """Tables of source tokens (T = padding) and weights equal JAX's bit
    for bit, overflowed slots dropped; the skewed draw sends most slots to
    two experts."""
    rng = np.random.default_rng(seed)
    topi = np.stack([rng.choice(E, k, replace=False,
                                p=np.r_[0.4, 0.3, [0.3 / (E - 2)] * (E - 2)])
                     for _ in range(T)]).astype(np.int32)
    topv = rng.random((T, k)).astype(np.float32)
    jt, jw = jlm._dispatch_tables(jnp.asarray(topi), jnp.asarray(topv), T, E,
                                  C)
    pt, pw, slots = plm._dispatch_tables(torch.from_numpy(topi),
                                         torch.from_numpy(topv), T, E, C)
    assert pt.dtype == torch.int32 and pw.dtype == torch.float32
    assert np.array_equal(pt.numpy(), np.asarray(jt))
    assert np.array_equal(pw.numpy().view(np.uint32),
                          np.asarray(jw).view(np.uint32))
    kept = int((pt < T).sum())
    assert kept == min(T * k, sum(min(int((topi == e).sum()), C)
                                  for e in range(E)))
    # the port's third table: each kept (token, choice) points at its slot
    slots = slots.numpy()
    assert slots.shape == (T, k) and int((slots < E * C).sum()) == kept
    tok, choice = np.nonzero(slots < E * C)
    assert np.array_equal(pt.numpy()[slots[tok, choice]], tok)
    assert np.array_equal(slots[tok, choice] // C, topi[tok, choice])


def test_capacity_is_jax_expression():
    for T, k, E, cf in ((16384, 6, 64, 1.25), (4, 6, 64, 1.25),
                        (2048, 8, 384, 1.25), (7, 2, 16, 1.0), (1, 8, 384,
                                                                1.25)):
        mcfg = plm.MoEConfig(E, k, capacity_factor=cf)
        assert plm.capacity(T, mcfg) == max(int(math.ceil(T * k / E * cf)), 1)
    deepseek = pconfigs.get("deepseek-moe-16b").full_config().moe
    assert plm.capacity(4, deepseek) == 1          # decode at B = 4 drops
    assert plm.capacity(4 * 4096, deepseek) == 1920


def test_top_k_ties_keep_lax_order(arch):
    """Exactly equal router probabilities pick the lower expert first, as
    `lax.top_k` does (`torch.topk` need not): experts 2 and 5 share a
    router column u and the rest are 0, so rows with u.x > 0 tie at the
    top (2 before 5) and rows with u.x < 0 tie among the rest (0, 1)."""
    d, e = arch.jcfg.d_model, arch.jcfg.moe.n_experts
    rng = np.random.default_rng(4)
    router = np.zeros((d, e), np.float32)
    router[:, 2] = router[:, 5] = rng.standard_normal(d)
    x = rng.standard_normal((12, d)).astype(np.float32)
    probs, topi, topv = plm._route(torch.from_numpy(x),
                                   {"router": torch.from_numpy(router)},
                                   arch.pcfg)
    jprobs = jax.nn.softmax(jnp.asarray(x) @ router, axis=-1)
    jv, ji = jax.lax.top_k(jprobs, arch.jcfg.moe.top_k)
    assert np.array_equal(topi.numpy(), np.asarray(ji))
    up = (x @ router[:, 2]) > 0
    assert up.any() and (~up).any()
    assert (topi.numpy()[up] == [2, 5]).all()
    assert (topi.numpy()[~up] == [0, 1]).all()
    np.testing.assert_allclose(topv.numpy(), np.asarray(
        jv / jnp.maximum(jv.sum(-1, keepdims=True), 1e-9)), rtol=1e-6)


@pytest.mark.parametrize("dispatch,dp", [("global", 1), ("local", 2),
                                         ("shard_map", 1)])
@pytest.mark.parametrize("T", [32, 6])
def test_moe_ffn_vs_jax(arch, dispatch, dp, T):
    """y within 1e-5 and aux within 1e-6 for each dispatch: "local" on two
    data shards (a capacity a shard), "shard_map" without a mesh (JAX's
    global path)."""
    jcfg = _dispatch(arch.jcfg, dispatch, dp)
    pcfg = _dispatch(arch.pcfg, dispatch, dp)
    jlp, plp = arch.layer(1)
    x = np.random.default_rng(T).standard_normal(
        (T, jcfg.d_model)).astype(np.float32)
    fn = jlm._MOE_DISPATCH[dispatch]
    jy, jaux = jax.jit(lambda x, lp: fn(x, lp, jcfg))(x, jlp)
    py, paux = plm._moe_ffn(torch.from_numpy(x), plp, pcfg)
    _close(py, jy)
    assert abs(float(paux) - float(jaux)) <= 1e-6


def test_local_dispatch_needs_whole_shards(arch):
    pcfg = _dispatch(arch.pcfg, "local", 4)
    x = torch.zeros((6, pcfg.d_model))
    with pytest.raises(ValueError, match="dp_shards"):
        plm._moe_ffn(x, arch.pp["layers"][0], pcfg)
    with pytest.raises(ValueError, match="dispatch"):
        plm._moe_ffn(x, arch.pp["layers"][0], _dispatch(arch.pcfg, "nope"))


# --- the model ---------------------------------------------------------------


@pytest.mark.parametrize("s", [1, 9])
def test_prefill_and_decode_vs_jax(arch, s):
    """At decode T = B = 2 tokens, so C = 1 and routed tokens are dropped,
    as in JAX."""
    tok = _tokens(2, s, arch.jcfg.vocab, seed=s)
    jlog, jcache = arch.prefill(arch.jp, tok)
    plog, pcache = plm.prefill(arch.pp, torch.from_numpy(tok), arch.pcfg,
                               max_len=MAX_LEN)
    _close(plog, jlog)
    _close(pcache["k"], jcache["k"])
    nxt = np.asarray(jnp.argmax(jlog, -1))[:, None].astype(np.int32)
    assert np.array_equal(plog.argmax(-1).numpy(), nxt[:, 0])
    assert plm.capacity(2, arch.pcfg.moe) == 1
    for _ in range(GEN):
        jlog, jcache = arch.decode(arch.jp, jcache, nxt)
        plog, pcache = plm.decode_step(arch.pp, pcache, torch.from_numpy(nxt),
                                       arch.pcfg)
        _close(plog, jlog)
        nxt = np.asarray(jnp.argmax(jlog, -1))[:, None].astype(np.int32)
        assert np.array_equal(plog.argmax(-1).numpy(), nxt[:, 0])
    _close(pcache["v"], jcache["v"])


def test_forward_vs_jax(arch):
    tok = _tokens(2, 16, arch.jcfg.vocab, seed=11)
    jh, jaux = arch.forward(arch.jp, tok)
    with torch.no_grad():
        ph, paux = plm.forward(arch.pp, torch.from_numpy(tok), arch.pcfg)
    _close(ph, jh)
    assert abs(float(paux) - float(jaux)) <= 1e-6 and float(paux) > 0


# --- configs, init, interop ---------------------------------------------------


def test_expert_init_scale(arch):
    """JAX draws the (L, E, D, F) stacks with scale 1/sqrt(D) (`stack`'s
    fan-in is shape[-2]), we_down 1/sqrt(F): the port's experts have the
    same spread (not √E smaller), each drawn on its own."""
    cfg = dataclasses.replace(arch.pcfg, d_model=128, d_ff=96)
    p = plm.init_params(torch.Generator().manual_seed(0), cfg)["layers"][0]
    jcfg = dataclasses.replace(arch.jcfg, d_model=128, d_ff=96)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)["layers"]
    e = cfg.moe.n_experts
    for name, shape in (("we_gate", (e, 128, 96)), ("we_up", (e, 128, 96)),
                        ("we_down", (e, 96, 128)), ("router", (128, e))):
        got, want = p[name], np.asarray(jp[name][0])
        assert tuple(got.shape) == shape == want.shape
        assert abs(float(got.std()) - want.std()) < 0.03 * want.std(), name
        assert float(got.abs().max()) <= 2 / math.sqrt(shape[-2]) + 1e-6
    assert not torch.equal(p["we_gate"][0], p["we_gate"][1])


def test_moe_params_cross_bit_for_bit():
    """bf16 MoE leaves cross from JAX's stacked (L, E, D, F) arrays to the
    port's per-layer tensors bit for bit."""
    jcfg = dataclasses.replace(jconfigs.get("kimi_k2_1t").smoke_config(),
                               param_dtype=jnp.bfloat16)
    jp = jlm.init_params(jax.random.PRNGKey(3), jcfg)
    pp = lm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    assert len(pp["layers"]) == jcfg.n_layers
    for i in range(jcfg.n_layers):
        for name in ("router", "we_gate", "we_up", "we_down", "ws_gate",
                     "ws_up", "ws_down"):
            got = pp["layers"][i][name]
            want = np.asarray(jp["layers"][name][i])
            assert got.dtype == torch.bfloat16
            assert np.array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16)), (i, name)


def test_bf16_moe_prefill_within_ulps():
    """deepseek's smoke config in bf16 (the full config's dtypes): logits
    within 8 bf16 ulps of each row's largest (5.5 seen).  The dense LMs
    take 4 (`tests/test_torch_lm.py`); the MoE FFN adds bf16 roundings
    that JAX on the CPU takes after each op and torch's fused ops once (the
    experts' SwiGLU, the slot weight, the bf16 combine, in other orders)."""
    jcfg = dataclasses.replace(jconfigs.get("deepseek_moe_16b").smoke_config(),
                               param_dtype=jnp.bfloat16,
                               compute_dtype=jnp.bfloat16)
    pcfg = dataclasses.replace(pconfigs.get("deepseek_moe_16b").smoke_config(),
                               param_dtype=torch.bfloat16,
                               compute_dtype=torch.bfloat16)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    pp = lm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    tok = _tokens(2, 16, jcfg.vocab, seed=5)
    jlog, _ = jax.jit(lambda p, t: jlm.prefill(p, t, jcfg))(jp, tok)
    plog, _ = plm.prefill(pp, torch.from_numpy(tok), pcfg)
    assert plog.dtype == torch.bfloat16
    got, want = _np(plog), _np(jlog)
    top = np.abs(want).max(-1, keepdims=True)
    assert (np.abs(got - want) <= 8 * 2.0 ** (np.floor(np.log2(top)) - 7)
            ).all()

"""The port's dense LM (`repro_torch.nn.core`, `repro_torch.models.lm`,
`repro_torch.configs`) against the JAX package, on the CPU.

The JAX model's weights (`repro.models.lm.init_params`) cross to the port by
`interop.lm_params_from_jax`, and the same seeded numpy tokens go through
`prefill`, `decode_step` and `forward` of both packages at the
`llama3_2_1b`, `stablelm_12b` and `minitron_8b` smoke configs.  On the CPU
the port's prefill attention is the `flash_attention` kernel's plain
version; JAX's is its chunked `flash_attention_ref`.

Tolerances: fp32 logits, hidden states and caches within rtol 1e-5 / atol
1e-5 (the two attentions sum their keys in other orders; ~1e-6 seen), and
greedy tokens exactly equal.  bf16 (JAX on the CPU rounds after each bf16
op, e.g. `silu` then the product; torch's fused ops round once): each
logit within 4 bf16 ulps of its row's largest |logit| (~1.3 seen), and
tokens equal wherever the JAX row's top-2 margin exceeds that.  The nn
functions: fp32 within 1e-6, bf16 within one bf16 ulp.

Prompt lengths 1, 7 and 200 (JAX's chunks cover every key there); S = 1025
pins the reference fault where JAX's chunks drop the last key.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as jconfigs
from repro.kernels import ref as jref
from repro.models import lm as jlm
from repro.nn import core as jcore
import repro_torch.configs as pconfigs
from repro_torch.interop import canonical_tensor, lm_params_from_jax
from repro_torch.kernels import flash_attention as flash_mod, ops as pops
from repro_torch.models import lm as plm
from repro_torch.nn import core as pcore

ARCHS = ("llama3_2_1b", "stablelm_12b", "minitron_8b")
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_ULPS = 4
MAX_LEN = 208            # one cache shape for every prompt: one JAX jit each
GEN = 3


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or TOL))


def _tokens(b, s, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


class Arch:
    """One config in both packages: JAX's params and jitted functions, the
    port's params carried over."""

    def __init__(self, name, jcfg=None, pcfg=None, max_len=MAX_LEN):
        self.jcfg = jcfg or jconfigs.get(name).smoke_config()
        self.pcfg = pcfg or pconfigs.get(name).smoke_config()
        self.jp = jlm.init_params(jax.random.PRNGKey(0), self.jcfg)
        self.pp = lm_params_from_jax(jax.tree.map(np.asarray, self.jp), "cpu")
        cfg = self.jcfg
        self.prefill = jax.jit(lambda p, t: jlm.prefill(p, t, cfg,
                                                        max_len=max_len))
        self.decode = jax.jit(lambda p, c, t: jlm.decode_step(p, c, t, cfg))
        self.forward = jax.jit(lambda p, t: jlm.forward(p, t, cfg))
        self.max_len = max_len


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    return Arch(request.param)


# --- nn/core -------------------------------------------------------------------


def test_rms_norm_vs_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32)
    _close(pcore.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
           jcore.rms_norm(x, w), rtol=1e-6, atol=1e-6)
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    got = pcore.rms_norm(canonical_tensor(np.asarray(jx), "cpu"),
                         canonical_tensor(np.asarray(jw), "cpu"))
    assert got.dtype == torch.bfloat16
    _close(got, jcore.rms_norm(jx, jw), rtol=2 ** -8, atol=0)


@pytest.mark.parametrize("theta", [500_000.0, 10_000.0])
def test_rope_vs_jax(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 4, 8)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9) * 37, (2, 9)).astype(np.int32)
    got = pcore.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    _close(got, jcore.rope(x, pos, theta), rtol=1e-6, atol=1e-6)
    # the half-split rotation keeps each pair's norm
    half = got.reshape(2, 9, 4, 2, 4)
    np.testing.assert_allclose((half ** 2).sum(3).numpy(),
                               (torch.from_numpy(x).reshape(2, 9, 4, 2, 4)
                                ** 2).sum(3).numpy(), rtol=1e-5)


def test_swiglu_vs_jax():
    rng = np.random.default_rng(2)
    x, wg, wu = (rng.standard_normal(s).astype(np.float32)
                 for s in ((4, 16), (16, 24), (16, 24)))
    wd = rng.standard_normal((24, 16)).astype(np.float32)
    got = pcore.swiglu(*(torch.from_numpy(a) for a in (x, wg, wu, wd)))
    _close(got, jcore.swiglu(x, wg, wu, wd), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s,n_chunks", [(8, 4), (6, 4)])
def test_cross_entropy_chunked_vs_jax(s, n_chunks):
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, s, 16)).astype(np.float32)
    unembed = rng.standard_normal((16, 40)).astype(np.float32)
    labels = rng.integers(-1, 40, (2, s)).astype(np.int32)   # -1 = padding
    got = pcore.cross_entropy_chunked(torch.from_numpy(h),
                                      torch.from_numpy(unembed),
                                      torch.from_numpy(labels), n_chunks)
    want = jcore.cross_entropy_chunked(h, unembed, labels, n_chunks)
    _close(got, want, rtol=1e-6, atol=1e-6)


def test_inits_follow_jax_distribution():
    """Truncated normal on [-2, 2] (std 0.8796 before the scale): the same
    distribution as JAX's, not the same values."""
    gen = torch.Generator().manual_seed(0)
    w = pcore.dense_init(gen, 256, 512, torch.bfloat16)
    jw = np.asarray(jcore.dense_init(jax.random.PRNGKey(0), 256, 512))
    assert w.shape == (256, 512) and w.dtype == torch.bfloat16
    scale = 1 / math.sqrt(256)
    assert float(w.float().abs().max()) <= 2 * scale * (1 + 2 ** -8)
    assert abs(float(w.float().std()) - jw.std()) < 0.02 * jw.std()
    e = pcore.embed_init(gen, 300, 64)
    assert e.dtype == torch.float32 and float(e.abs().max()) <= 2
    assert abs(float(e.std()) - 0.8796) < 0.02


# --- configs -----------------------------------------------------------------


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("alias", ["llama3.2-1b", "stablelm-12b",
                                   "minitron-8b", "deepseek-moe-16b",
                                   "kimi-k2-1t-a32b"])
def test_configs_are_jax_copies(alias):
    jmod, pmod = jconfigs.get(alias), pconfigs.get(alias)
    assert pmod.SHAPES == jmod.SHAPES and pmod.FAMILY == jmod.FAMILY
    assert pmod.SMOKE_SHAPES == jmod.SMOKE_SHAPES
    for make in ("full_config", "smoke_config"):
        jc, pc = getattr(jmod, make)(), getattr(pmod, make)()
        jf = _fields(jc)
        for k, v in _fields(pc).items():
            want = jf[k]
            if k.endswith("dtype"):
                v, want = str(v).removeprefix("torch."), jnp.dtype(want).name
            if k == "moe" and v is not None:
                v, want = _fields(v), _fields(want)
            assert v == want, (make, k)
        assert pc.head_dim == jc.head_dim
        assert pc.n_params() == jc.n_params()
        assert pc.n_active_params() == jc.n_active_params()
    assert pconfigs.get("llama3.2-1b").full_config().n_params() == 1498482688
    for gnn in ("gat_cora", "schnet", "meshgraphnet", "dimenet"):
        assert pconfigs.get(gnn).FAMILY == "gnn"


# --- the model -----------------------------------------------------------------


@pytest.mark.parametrize("s", [1, 7, 200])
def test_prefill_and_decode_vs_jax(arch, s):
    tok = _tokens(2, s, arch.jcfg.vocab, seed=s)
    jlog, jcache = arch.prefill(arch.jp, tok)
    plog, pcache = plm.prefill(arch.pp, torch.from_numpy(tok), arch.pcfg,
                               max_len=arch.max_len)
    _close(plog, jlog)
    _close(pcache["k"], jcache["k"])
    _close(pcache["v"], jcache["v"])
    assert pcache["length"] == int(jcache["length"]) == s
    nxt = np.asarray(jnp.argmax(jlog, -1))[:, None].astype(np.int32)
    assert np.array_equal(plog.argmax(-1).numpy(), nxt[:, 0])
    for _ in range(GEN):
        jlog, jcache = arch.decode(arch.jp, jcache, nxt)
        plog, pcache = plm.decode_step(arch.pp, pcache, torch.from_numpy(nxt),
                                       arch.pcfg)
        _close(plog, jlog)
        nxt = np.asarray(jnp.argmax(jlog, -1))[:, None].astype(np.int32)
        assert np.array_equal(plog.argmax(-1).numpy(), nxt[:, 0])
    _close(pcache["k"], jcache["k"])
    _close(pcache["v"], jcache["v"])
    assert pcache["length"] == int(jcache["length"]) == s + GEN


def test_forward_vs_jax(arch):
    tok = _tokens(2, 7, arch.jcfg.vocab, seed=11)
    jh, jaux = arch.forward(arch.jp, tok)
    ph, paux = plm.forward(arch.pp, torch.from_numpy(tok), arch.pcfg)
    _close(ph, jh)
    assert float(paux) == float(jaux) == 0.0


def test_bf16_prefill_and_decode_within_ulps():
    jcfg = dataclasses.replace(jconfigs.get("llama3_2_1b").smoke_config(),
                               param_dtype=jnp.bfloat16,
                               compute_dtype=jnp.bfloat16)
    pcfg = dataclasses.replace(pconfigs.get("llama3_2_1b").smoke_config(),
                               param_dtype=torch.bfloat16,
                               compute_dtype=torch.bfloat16)
    a = Arch("llama3_2_1b", jcfg, pcfg)
    assert a.pp["embed"].dtype == torch.bfloat16

    def check(plog, jlog):
        assert plog.dtype == torch.bfloat16
        got, want = _np(plog), _np(jlog)
        top = np.abs(want).max(-1, keepdims=True)
        ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
        assert (np.abs(got - want) <= BF16_ULPS * ulp).all()
        two = np.sort(want, -1)[:, -2:]
        sure = (two[:, 1] - two[:, 0]) > BF16_ULPS * ulp[:, 0]
        assert np.array_equal(got.argmax(-1)[sure], want.argmax(-1)[sure])

    tok = _tokens(2, 200, a.jcfg.vocab, seed=5)
    jlog, jcache = a.prefill(a.jp, tok)
    plog, pcache = plm.prefill(a.pp, torch.from_numpy(tok), a.pcfg,
                               max_len=a.max_len)
    check(plog, jlog)
    nxt = np.asarray(jnp.argmax(jlog, -1))[:, None].astype(np.int32)
    jlog, _ = a.decode(a.jp, jcache, nxt)
    plog, _ = plm.decode_step(a.pp, pcache, torch.from_numpy(nxt), a.pcfg)
    check(plog, jlog)


@pytest.fixture(scope="module")
def llama():
    return Arch("llama3_2_1b", max_len=8)


def test_token_ids_clamp_as_jax_gathers(llama):
    """JAX's `embed[tokens]` wraps an id below 0 once and clamps the rest
    into [0, V): V + 3 reads row V - 1, -1 row V - 1, -V - 2 row 0."""
    v = llama.jcfg.vocab
    tok = np.array([[v + 3, -1, 5, -v - 2, 2 * v, 0, 7]], np.int32)
    jlog, _ = llama.prefill(llama.jp, tok)
    plog, _ = plm.prefill(llama.pp, torch.from_numpy(tok), llama.pcfg,
                          max_len=8)
    _close(plog, jlog)
    same = np.array([[v - 1, v - 1, 5, 0, v - 1, 0, 7]], np.int32)
    _close(plog, llama.prefill(llama.jp, same)[0])


def test_decode_past_max_len_clamps_the_write(llama):
    """`lax.dynamic_update_slice_in_dim` clamps the write position into the
    cache: a prompt of 7 in a cache of 8 writes positions 7, 7, 7; the
    rotary position and the length go on (8, 9, 10)."""
    tok = _tokens(2, 7, llama.jcfg.vocab, seed=3)
    jlog, jcache = llama.prefill(llama.jp, tok)
    plog, pcache = plm.prefill(llama.pp, torch.from_numpy(tok), llama.pcfg,
                               max_len=8)
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(jlog, -1))[:, None].astype(np.int32)
        jlog, jcache = llama.decode(llama.jp, jcache, nxt)
        plog, pcache = plm.decode_step(llama.pp, pcache,
                                       torch.from_numpy(nxt), llama.pcfg)
        _close(plog, jlog)
        _close(pcache["k"], jcache["k"])
        _close(pcache["v"], jcache["v"])
    assert pcache["length"] == int(jcache["length"]) == 10


def test_s1025_reference_drops_the_last_key(monkeypatch):
    """Reference fault (ROADMAP.md Queue 3): JAX's prefill runs
    `flash_attention_ref` with block_kv = min(512, S), i.e. Sk // nblk keys
    a chunk over nblk = Sk // 512 chunks, so at S = 1025 key 1024 is never
    read and the last row (the one whose logits prefill returns) differs
    from `mha_ref`.  The port's attention reads every key: it equals
    `mha_ref`, and its model equals JAX's with `mha_ref` in place of the
    chunked oracle, not JAX's own."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((1, 4, 1025, 8)).astype(np.float32)
    k, v = (rng.standard_normal((1, 2, 1025, 8)).astype(np.float32)
            for _ in range(2))
    chunked = np.asarray(jref.flash_attention_ref(q, k, v, causal=True,
                                                  block_kv=512))
    full = np.asarray(jref.mha_ref(q, k, v, causal=True))
    assert np.abs(chunked[:, :, :1024] - full[:, :, :1024]).max() < 2e-6
    assert np.abs(chunked[:, :, 1024] - full[:, :, 1024]).max() > 1e-4
    got = pops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal=True, check_tiles=False)
    _close(got, full, rtol=2e-5, atol=2e-5)

    a = Arch("llama3_2_1b", max_len=None)
    tok = _tokens(1, 1025, a.jcfg.vocab, seed=9)
    plog, _ = plm.prefill(a.pp, torch.from_numpy(tok), a.pcfg)
    jlog, _ = a.prefill(a.jp, tok)
    assert np.abs(_np(plog) - _np(jlog)).max() > 1e-4     # the dropped key
    monkeypatch.setattr(jlm, "flash_attention_ref",
                        lambda q, k, v, causal, block_kv: jref.mha_ref(
                            q, k, v, causal=causal))
    cfg = a.jcfg
    jfull, _ = jax.jit(lambda p, t: jlm.prefill(p, t, cfg))(a.jp, tok)
    _close(plog, jfull)


def test_impl_plain_and_dispatch():
    """`impl` goes to `kernels.ops` unchanged: on the CPU "auto" runs the
    kernel's plain version (no launch), equal to impl="plain"; "kernel"
    raises without a CUDA tensor, and an unknown impl raises."""
    a = Arch("llama3_2_1b", max_len=None)
    tok = torch.from_numpy(_tokens(1, 5, a.jcfg.vocab, seed=1))
    before = dict(flash_mod.launches)
    auto, _ = plm.prefill(a.pp, tok, a.pcfg)
    plain, _ = plm.prefill(a.pp, tok, a.pcfg, impl="plain")
    assert torch.equal(auto, plain) and flash_mod.launches == before
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        plm.prefill(a.pp, tok, a.pcfg, impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        plm.prefill(a.pp, tok, a.pcfg, impl="nope")
    with pytest.raises(ValueError, match="max_len"):
        plm.prefill(a.pp, tok, a.pcfg, max_len=4)

"""Decoder-only LM, the dense path (port of `repro/models/lm.py`): GQA +
RoPE + SwiGLU, a causal prefill that fills a KV cache, and greedy
KV-cache decoding.

Parameters are a dict of tensors, the layers a list of per-layer dicts
(JAX stacks them on a leading axis for its `lax.scan`; the values are the
same), drawn on the device of the caller's `torch.Generator`.  Prefill
attention is `kernels.ops.flash_attention` with the caller's `impl`: under
"auto" the port's `flash_attention` CUDA kernel on a CUDA tensor and its
plain version (`kernels.ref.flash_attention_kernel_ref`) on a CPU tensor;
"plain" that plain version anywhere; nothing falls back from the kernel.
Decode attention stays PyTorch ops, as JAX computes it outside any Pallas
kernel: fp32 scores against K and V repeated over each GQA group, a -1e30
mask past the cache length, softmax.

Where the port and JAX part on purpose:
  * JAX's prefill attention is `flash_attention_ref` in chunks of
    ``Sk // (Sk // min(512, S))`` keys, which never reads the keys past the
    last whole chunk (S = 1025 drops the last one; ROADMAP.md Queue 3).
    The kernel and its plain version read every key, and take every prompt
    length;
  * the MoE FFN is not ported: a config with `moe` raises
    NotImplementedError (`MOE_NOT_PORTED`);
  * JAX's sharding hints (`constrain`) change no value on one device and
    are dropped, and `remat` / `scan_unroll` have no eager counterpart;
  * `decode_step` writes the new K and V into the cache's tensors in
    place (JAX's launcher donates the cache) and returns the same tensors;
    the cache length is a Python int.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch._device import resolve_device
from repro_torch.kernels import ops
from repro_torch.nn.core import dense_init, embed_init, rms_norm, rope

MOE_NOT_PORTED = ("the MoE FFN is not ported to repro_torch yet "
                  "(ROADMAP.md Queue 1 item 5a)")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """The expert counts of a MoE config (JAX's dispatch knobs come with the
    MoE FFN, ROADMAP.md Queue 1 item 5a)."""
    n_experts: int
    top_k: int
    n_shared: int = 1


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                      # 0 -> d_model // n_heads
    moe: Optional[MoEConfig] = None
    rope_theta: float = 500_000.0
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32
    loss_chunks: int = 8

    @property
    def head_dim(self):
        return self.d_head or self.d_model // self.n_heads

    def _count(self, experts: int) -> int:
        d, dh = self.d_model, self.head_dim
        attn = d * (self.n_heads * dh) * 2 + d * (self.n_kv_heads * dh) * 2
        if self.moe:
            ffn = (experts + self.moe.n_shared) * 3 * d * self.d_ff
            ffn += d * self.moe.n_experts
        else:
            ffn = 3 * d * self.d_ff
        return (self.n_layers * (attn + ffn + 2 * d)
                + 2 * self.vocab * d + d)

    def n_params(self) -> int:
        return self._count(self.moe.n_experts if self.moe else 0)

    def n_active_params(self) -> int:
        return self._count(self.moe.top_k if self.moe else 0)


# --- params ------------------------------------------------------------------


def init_params(generator: torch.Generator, cfg: LMConfig):
    """Parameters drawn from `generator`, on its device
    (``torch.Generator("cuda")`` for the card): {"embed" (V, D), "layers":
    [{"ln1", "ln2", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"}] *
    L, "ln_f" (D,), "unembed" (D, V)}, in `cfg.param_dtype`.  JAX's inits,
    not JAX's values."""
    if cfg.moe:
        raise NotImplementedError(MOE_NOT_PORTED)
    d, dh, dt = cfg.d_model, cfg.head_dim, cfg.param_dtype
    dev = generator.device

    def dense(i, o):
        return dense_init(generator, i, o, dt)

    layers = [{
        "ln1": torch.ones(d, dtype=dt, device=dev),
        "ln2": torch.ones(d, dtype=dt, device=dev),
        "wq": dense(d, cfg.n_heads * dh),
        "wk": dense(d, cfg.n_kv_heads * dh),
        "wv": dense(d, cfg.n_kv_heads * dh),
        "wo": dense(cfg.n_heads * dh, d),
        "w_gate": dense(d, cfg.d_ff),
        "w_up": dense(d, cfg.d_ff),
        "w_down": dense(cfg.d_ff, d),
    } for _ in range(cfg.n_layers)]
    return {
        "embed": embed_init(generator, cfg.vocab, d, dt),
        "layers": layers,
        "ln_f": torch.ones(d, dtype=dt, device=dev),
        "unembed": dense(d, cfg.vocab),
    }


def _embed(table: torch.Tensor, tokens: torch.Tensor, dtype):
    """JAX's `table[tokens]`: an id below 0 wraps once (id + V), then every
    id is clamped into [0, V)."""
    v = table.shape[0]
    ids = torch.where(tokens < 0, tokens + v, tokens).clamp(0, v - 1)
    return table[ids.long()].to(dtype)


# --- attention ---------------------------------------------------------------


def attention_inputs(x, lp, cfg: LMConfig, positions):
    """The layer's q (B, H, S, dh), k and v (B, Hkv, S, dh) of x (B, S, D),
    rotary embedding applied to q and k."""
    b, s, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cdt = cfg.compute_dtype
    q = rope((x @ lp["wq"].to(cdt)).reshape(b, s, h, dh), positions,
             cfg.rope_theta)
    k = rope((x @ lp["wk"].to(cdt)).reshape(b, s, hkv, dh), positions,
             cfg.rope_theta)
    v = (x @ lp["wv"].to(cdt)).reshape(b, s, hkv, dh)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def _project_out(o, lp, cfg: LMConfig):
    """Attention output (B, H, S, dh) -> (B, S, D) through wo."""
    b, h, s, dh = o.shape
    return o.transpose(1, 2).reshape(b, s, h * dh) @ lp["wo"].to(
        cfg.compute_dtype)


def _attention(x, lp, cfg: LMConfig, positions, impl: str = "auto"):
    """Causal self-attention of x (B, S, D): returns (out, the layer's
    (k, v)).  The kernel and its plain version take any S, so JAX's
    Pallas tile check is off."""
    q, k, v = attention_inputs(x, lp, cfg, positions)
    o = ops.flash_attention(q, k, v, causal=True, impl=impl,
                            check_tiles=False)
    return _project_out(o, lp, cfg), (k, v)


def _cached_attention(q, k_cache, v_cache, cache_len: int, cfg: LMConfig):
    """Decode attention of q (B, H, 1, dh) over the first `cache_len`
    positions of the caches (B, Hkv, S_max, dh), as JAX computes it: K and
    V repeated over each GQA group in fp32, scores scaled by 1/sqrt(dh),
    -1e30 past `cache_len`, softmax."""
    group = cfg.n_heads // cfg.n_kv_heads
    kk = k_cache.repeat_interleave(group, dim=1).float()
    vv = v_cache.repeat_interleave(group, dim=1).float()
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk)
    scores = scores / math.sqrt(cfg.head_dim)
    valid = torch.arange(k_cache.shape[2], device=q.device) < cache_len
    scores = torch.where(valid, scores, -1e30)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, vv).to(cfg.compute_dtype)


# --- blocks ------------------------------------------------------------------


def _ffn(x, lp, cfg: LMConfig):
    """SwiGLU FFN; returns (out, aux), aux 0 (the MoE load-balance loss)."""
    if cfg.moe is not None:
        raise NotImplementedError(MOE_NOT_PORTED)
    cdt = cfg.compute_dtype
    h = F.silu(x @ lp["w_gate"].to(cdt)) * (x @ lp["w_up"].to(cdt))
    return h @ lp["w_down"].to(cdt), torch.zeros((), device=x.device)


def _layer(x, lp, cfg: LMConfig, positions, impl: str = "auto"):
    """One causal block: returns (out, aux, the layer's (k, v))."""
    a, kv = _attention(rms_norm(x, lp["ln1"]), lp, cfg, positions, impl=impl)
    x = x + a
    f, aux = _ffn(rms_norm(x, lp["ln2"]), lp, cfg)
    return x + f, aux, kv


def forward(params, tokens, cfg: LMConfig, impl: str = "auto"):
    """tokens: (B, S) -> (hidden states (B, S, D) after the final norm,
    the layers' mean aux loss)."""
    x = _embed(params["embed"], tokens, cfg.compute_dtype)
    positions = torch.arange(tokens.shape[1], device=x.device).expand(
        tokens.shape)
    auxs = []
    for lp in params["layers"]:
        x, aux, _ = _layer(x, lp, cfg, positions, impl)
        auxs.append(aux)
    return rms_norm(x, params["ln_f"]), torch.stack(auxs).mean()


# --- serving -----------------------------------------------------------------


def init_kv_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None,
                  device=None):
    """Zero K and V caches (L, B, Hkv, max_len, dh) in `dtype` (default
    the compute dtype) on `device` (default ``"cuda"``), length 0."""
    dt = dtype or cfg.compute_dtype
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev), "length": 0}


def prefill(params, tokens, cfg: LMConfig, max_len: int | None = None,
            impl: str = "auto"):
    """The causal forward over the prompt (B, S): returns (last-token
    logits (B, V), a cache of `max_len` (default S) positions holding the
    prompt's K and V, length S)."""
    b, s = tokens.shape
    max_len = max_len or s
    if max_len < s:
        raise ValueError(f"max_len {max_len} < prompt length {s}")
    cdt = cfg.compute_dtype
    x = _embed(params["embed"], tokens, cdt)
    positions = torch.arange(s, device=x.device).expand(b, s)
    cache = init_kv_cache(cfg, b, max_len, device=x.device)
    for l, lp in enumerate(params["layers"]):
        x, _, (kx, vx) = _layer(x, lp, cfg, positions, impl)
        cache["k"][l, :, :, :s] = kx
        cache["v"][l, :, :, :s] = vx
    h = rms_norm(x[:, -1], params["ln_f"])       # the norm is per position
    cache["length"] = s
    return h @ params["unembed"].to(cdt), cache


def decode_step(params, cache, tokens, cfg: LMConfig):
    """One decoding step.  tokens: (B, 1) newest ids, written at position
    `cache["length"]` (clamped into the cache, as JAX's
    `dynamic_update_slice` clamps it; the rotary position is not clamped).
    Returns (logits (B, V), the cache with length + 1; its K and V tensors
    are updated in place)."""
    cdt = cfg.compute_dtype
    b = tokens.shape[0]
    pos = int(cache["length"])
    x = _embed(params["embed"], tokens, cdt)     # (B, 1, D)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    slot = min(pos, cache["k"].shape[3] - 1)
    for l, lp in enumerate(params["layers"]):
        q, kx, vx = attention_inputs(rms_norm(x, lp["ln1"]), lp, cfg,
                                     positions)          # (B, H(kv), 1, dh)
        kc, vc = cache["k"][l], cache["v"][l]
        kc[:, :, slot] = kx[:, :, 0].to(kc.dtype)
        vc[:, :, slot] = vx[:, :, 0].to(vc.dtype)
        x = x + _project_out(_cached_attention(q, kc, vc, pos + 1, cfg), lp,
                             cfg)
        f, _ = _ffn(rms_norm(x, lp["ln2"]), lp, cfg)
        x = x + f
    h = rms_norm(x[:, 0], params["ln_f"])
    return (h @ params["unembed"].to(cdt),
            {"k": cache["k"], "v": cache["v"], "length": pos + 1})

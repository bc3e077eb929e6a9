"""Decoder-only LM (port of `repro/models/lm.py`): GQA + RoPE + SwiGLU, an
optional fine-grained MoE FFN (shared + routed experts, top-k, capacity-
bounded dispatch), a causal prefill that fills a KV cache, greedy KV-cache
decoding, and the training loss.

Parameters are a dict of tensors, the layers a list of per-layer dicts
(JAX stacks them on a leading axis for its `lax.scan`; the values are the
same), drawn on the device of the caller's `torch.Generator`.  Prefill and
training attention is `kernels.ops.flash_attention` with the caller's
`impl`: under "auto" the port's `flash_attention` CUDA kernel on a CUDA
tensor and its plain version (`kernels.ref.flash_attention_kernel_ref`) on
a CPU tensor, both with the hand-written backward of `kernels.ops`;
"plain" that plain version anywhere, differentiated by autograd; nothing
falls back from the kernel.  Decode attention stays PyTorch ops, as JAX
computes it outside any Pallas kernel: fp32 scores against K and V
repeated over each GQA group, a -1e30 mask past the cache length, softmax.

The MoE FFN has JAX's three dispatches.  "global": one stable sort of all
T*k (token, expert) slots, capacity C = max(ceil(T*k/E*capacity_factor),
1) a expert, the overflow dropped; "local": the same per data shard of
T/dp_shards tokens; "shard_map": JAX's manually partitioned path, which
runs the global path when no mesh with a "model" axis is bound, as here
(one device; the multi-rank expert split is ROADMAP.md Queue 1 item 5d).

Where the port and JAX part on purpose:
  * JAX's prefill attention is `flash_attention_ref` in chunks of
    ``Sk // (Sk // min(512, S))`` keys, which never reads the keys past the
    last whole chunk (S = 1025 drops the last one; ROADMAP.md Queue 3).
    The kernel and its plain version read every key, and take every prompt
    length;
  * JAX's sharding hints (`constrain`) change no value on one device and
    are dropped, and so are `scan_unroll` (an eager loop has no scan),
    `fsdp` and `seq_shard` (one device holds every parameter and the whole
    sequence).  `remat` (a layer), `remat_attn` (the attention call) and
    `remat_loss` (the loss) are `torch.utils.checkpoint` regions while
    gradients are on: the region's forward runs again in the backward,
    launching the attention kernel again, and changes no value;
  * top-k keeps `lax.top_k`'s order on ties, lowest expert first (a stable
    descending sort; `torch.topk` orders ties otherwise);
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
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.kernels import ops
from repro_torch.nn.core import (cross_entropy_chunked, dense_init,
                                 embed_init, rms_norm, rope)

MOE_DISPATCHES = ("global", "local", "shard_map")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 1
    capacity_factor: float = 1.25
    # "global": one dispatch sort over all tokens; "local": a sort a data
    # shard of T / dp_shards tokens; "shard_map": JAX's manually
    # partitioned path, the global one without a "model" mesh axis
    dispatch: str = "global"
    dp_shards: int = 1         # data shards of the local dispatch


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
    remat: bool = True           # recompute each layer in the backward
    loss_chunks: int = 8
    remat_attn: bool = False     # recompute the attention call
    remat_loss: bool = False     # recompute the loss

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
    [{"ln1", "ln2", "wq", "wk", "wv", "wo", FFN}] * L, "ln_f" (D,),
    "unembed" (D, V)}, in `cfg.param_dtype`.  The dense FFN is "w_gate",
    "w_up", "w_down"; the MoE FFN "router" (D, E), the routed experts
    "we_gate", "we_up" (E, D, F) and "we_down" (E, F, D), and the shared
    ones "ws_gate", "ws_up" (D, n_shared F) and "ws_down".  JAX's inits,
    not JAX's values: each matrix a truncated normal scaled by 1/sqrt(its
    fan-in), an expert's D or F as in JAX's stacked draw, drawn one expert
    at a time (one kimi-k2 stack is 11 GB in bf16)."""
    d, dh, dt = cfg.d_model, cfg.head_dim, cfg.param_dtype
    dev = generator.device

    def dense(i, o):
        return dense_init(generator, i, o, dt)

    def experts(e, i, o):
        w = torch.empty((e, i, o), dtype=dt, device=dev)
        for j in range(e):
            w[j] = dense(i, o)
        return w

    def layer():
        lp = {
            "ln1": torch.ones(d, dtype=dt, device=dev),
            "ln2": torch.ones(d, dtype=dt, device=dev),
            "wq": dense(d, cfg.n_heads * dh),
            "wk": dense(d, cfg.n_kv_heads * dh),
            "wv": dense(d, cfg.n_kv_heads * dh),
            "wo": dense(cfg.n_heads * dh, d),
        }
        if cfg.moe is None:
            lp.update(w_gate=dense(d, cfg.d_ff), w_up=dense(d, cfg.d_ff),
                      w_down=dense(cfg.d_ff, d))
            return lp
        e, f, fs = cfg.moe.n_experts, cfg.d_ff, cfg.moe.n_shared * cfg.d_ff
        lp.update(router=dense(d, e), we_gate=experts(e, d, f),
                  we_up=experts(e, d, f), we_down=experts(e, f, d),
                  ws_gate=dense(d, fs), ws_up=dense(d, fs),
                  ws_down=dense(fs, d))
        return lp

    return {
        "embed": embed_init(generator, cfg.vocab, d, dt),
        "layers": [layer() for _ in range(cfg.n_layers)],
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

    def attn(q, k, v):
        return ops.flash_attention(q, k, v, causal=True, impl=impl,
                                   check_tiles=False)

    if cfg.remat_attn and torch.is_grad_enabled():
        o = checkpoint(attn, q, k, v, use_reentrant=False)
    else:
        o = attn(q, k, v)
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


# --- MoE ---------------------------------------------------------------------


def _expert_ffn(xg, lp, cdt):
    """xg: (E, C, D) -> (E, C, D) through each expert's SwiGLU."""
    hg = torch.bmm(xg, lp["we_gate"].to(cdt))
    hu = torch.bmm(xg, lp["we_up"].to(cdt))
    return torch.bmm(F.silu(hg) * hu, lp["we_down"].to(cdt))


def _dispatch_tables(topi, topv, T: int, E: int, C: int):
    """Capacity-bounded dispatch of the (T, k) top-k experts `topi` and
    their weights `topv`: the T*k slots sorted by expert (stable, so by
    token within an expert), ranked by position, the first C of each
    expert kept.  Returns (table, wtab, slots): JAX's two tables, the
    source token of each of the E*C expert slots (T, the padding sentinel,
    where none) and its weight (0 there), and the slot of each (token,
    choice), (T, k), E*C where it overflowed.  Overflow is written to slot
    E*C of the tables, a dump row cut off after the writes, as JAX's
    `mode="drop"` drops it."""
    k = topi.shape[-1]
    dev = topi.device
    ef = topi.reshape(-1).long()
    tok = torch.arange(T, device=dev).repeat_interleave(k)
    es, order = torch.sort(ef, stable=True)
    pos = (torch.arange(T * k, device=dev)
           - torch.searchsorted(es, es, right=False))
    slot = torch.where(pos < C, es * C + pos, E * C)
    table = torch.full((E * C + 1,), T, dtype=torch.int32, device=dev)
    table[slot] = tok[order].to(torch.int32)
    wtab = torch.zeros(E * C + 1, dtype=torch.float32, device=dev)
    wtab[slot] = topv.reshape(-1)[order].float()
    slots = torch.empty_like(slot)
    slots[order] = slot
    return table[:E * C], wtab[:E * C], slots.reshape(T, k)


def _route(x2d, lp, cfg: LMConfig):
    """The router of tokens x2d (T, D): (probs (T, E) fp32, the top-k
    experts (T, k) in `lax.top_k`'s order, ties lowest expert first, and
    their probabilities normalised to sum 1)."""
    logits = x2d.float() @ lp["router"].float()
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :cfg.moe.top_k], topi[:, :cfg.moe.top_k]
    topv = topv / topv.sum(-1, keepdim=True).clamp(min=1e-9)
    return probs, topi, topv


def capacity(tokens: int, mcfg: MoEConfig) -> int:
    """Slots an expert of a dispatch over `tokens` tokens, JAX's
    ``max(int(ceil(T * k / E * capacity_factor)), 1)`` in its order."""
    return max(int(math.ceil(tokens * mcfg.top_k / mcfg.n_experts
                             * mcfg.capacity_factor)), 1)


def _routed(x2d, topi, topv, lp, cfg: LMConfig):
    """The routed experts' output (T, D) of one dispatch over x2d: gather
    each expert's C slots (the sentinel T reads an appended zero row), the
    expert FFN, the slot weight, and the sum back to the tokens in the
    compute dtype.  The sum gathers each token's slots and adds them in
    expert order, as JAX's `.at[table].add` meets them, and with no atomic
    adds, so the card gives the same values every run."""
    T, d = x2d.shape
    E, cdt = cfg.moe.n_experts, cfg.compute_dtype
    C = capacity(T, cfg.moe)
    table, wtab, slots = _dispatch_tables(topi, topv, T, E, C)
    xp = torch.cat([x2d, x2d.new_zeros(1, d)])
    xg = xp[table.long()].reshape(E, C, d)
    out = _expert_ffn(xg, lp, cdt) * wtab.reshape(E, C, 1).to(cdt)
    out = torch.cat([out.reshape(E * C, d), out.new_zeros(1, d)])
    slots = torch.sort(slots, dim=1).values      # expert order, drops last
    y = out[slots[:, 0]]
    for j in range(1, slots.shape[1]):
        y = y + out[slots[:, j]]
    return y


def _moe_ffn(x2d, lp, cfg: LMConfig):
    """x2d: (T, D) -> (out (T, D), the switch load-balance aux loss).
    `dispatch` "global" and "shard_map" sort all T tokens at once; "local"
    sorts each of `dp_shards` runs of T / dp_shards tokens apart, each with
    its own capacity."""
    mcfg, cdt = cfg.moe, cfg.compute_dtype
    T = x2d.shape[0]
    E, k = mcfg.n_experts, mcfg.top_k
    probs, topi, topv = _route(x2d, lp, cfg)
    if mcfg.dispatch == "local":
        if T % mcfg.dp_shards:
            raise ValueError(f"the local dispatch needs T = {T} tokens to be "
                             f"a multiple of dp_shards = {mcfg.dp_shards}")
        tl = T // mcfg.dp_shards
        y = torch.cat([_routed(x2d[i:i + tl], topi[i:i + tl],
                               topv[i:i + tl], lp, cfg)
                       for i in range(0, T, tl)])
    elif mcfg.dispatch in ("global", "shard_map"):
        y = _routed(x2d, topi, topv, lp, cfg)
    else:
        raise ValueError(f"moe.dispatch must be one of {MOE_DISPATCHES}, "
                         f"got {mcfg.dispatch!r}")
    hs = F.silu(x2d @ lp["ws_gate"].to(cdt)) * (x2d @ lp["ws_up"].to(cdt))
    y = y + hs @ lp["ws_down"].to(cdt)
    counts = torch.zeros(E, device=x2d.device).index_add(
        0, topi.reshape(-1), torch.ones(T * k, device=x2d.device))
    aux = E * torch.sum(counts / (T * k) * probs.mean(0))
    return y, aux


# --- blocks ------------------------------------------------------------------


def _ffn(x, lp, cfg: LMConfig):
    """The FFN of x (B, S, D): returns (out, aux), aux the MoE
    load-balance loss (0 for the dense SwiGLU)."""
    cdt = cfg.compute_dtype
    if cfg.moe is None:
        h = F.silu(x @ lp["w_gate"].to(cdt)) * (x @ lp["w_up"].to(cdt))
        return (h @ lp["w_down"].to(cdt),
                torch.zeros((), device=x.device))
    b, s, d = x.shape
    y, aux = _moe_ffn(x.reshape(b * s, d), lp, cfg)
    return y.reshape(b, s, d), aux


def _layer(x, lp, cfg: LMConfig, positions, impl: str = "auto"):
    """One causal block: returns (out, aux, the layer's (k, v))."""
    a, kv = _attention(rms_norm(x, lp["ln1"]), lp, cfg, positions, impl=impl)
    x = x + a
    f, aux = _ffn(rms_norm(x, lp["ln2"]), lp, cfg)
    return x + f, aux, kv


def _train_layer(x, lp, cfg: LMConfig, positions, impl: str):
    """`_layer` without the (k, v) a prefill keeps: (out, aux)."""
    return _layer(x, lp, cfg, positions, impl)[:2]


def forward(params, tokens, cfg: LMConfig, impl: str = "auto"):
    """tokens: (B, S) -> (hidden states (B, S, D) after the final norm,
    the layers' mean aux loss).  With `cfg.remat` and gradients on, each
    layer is a checkpoint region."""
    x = _embed(params["embed"], tokens, cfg.compute_dtype)
    positions = torch.arange(tokens.shape[1], device=x.device).expand(
        tokens.shape)
    remat = cfg.remat and torch.is_grad_enabled()
    auxs = []
    for lp in params["layers"]:
        if remat:
            x, aux = checkpoint(_train_layer, x, lp, cfg, positions, impl,
                                use_reentrant=False)
        else:
            x, aux = _train_layer(x, lp, cfg, positions, impl)
        auxs.append(aux)
    return rms_norm(x, params["ln_f"]), torch.stack(auxs).mean()


def loss_fn(params, batch, cfg: LMConfig, aux_weight: float = 0.01,
            impl: str = "auto"):
    """Token-mean next-token cross entropy (`cfg.loss_chunks` chunks, fp32
    logits) plus `aux_weight` times the mean MoE aux loss.  batch:
    "tokens" and "labels" (B, S), label < 0 = padding.  Returns (loss,
    {"ce", "aux"})."""
    h, aux = forward(params, batch["tokens"], cfg, impl)
    unembed = params["unembed"].to(cfg.compute_dtype)
    args = (h, unembed, batch["labels"], cfg.loss_chunks)
    if cfg.remat_loss and torch.is_grad_enabled():
        ce = checkpoint(cross_entropy_chunked, *args, use_reentrant=False)
    else:
        ce = cross_entropy_chunked(*args)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


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

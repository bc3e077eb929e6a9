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
runs the global path when no mesh is bound.

On a mesh (`runtime.meshctx.use_mesh`), `forward`, `loss_fn`, `prefill`,
`decode_step` and `_moe_ffn` run JAX's sharded layout over torch.distributed
ranks with explicit collectives (the section "on a mesh" below): the
parameters are each rank's FSDP x TP blocks (`param_logical_specs`,
`shard_params`), all-gathered over "data" a layer at a time, their
gradients reduce-scattered; heads, d_ff, the vocabulary and the experts
are split over "model" (Q, K, V, gate and up column-parallel, wo and
w_down row-parallel), each rank launching the attention kernel on its own
heads; the batch is split over "dp" and, with `seq_shard`, the residual
stream's sequence over "model" (Megatron SP); the embedding and the loss
are vocab-parallel; the MoE runs `_moe_ffn_shardmap`'s partition; decode
takes a KV cache whose batch and sequence are sharded (`CACHE_LOGICAL`,
`LONG_CACHE_LOGICAL`) and merges the ranks' attention by log-sum-exp.  No
rank gathers the whole model.

Where the port and JAX part on purpose:
  * JAX's prefill attention is `flash_attention_ref` in chunks of
    ``Sk // (Sk // min(512, S))`` keys, which never reads the keys past the
    last whole chunk (S = 1025 drops the last one; ROADMAP.md Queue 3).
    The kernel and its plain version read every key, and take every prompt
    length;
  * JAX's sharding hints (`constrain`) are the explicit collectives of
    the mesh path, and `scan_unroll` is dropped (an eager loop has no
    scan); `fsdp` and `seq_shard` act on a mesh only.  On a mesh, the MoE's
    "local" dispatch with dp_shards equal to the data shards, and "global"
    with one data shard, run the shard_map partition (the same values);
    another raises.  `remat` (a layer), `remat_attn` (the attention call) and
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
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.kernels import ops
from repro_torch.nn.core import (cross_entropy_chunked, dense_init,
                                 embed_init, rms_norm, rope)
from repro_torch.runtime.meshctx import (LOGICAL_AXES, gather_blocks,
                                         get_current_mesh, local_block,
                                         logical_to_spec, sharded_norm_fn)
from repro_torch.tree import tree_map

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
    opt_moment_dtype: Any = torch.float32   # AdamW's moments (bf16 halves)
    seq_shard: bool = True       # on a mesh: sequence-parallel residual
    fsdp: bool = True            # on a mesh: parameters sharded over "data"

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


def init_params(generator: torch.Generator, cfg: LMConfig, device=None):
    """Parameters drawn from `generator`, on its device
    (``torch.Generator("cuda")`` for the card) unless `device` names
    another (``"meta"``: shapes and dtypes only): {"embed" (V, D), "layers":
    [{"ln1", "ln2", "wq", "wk", "wv", "wo", FFN}] * L, "ln_f" (D,),
    "unembed" (D, V)}, in `cfg.param_dtype`.  The dense FFN is "w_gate",
    "w_up", "w_down"; the MoE FFN "router" (D, E), the routed experts
    "we_gate", "we_up" (E, D, F) and "we_down" (E, F, D), and the shared
    ones "ws_gate", "ws_up" (D, n_shared F) and "ws_down".  JAX's inits,
    not JAX's values: each matrix a truncated normal scaled by 1/sqrt(its
    fan-in), an expert's D or F as in JAX's stacked draw, drawn one expert
    at a time (one kimi-k2 stack is 11 GB in bf16)."""
    d, dh, dt = cfg.d_model, cfg.head_dim, cfg.param_dtype
    dev = generator.device if device is None else torch.device(device)

    def dense(i, o):
        return dense_init(generator, i, o, dt, device=dev)

    def experts(e, i, o):
        w = torch.empty((e, i, o), dtype=dt, device=dev)
        if dev.type == "meta":                # no values to draw
            return w
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
        "embed": embed_init(generator, cfg.vocab, d, dt, device=dev),
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
    return _project_qkv(x, lp["wq"], lp["wk"], lp["wv"], cfg.n_heads,
                        cfg.n_kv_heads, cfg, positions)


def _project_qkv(x, wq, wk, wv, h, hkv, cfg: LMConfig, positions):
    """q (B, h, S, dh), k and v (B, hkv, S, dh) of x (B, S, D) through the
    projections wq (D, h dh), wk and wv (D, hkv dh); rotary on q and k."""
    b, s, _ = x.shape
    dh, cdt = cfg.head_dim, cfg.compute_dtype
    q = rope((x @ wq.to(cdt)).reshape(b, s, h, dh), positions,
             cfg.rope_theta)
    k = rope((x @ wk.to(cdt)).reshape(b, s, hkv, dh), positions,
             cfg.rope_theta)
    v = (x @ wv.to(cdt)).reshape(b, s, hkv, dh)
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
    mesh = get_current_mesh()
    if mesh is not None:
        sh = _Sharded(cfg, mesh)
        _check_dispatch(sh)
        y, aux = _sh_moe(mesh.copy_to(x2d, sh.tp), lp, sh)
        return mesh.all_reduce(y, sh.tp), aux
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
    layer is a checkpoint region.  On a mesh: `_sh_forward`."""
    mesh = get_current_mesh()
    if mesh is not None:
        return _sh_forward(params, tokens, _Sharded(cfg, mesh), impl)
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
    {"ce", "aux"}).  On a mesh the loss is the same on every rank."""
    mesh = get_current_mesh()
    if mesh is not None:
        return _sh_loss_fn(params, batch, _Sharded(cfg, mesh), aux_weight,
                           impl)
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
    mesh = get_current_mesh()
    if mesh is not None:
        return _sh_prefill(params, tokens, cfg, max_len, impl, mesh)
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
    are updated in place).  On a mesh: `_sh_decode_step`."""
    mesh = get_current_mesh()
    if mesh is not None:
        return _sh_decode_step(params, cache, tokens, cfg, mesh)
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


# --- on a mesh (runtime.meshctx) ------------------------------------------
#
# With a `Mesh` bound by `use_mesh`, `forward`, `loss_fn`, `prefill`,
# `decode_step` and `_moe_ffn` take each rank's own blocks of the parameters
# (`shard_params`) and of the batch (its "dp" block) and run JAX's 2-D
# FSDP x TP layout with explicit collectives.  A tensor replicated over an
# axis that the computation is split over enters through `copy_to` (its
# gradient summed there), as an unmapped input of JAX's `shard_map` is
# transposed; every other sum is one of the collectives below.


def param_logical_specs(cfg: LMConfig):
    """Logical spec tree matching `init_params`' structure (JAX's
    `param_logical_specs` with the layers a list: each layer's spec is
    JAX's stacked spec without its leading scan dim).  `cfg.fsdp=False`
    drops the data-axis parameter sharding."""
    fs = "fsdp" if cfg.fsdp else None
    layer = {"ln1": (None,), "ln2": (None,), "wq": (fs, "tp"),
             "wk": (fs, "tp"), "wv": (fs, "tp"), "wo": ("tp", fs)}
    if cfg.moe:
        layer.update(router=(fs, None), we_gate=("tp", fs, None),
                     we_up=("tp", fs, None), we_down=("tp", None, fs),
                     ws_gate=(fs, "tp"), ws_up=(fs, "tp"),
                     ws_down=("tp", fs))
    else:
        layer.update(w_gate=(fs, "tp"), w_up=(fs, "tp"), w_down=("tp", fs))
    return {"embed": ("tp", fs),
            "layers": [dict(layer) for _ in range(cfg.n_layers)],
            "ln_f": (None,), "unembed": (fs, "tp")}


def check_mesh(cfg: LMConfig, mesh) -> None:
    """Raise ValueError unless `mesh` splits every sharded dimension of the
    model: heads, the KV projections' columns, d_ff, the vocabulary and the
    experts over "model", d_model over "data" (with fsdp).  The KV heads
    may be fewer than the "model" ranks when they divide them: each rank
    then takes the one KV head its query heads use (`_Sharded.kv`)."""
    tp, fs = mesh.axis_size("model"), mesh.axis_size("data")
    dims = {"n_heads": cfg.n_heads,
            "n_kv_heads * d_head": cfg.n_kv_heads * cfg.head_dim,
            "vocab": cfg.vocab, "d_ff": cfg.d_ff}
    if cfg.moe:
        dims.update(n_experts=cfg.moe.n_experts,
                    shared_d_ff=cfg.moe.n_shared * cfg.d_ff)
    bad = [f"{k} = {v}" for k, v in dims.items() if v % tp]
    if cfg.n_kv_heads % tp and tp % cfg.n_kv_heads:
        bad.append(f"n_kv_heads = {cfg.n_kv_heads}")
    if cfg.fsdp and cfg.d_model % fs:
        bad.append(f"d_model = {cfg.d_model} (over data = {fs})")
    if bad:
        raise ValueError(f"a mesh with model = {tp} does not split "
                         f"{', '.join(bad)}")


def bind_mesh(cfg: LMConfig, mesh) -> LMConfig:
    """`cfg` with the MoE's `dp_shards` set to the mesh's data shards, as
    JAX's cells bind it (`repro/launch/cells.py:94–97`)."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dp_shards=mesh.axis_size(LOGICAL_AXES["dp"])))


def shard_params(params, cfg: LMConfig, mesh):
    """Each rank's own blocks of the whole parameters (`init_params`, or
    `interop.lm_params_from_jax`) under `param_logical_specs` on `mesh`,
    as copies, so the whole tree can be freed."""
    check_mesh(cfg, mesh)
    return tree_map(lambda t, spec: local_block(
        t, logical_to_spec(spec, mesh), mesh).clone(), params,
        param_logical_specs(cfg))


def unshard_params(params, cfg: LMConfig, mesh):
    """The whole parameters from every rank's blocks (each leaf gathered;
    for checks and checkpoints, not the model's path)."""
    return tree_map(lambda t, spec: gather_blocks(
        t, logical_to_spec(spec, mesh), mesh), params,
        param_logical_specs(cfg))


def global_norm_fn(cfg: LMConfig, mesh):
    """The global gradient norm of a sharded parameter tree, for the
    optimizers' `norm_fn`: each leaf's sum of squares divided by the ranks
    holding the same block, one sum over every rank."""
    return sharded_norm_fn(param_logical_specs(cfg), mesh)


class _Sharded:
    """The mesh's axes as the LM uses them."""

    def __init__(self, cfg: LMConfig, mesh, batch_split: bool = True):
        check_mesh(cfg, mesh)
        self.cfg, self.mesh = cfg, mesh
        self.dp = mesh.axes(LOGICAL_AXES["dp"])
        self.fsdp = mesh.axes(LOGICAL_AXES["fsdp"])
        self.tp = mesh.axes(LOGICAL_AXES["tp"])
        self.tp_n = mesh.axis_size(self.tp)
        self.j = mesh.index(self.tp)
        self.sp = cfg.seq_shard and self.tp_n > 1
        self.batch_split = batch_split        # the batch is split over dp
        self.lspec = param_logical_specs(cfg)["layers"][0] \
            if cfg.n_layers else {}
        # KV heads a rank projects; with fewer KV heads than "model" ranks,
        # `rep` ranks share each one
        self.hkv = max(cfg.n_kv_heads // self.tp_n, 1)
        self.rep = max(self.tp_n // cfg.n_kv_heads, 1)

    def use(self, w, logical, model_split: bool = False):
        """A parameter block ready to use: all-gathered over "data" on its
        fsdp dim (gradient reduce-scattered), its gradient summed over the
        dp axes it is not sharded over, and over "model" where it is
        replicated there and `model_split` (the computation is)."""
        over = self.tp if model_split and "tp" not in logical else ()
        for d, l in enumerate(logical):
            if l == "fsdp":
                w = self.mesh.all_gather(w, self.fsdp, d)
                over += tuple(a for a in self.dp if a not in self.fsdp)
                break
        else:
            over += self.dp
        return self.mesh.copy_to(w, over)

    def w(self, lp, name, model_split: bool = False):
        return self.use(lp[name], self.lspec[name], model_split)

    def kv(self, lp, name):
        """This rank's KV projection block of lp[name] (wk or wv): its own
        columns; with `rep` > 1 the columns of the one KV head its query
        heads use, all-gathered over "model" as FSDP gathers a layer (the
        gradient is reduce-scattered back to each rank's columns)."""
        w = self.w(lp, name)
        if self.rep == 1:
            return w
        dh = self.cfg.head_dim
        head = self.j // self.rep
        return self.mesh.all_gather(w, self.tp, 1)[:, head * dh:
                                                     (head + 1) * dh]

    def kv_whole(self, t):
        """Every KV head of this rank's (B, hkv, S, dh) k or v, gathered
        over "model" (one copy of each head when ranks share them)."""
        t = self.mesh.gather(t, self.tp, 1)
        return t[:, ::self.rep] if self.rep > 1 else t

    def enter(self, x):
        """The residual stream into a TP region: the sequence all-gathered
        over "model" (SP), or the replicated stream marked for f."""
        if self.sp:
            return self.mesh.all_gather(x, self.tp, 1)
        return self.mesh.copy_to(x, self.tp)

    def leave(self, x):
        """A TP region's partial sums out: reduce-scattered on the
        sequence (SP), or all-reduced (g)."""
        if self.sp:
            return self.mesh.reduce_scatter(x, self.tp, 1)
        return self.mesh.all_reduce(x, self.tp)


def _sh_embed(table, tokens, sh: _Sharded, leave: bool = True):
    """The vocab-parallel embedding: this rank's rows of the ids (JAX's
    wrap-and-clamp rule first), zeros for the others' rows, then summed
    over "model" (`leave`)."""
    cdt = sh.cfg.compute_dtype
    w = sh.use(table, ("tp", "fsdp" if sh.cfg.fsdp else None))
    vl = w.shape[0]
    v = vl * sh.tp_n
    ids = torch.where(tokens < 0, tokens + v, tokens).clamp(0, v - 1).long()
    local = ids - sh.j * vl
    hit = (local >= 0) & (local < vl)
    x = torch.where(hit[..., None], w[local.clamp(0, vl - 1)].to(cdt),
                    torch.zeros((), dtype=cdt, device=w.device))
    return sh.leave(x) if leave else sh.mesh.all_reduce(x, sh.tp)


def _sh_attention(xf, lp, sh: _Sharded, positions, impl):
    """This rank's heads: q, k, v through its columns of wq, wk, wv, the
    flash_attention kernel on them, then its rows of wo.  Returns (the
    partial sums over "model", the local heads' (k, v))."""
    cfg = sh.cfg
    h = cfg.n_heads // sh.tp_n
    q, k, v = _project_qkv(xf, sh.w(lp, "wq"), sh.kv(lp, "wk"),
                           sh.kv(lp, "wv"), h, sh.hkv, cfg, positions)

    def attn(q, k, v):
        return ops.flash_attention(q, k, v, causal=True, impl=impl,
                                   check_tiles=False)

    if cfg.remat_attn and torch.is_grad_enabled():
        o = checkpoint(attn, q, k, v, use_reentrant=False)
    else:
        o = attn(q, k, v)
    b, _, s, dh = o.shape
    out = o.transpose(1, 2).reshape(b, s, h * dh) @ sh.w(lp, "wo").to(
        cfg.compute_dtype)
    return out, (k, v)


def _sh_moe(x2d, lp, sh: _Sharded):
    """JAX's `_moe_ffn_shardmap` on rank (i, j): x2d holds data shard i's
    t_loc tokens (the same on every rank of the row).  Route them, C from
    t_loc; take experts [j E/tp, (j+1) E/tp) of the dispatch table, gather
    their slots, run their SwiGLU, add each token's slots back in expert
    order; plus this rank's columns of the shared experts.  Returns (the
    partial sums over "model", the aux loss from counts and probabilities
    summed over the mesh as JAX's psums sum them)."""
    cfg, mesh = sh.cfg, sh.mesh
    mcfg, cdt = cfg.moe, cfg.compute_dtype
    E, k, tp = mcfg.n_experts, mcfg.top_k, sh.tp_n
    dp = mesh.axis_size(sh.dp)
    # tokens replicated over dp: take a block (tokens too few to split, as
    # one sequence's decode step, run whole on every data shard)
    split = not sh.batch_split and dp > 1 and x2d.shape[0] % dp == 0
    if split:
        x2d = mesh.split(x2d, sh.dp, 0)
    t_loc, d = x2d.shape
    e_loc = E // tp
    probs, topi, topv = _route(x2d, {"router": sh.w(lp, "router", True)},
                               cfg)
    C = capacity(t_loc, mcfg)
    table, wtab, slots = _dispatch_tables(topi, topv, t_loc, E, C)
    rows = slice(sh.j * e_loc, (sh.j + 1) * e_loc)
    tbl = table.reshape(E, C)[rows]
    wt = wtab.reshape(E, C)[rows]
    xp = torch.cat([x2d, x2d.new_zeros(1, d)])
    experts = {n: sh.w(lp, n) for n in ("we_gate", "we_up", "we_down")}
    out = _expert_ffn(xp[tbl.long()], experts, cdt) * wt[..., None].to(cdt)
    n_loc = e_loc * C
    out = torch.cat([out.reshape(n_loc, d), out.new_zeros(1, d)])
    loc = slots - sh.j * n_loc
    loc = torch.where((loc >= 0) & (loc < n_loc), loc, n_loc)
    loc = torch.sort(loc, dim=1).values       # expert order, others last
    y = out[loc[:, 0]]
    for i in range(1, k):
        y = y + out[loc[:, i]]
    hs = F.silu(x2d @ sh.w(lp, "ws_gate").to(cdt)) * \
        (x2d @ sh.w(lp, "ws_up").to(cdt))
    y = y + hs @ sh.w(lp, "ws_down").to(cdt)
    counts = torch.zeros(E, device=x2d.device).index_add(
        0, topi.reshape(-1), torch.ones(t_loc * k, device=x2d.device))
    counts = mesh.all_reduce(mesh.all_reduce(counts / tp, sh.tp), sh.dp)
    psum = mesh.all_reduce(mesh.all_reduce(probs.sum(0) / tp, sh.tp), sh.dp)
    T = t_loc * dp
    aux = E * torch.sum(counts / (T * k) * (psum / T))
    if split:
        y = mesh.all_gather(y, sh.dp, 0)
    return y, aux


def _check_dispatch(sh: _Sharded):
    mcfg = sh.cfg.moe
    dp = sh.mesh.axis_size(sh.dp)
    if mcfg.dispatch == "shard_map" or dp == 1 or (
            mcfg.dispatch == "local" and mcfg.dp_shards == dp):
        return
    raise ValueError(
        f"on a mesh the MoE runs JAX's shard_map dispatch (each data "
        f"shard sorts its own tokens); dispatch {mcfg.dispatch!r} with "
        f"dp_shards {mcfg.dp_shards} over {dp} data shards sorts otherwise")


def _sh_ffn(xf, lp, sh: _Sharded):
    """The FFN of xf (B, S, D) on this rank: partial sums over "model"
    and the aux loss (0 for the dense SwiGLU)."""
    cdt = sh.cfg.compute_dtype
    if sh.cfg.moe is None:
        h = F.silu(xf @ sh.w(lp, "w_gate").to(cdt)) * \
            (xf @ sh.w(lp, "w_up").to(cdt))
        return (h @ sh.w(lp, "w_down").to(cdt),
                torch.zeros((), device=xf.device))
    _check_dispatch(sh)
    b, s, d = xf.shape
    y, aux = _sh_moe(xf.reshape(b * s, d), lp, sh)
    return y.reshape(b, s, d), aux


def _sh_layer(x, lp, sh: _Sharded, positions, impl):
    """One causal block on this rank: x is its (B/dp, S/tp if SP, D)
    block; returns (out, aux, the local heads' (k, v) over the whole
    sequence)."""
    xn = rms_norm(x, sh.w(lp, "ln1", sh.sp))
    a, kv = _sh_attention(sh.enter(xn), lp, sh, positions, impl)
    x = x + sh.leave(a)
    xn = rms_norm(x, sh.w(lp, "ln2", sh.sp))
    f, aux = _sh_ffn(sh.enter(xn), lp, sh)
    return x + sh.leave(f), aux, kv


def _sh_train_layer(x, lp, sh, positions, impl):
    return _sh_layer(x, lp, sh, positions, impl)[:2]


def _sh_forward(params, tokens, sh: _Sharded, impl):
    """`forward` on a mesh: tokens are this rank's dp block (B/dp, S);
    returns (its block of the final hidden states, the mean aux)."""
    cfg = sh.cfg
    if sh.sp and tokens.shape[1] % sh.tp_n:
        raise ValueError(f"sequence parallelism needs S = {tokens.shape[1]} "
                         f"to split over model = {sh.tp_n}")
    x = _sh_embed(params["embed"], tokens, sh)
    positions = torch.arange(tokens.shape[1], device=x.device).expand(
        tokens.shape)
    remat = cfg.remat and torch.is_grad_enabled()
    auxs = []
    for lp in params["layers"]:
        if remat:
            x, aux = checkpoint(_sh_train_layer, x, lp, sh, positions, impl,
                                use_reentrant=False)
        else:
            x, aux = _sh_train_layer(x, lp, sh, positions, impl)
        auxs.append(aux)
    h = rms_norm(x, sh.use(params["ln_f"], (None,), sh.sp))
    return h, torch.stack(auxs).mean()


def _sh_cross_entropy(h, w, labels, sh: _Sharded, n_chunks: int):
    """`cross_entropy_chunked` over vocab-parallel logits: h (B/dp, S, D)
    whole on the sequence, w this rank's (D, V/tp) columns; each chunk's
    max, sum of exponentials and gold logit are reduced over "model", so
    no rank holds a (T, V) block, and the sums over "dp"."""
    mesh = sh.mesh
    b, s, _ = h.shape
    if s % n_chunks:
        n_chunks = 1
    cs = s // n_chunks
    vl = w.shape[1]
    w32 = w.float()
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.int32, device=h.device)
    for c in range(n_chunks):
        logits = h[:, c * cs:(c + 1) * cs].float() @ w32
        ll = labels[:, c * cs:(c + 1) * cs]
        m = mesh.reduce(logits.detach().amax(-1), sh.tp,
                        dist.ReduceOp.MAX)
        se = mesh.all_reduce(torch.exp(logits - m[..., None]).sum(-1), sh.tp)
        lse = torch.log(se) + m
        li = ll.clamp(min=0).long() - sh.j * vl
        hit = (li >= 0) & (li < vl)
        gold = torch.gather(logits, -1, li.clamp(0, vl - 1)[..., None])
        gold = mesh.all_reduce(torch.where(hit, gold[..., 0], 0.0), sh.tp)
        valid = ll >= 0
        tot = tot + torch.where(valid, lse - gold, 0.0).sum()
        cnt = cnt + valid.sum(dtype=torch.int32)
    tot = mesh.all_reduce(tot, sh.dp)
    cnt = mesh.reduce(cnt, sh.dp)
    return tot / cnt.clamp(min=1)


def _sh_loss_fn(params, batch, sh: _Sharded, aux_weight, impl):
    cfg = sh.cfg
    h, aux = _sh_forward(params, batch["tokens"], sh, impl)
    unembed = sh.use(params["unembed"], ("fsdp" if cfg.fsdp else None,
                                         "tp")).to(cfg.compute_dtype)
    args = (sh.enter(h), unembed, batch["labels"], sh, cfg.loss_chunks)
    if cfg.remat_loss and torch.is_grad_enabled():
        ce = checkpoint(_sh_cross_entropy, *args, use_reentrant=False)
    else:
        ce = _sh_cross_entropy(*args)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


def _sh_logits(h, params, sh: _Sharded):
    """Whole logits (B, V) of h (B, D) replicated over "model": this
    rank's vocabulary columns, all-gathered."""
    cfg = sh.cfg
    u = sh.use(params["unembed"], ("fsdp" if cfg.fsdp else None, "tp"))
    return sh.mesh.gather(h @ u.to(cfg.compute_dtype), sh.tp, -1)


CACHE_LOGICAL = (None, "dp", None, "sp", None)   # JAX's `_cache_logical`
LONG_CACHE_LOGICAL = (None, None, None, "ep_all", None)   # long_500k


def _cache_axes(logical, mesh):
    """(batch axes, sequence axes) of a KV cache's logical spec (L, B, Hkv,
    S, dh); raises for a spec that shards another dimension."""
    spec = logical_to_spec(logical, mesh)
    if len(spec) != 5 or any(spec[i] is not None for i in (0, 2, 4)):
        raise ValueError(f"a KV cache shards its batch and sequence only, "
                         f"not {logical}")
    return mesh.axes(spec[1]), mesh.axes(spec[3])


def shard_kv_cache(cache, mesh, logical=CACHE_LOGICAL):
    """Each rank's block of a whole KV cache (`prefill`'s, or JAX's) under
    `logical`, as copies; the block records its spec as "logical"."""
    spec = logical_to_spec(logical, mesh)
    _cache_axes(logical, mesh)
    return {"k": local_block(cache["k"], spec, mesh).clone(),
            "v": local_block(cache["v"], spec, mesh).clone(),
            "length": int(cache["length"]), "logical": tuple(logical)}


def _sh_prefill(params, tokens, cfg: LMConfig, max_len, impl, mesh):
    """`prefill` on a mesh: tokens are this rank's dp block; the cache is
    its block under `CACHE_LOGICAL` (batch on "dp", sequence on "sp"):
    each layer's local heads' K and V all-gathered over "model" on the
    heads and cut to this rank's positions.  Returns whole logits."""
    sh = _Sharded(cfg, mesh)
    b, s = tokens.shape
    batch_axes, seq_axes = _cache_axes(CACHE_LOGICAL, mesh)
    n_seq = mesh.axis_size(seq_axes)
    if max_len % n_seq:
        raise ValueError(f"max_len {max_len} does not split over "
                         f"{seq_axes} = {n_seq}")
    if sh.sp and s % sh.tp_n:
        raise ValueError(f"sequence parallelism needs S = {s} to split "
                         f"over model = {sh.tp_n}")
    x = _sh_embed(params["embed"], tokens, sh)
    positions = torch.arange(s, device=x.device).expand(b, s)
    s_loc = max_len // n_seq
    lo = mesh.index(seq_axes) * s_loc
    shape = (cfg.n_layers, b, cfg.n_kv_heads, s_loc, cfg.head_dim)
    cache = {"k": torch.zeros(shape, dtype=cfg.compute_dtype,
                              device=x.device),
             "v": torch.zeros(shape, dtype=cfg.compute_dtype,
                              device=x.device),
             "length": s, "logical": CACHE_LOGICAL}
    n = max(min(s, lo + s_loc) - lo, 0)       # prompt positions held here
    for l, lp in enumerate(params["layers"]):
        x, _, kv = _sh_layer(x, lp, sh, positions, impl)
        for name, t in zip(("k", "v"), kv):   # every head, this block's
            cache[name][l, :, :, :n] = sh.kv_whole(t)[:, :, lo:lo + n]
    last = x[:, -1]
    if sh.sp:             # the last position is on the last model rank
        last = mesh.gather(last[:, None], sh.tp, 1)[:, -1]
    h = rms_norm(last, sh.use(params["ln_f"], (None,)))
    return _sh_logits(h, params, sh), cache


def _cp_attention(q, k_cache, v_cache, cache_len, lo, sh: _Sharded,
                  seq_axes):
    """Context-parallel decode attention: q (B, H, 1, dh) with every head,
    k/v_cache this rank's positions [lo, lo + S_loc) of every KV head.
    Each rank scores its positions in fp32 (K and V repeated over each GQA
    group, as `_cached_attention`), the max over the sequence axes is
    shared, and each rank's sum of exponentials and unnormalised output
    are summed there (a log-sum-exp merge)."""
    cfg, mesh = sh.cfg, sh.mesh
    group = cfg.n_heads // cfg.n_kv_heads
    kk = k_cache.repeat_interleave(group, dim=1).float()
    vv = v_cache.repeat_interleave(group, dim=1).float()
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk)
    scores = scores / math.sqrt(cfg.head_dim)
    pos = torch.arange(k_cache.shape[2], device=q.device) + lo
    scores = torch.where(pos < cache_len, scores, -math.inf)
    m = mesh.reduce(scores.amax(-1, keepdim=True), seq_axes,
                    dist.ReduceOp.MAX)
    p = torch.exp(scores - m)
    den = mesh.reduce(p.sum(-1, keepdim=True), seq_axes)
    num = mesh.reduce(torch.einsum("bhqk,bhkd->bhqd", p, vv), seq_axes)
    return (num / den).to(cfg.compute_dtype)


def _sh_decode_step(params, cache, tokens, cfg: LMConfig, mesh):
    """`decode_step` on a mesh with this rank's cache block under
    cache["logical"] (default: the whole cache on every rank).  The new
    token's K and V (every head, all-gathered over "model") are written
    on the rank that holds position `length`; attention is
    `_cp_attention` over the cache's sequence axes; the rest is TP.
    tokens: (B_loc, 1), the cache block's batch."""
    logical = cache.get("logical", (None,) * 5)
    batch_axes, seq_axes = _cache_axes(logical, mesh)
    dp = mesh.axes(LOGICAL_AXES["dp"])
    sh = _Sharded(cfg, mesh, batch_split=set(dp) <= set(batch_axes))
    cdt = cfg.compute_dtype
    b = tokens.shape[0]
    if cache["k"].shape[1] != b:
        raise ValueError(f"tokens hold {b} rows; the cache block holds "
                         f"{cache['k'].shape[1]}")
    pos = int(cache["length"])
    s_loc = cache["k"].shape[3]
    s_max = s_loc * mesh.axis_size(seq_axes)
    slot = min(pos, s_max - 1)
    lo = mesh.index(seq_axes) * s_loc
    mine = lo <= slot < lo + s_loc
    h = cfg.n_heads // sh.tp_n
    x = _sh_embed(params["embed"], tokens, sh, leave=False)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    for l, lp in enumerate(params["layers"]):
        xn = mesh.copy_to(rms_norm(x, sh.w(lp, "ln1")), sh.tp)
        q, kx, vx = _project_qkv(xn, sh.w(lp, "wq"), sh.kv(lp, "wk"),
                                 sh.kv(lp, "wv"), h, sh.hkv, cfg, positions)
        q, kx, vx = mesh.gather(q, sh.tp, 1), sh.kv_whole(kx), sh.kv_whole(vx)
        kc, vc = cache["k"][l], cache["v"][l]
        if mine:
            kc[:, :, slot - lo] = kx[:, :, 0].to(kc.dtype)
            vc[:, :, slot - lo] = vx[:, :, 0].to(vc.dtype)
        o = _cp_attention(q, kc, vc, pos + 1, lo, sh, seq_axes)
        o = o[:, sh.j * h:(sh.j + 1) * h].transpose(1, 2).reshape(
            b, 1, h * cfg.head_dim)
        x = x + mesh.all_reduce(o @ sh.w(lp, "wo").to(cdt), sh.tp)
        xn = mesh.copy_to(rms_norm(x, sh.w(lp, "ln2")), sh.tp)
        f, _ = _sh_ffn(xn, lp, sh)
        x = x + mesh.all_reduce(f, sh.tp)
    hid = rms_norm(x[:, 0], sh.use(params["ln_f"], (None,)))
    return (_sh_logits(hid, params, sh),
            {"k": cache["k"], "v": cache["v"], "length": pos + 1,
             "logical": tuple(logical)})


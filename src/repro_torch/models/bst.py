"""Behavior Sequence Transformer (Chen et al., arXiv:1905.06874; port of
`repro/models/bst.py`): huge sparse embedding tables -> a transformer over
the user's behaviour sequence plus the target item -> an MLP head, and
retrieval of the top-k of a candidate set for one pooled user vector.

Parameters are drawn on the device of the caller's `torch.Generator`.
The multi-hot profile fields are sum EmbeddingBags through
`kernels.ops.embedding_bag` with the caller's `impl`: under "auto" the
port's `segment_bag` CUDA kernel on a CUDA tensor and its plain version on
a CPU tensor, both with `kernels.ops.bag_backward` as the table's gradient
in `loss_fn`; "plain" that plain version anywhere.  The pool's attention
is JAX's `mha_ref` (non-causal), as PyTorch ops, since JAX runs no Pallas
kernel there.

Where the port and JAX part on purpose:
  * a multi-hot id past the concatenated multi-hot table adds nothing to
    its bag (the kernel's rule); JAX's `jnp.take` fills its row with NaN,
    so JAX's logit is NaN (ROADMAP.md Queue 3).  `data.recsys.bst_batch`
    never draws such ids;
  * `retrieval_step` computes only the behaviour-sequence half of the user
    tower, which is all it reads (XLA drops the other half under `jit`),
    so it launches no bag kernel;
  * ties in `retrieval_step` keep JAX's `lax.top_k` order, lowest index
    first (a stable descending sort; `torch.topk` orders ties otherwise).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
from repro_torch.nn.core import dense_init, embed_init, rms_norm



@dataclasses.dataclass(frozen=True)
class BSTConfig:
    name: str = "bst"
    embed_dim: int = 32
    seq_len: int = 20
    n_blocks: int = 1
    n_heads: int = 8
    mlp_dims: tuple = (1024, 512, 256)
    item_vocab: int = 4_194_304        # 2**22 rows — the huge sparse table
    n_profile_fields: int = 8          # single-hot categorical fields
    profile_vocab: int = 100_000
    n_multihot_fields: int = 2         # EmbeddingBag fields
    multihot_vocab: int = 500_000
    multihot_len: int = 16             # ids per bag (padded, -1 = empty)
    d_ff: int = 128
    param_dtype: Any = torch.float32


def init_params(generator: torch.Generator, cfg: BSTConfig):
    """Parameters drawn from `generator`, on its device
    (``torch.Generator("cuda")`` for the card), with JAX's structure and
    inits (not its values)."""
    d, dt = cfg.embed_dim, cfg.param_dtype
    dev = generator.device

    def dense(i, o):
        return dense_init(generator, i, o, dt)

    def table(rows):
        return embed_init(generator, rows, d, dt) * 0.02

    blocks = [{"wqkv": dense(d, 3 * d), "wo": dense(d, d),
               "w1": dense(d, cfg.d_ff), "w2": dense(cfg.d_ff, d),
               "ln1": torch.ones(d, dtype=dt, device=dev),
               "ln2": torch.ones(d, dtype=dt, device=dev)}
              for _ in range(cfg.n_blocks)]
    seq_total = cfg.seq_len + 1
    mlp_in = (seq_total + cfg.n_profile_fields + cfg.n_multihot_fields) * d
    dims = (mlp_in,) + tuple(cfg.mlp_dims) + (1,)
    mlp = [{"w": dense(a, b), "b": torch.zeros(b, dtype=dt, device=dev)}
           for a, b in zip(dims[:-1], dims[1:])]
    return {
        "item_embed": table(cfg.item_vocab),
        "pos_embed": table(seq_total),
        "profile_embed": table(cfg.n_profile_fields * cfg.profile_vocab),
        "multihot_embed": table(cfg.n_multihot_fields * cfg.multihot_vocab),
        "blocks": blocks,
        "mlp": mlp,
    }


def embedding_bag(table, ids, mode: str = "sum", impl: str = "auto"):
    """EmbeddingBag of ids (B, L), -1 pads, over table (V, D) -> (B, D):
    `kernels.ops.embedding_bag` with `impl` (the `segment_bag` kernel or its
    plain version, where ids outside [0, V) add nothing).  mode "mean"
    divides by the count of ids >= 0, at least 1, as JAX does."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', got {mode!r}")
    out = ops.embedding_bag(table, ids, impl=impl)
    if mode == "mean":
        cnt = (ids >= 0).sum(1, dtype=out.dtype)
        out = out / cnt.clamp(min=1.0)[:, None]
    return out


def _transformer_pool(params, seq_emb, cfg: BSTConfig):
    """seq_emb: (B, S+1, D) -> the same shape after n_blocks of post-norm
    MHA + FFN (BST uses one block)."""
    b, s, d = seq_emb.shape
    h = cfg.n_heads
    dh = d // h
    x = seq_emb
    for blk in params["blocks"]:
        q, k, v = (t.reshape(b, s, h, dh).transpose(1, 2)
                   for t in (x @ blk["wqkv"]).chunk(3, dim=-1))
        o = ref.mha_ref(q, k, v, causal=False)
        o = o.transpose(1, 2).reshape(b, s, d) @ blk["wo"]
        x = rms_norm(x + o, blk["ln1"])
        f = F.relu(x @ blk["w1"]) @ blk["w2"]
        x = rms_norm(x + f, blk["ln2"])
    return x


def _seq_tower(params, batch, cfg: BSTConfig):
    """The behaviour sequence plus the target item through the pool:
    (B, (S+1) * D)."""
    seq_ids = torch.cat([batch["hist_items"], batch["target_item"][:, None]],
                        dim=1)
    seq = params["item_embed"][seq_ids.long()] + params["pos_embed"][None]
    seq = _transformer_pool(params, seq, cfg)
    return seq.reshape(seq.shape[0], -1)


def _profile_tower(params, batch, cfg: BSTConfig, impl: str = "auto"):
    """The single-hot profile fields (one gather over the concatenated
    table) and the multi-hot bags, one bag call a field: (B, (F + F2) * D)."""
    pids = batch["profile_ids"]
    b = pids.shape[0]
    offsets = torch.arange(cfg.n_profile_fields, device=pids.device)
    prof = params["profile_embed"][(pids + offsets * cfg.profile_vocab)
                                   .long()]                     # (B, F, D)
    bags = []
    for f in range(cfg.n_multihot_fields):
        ids = batch["multihot_ids"][:, f]                       # (B, L)
        ids = torch.where(ids >= 0, ids + f * cfg.multihot_vocab, -1)
        bags.append(embedding_bag(params["multihot_embed"], ids, impl=impl))
    bag = torch.stack(bags, dim=1)                              # (B, F2, D)
    return torch.cat([prof.reshape(b, -1), bag.reshape(b, -1)], dim=-1)


def user_tower(params, batch, cfg: BSTConfig, impl: str = "auto"):
    """Everything but the final MLP: (seq_repr (B, (S+1)*D), profile_repr
    (B, (F + F2)*D)).  batch: tensors on one device (`hist_items` (B, S),
    `target_item` (B,), `profile_ids` (B, F), `multihot_ids` (B, F2, L))."""
    return (_seq_tower(params, batch, cfg),
            _profile_tower(params, batch, cfg, impl))


def forward(params, batch, cfg: BSTConfig, impl: str = "auto"):
    """CTR logits (B,)."""
    x = torch.cat(user_tower(params, batch, cfg, impl), dim=-1)
    for i, layer in enumerate(params["mlp"]):
        x = x @ layer["w"] + layer["b"]
        if i < len(params["mlp"]) - 1:
            x = F.leaky_relu(x, 0.1)
    return x[:, 0]


def loss_fn(params, batch, cfg: BSTConfig, impl: str = "auto"):
    """Mean logistic loss of the CTR logits against batch["labels"] (B,)
    in {0, 1}, in the stable form max(z, 0) - z y + log1p(exp(-|z|)), and
    the share of logits on the label's side of 0 ("acc").  Returns (loss,
    {"acc"})."""
    logits = forward(params, batch, cfg, impl)
    y = batch["labels"].float()
    loss = torch.mean(torch.maximum(logits, torch.zeros_like(logits))
                      - logits * y + torch.log1p(torch.exp(-logits.abs())))
    acc = ((logits > 0) == (y > 0.5)).float().mean()
    return loss, {"acc": acc}


def retrieval_step(params, batch, cfg: BSTConfig, top_k: int = 100):
    """Score each user against its candidates (batch["candidates"] (B, N)
    item ids): the pooled user vector from the behaviour sequence, a
    batched dot with the candidates' embeddings, the top k.  Returns
    (scores (B, k), candidate ids (B, k)), ties lowest index first."""
    seq_r = _seq_tower(params, batch, cfg)
    b = seq_r.shape[0]
    u = seq_r.reshape(b, cfg.seq_len + 1, cfg.embed_dim).mean(dim=1)
    cand = params["item_embed"][batch["candidates"].long()]    # (B, N, D)
    scores = torch.einsum("bd,bnd->bn", u, cand)
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :top_k], idx[:, :top_k]
    return vals, torch.gather(batch["candidates"], 1, idx)

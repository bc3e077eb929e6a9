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

On a mesh (`runtime.meshctx.use_mesh`), `forward`, `loss_fn` and
`retrieval_step` take each rank's blocks of JAX's layout
(`param_logical_specs`, `shard_params`) and run it with explicit
collectives: the three tables are row-sharded over "model", each rank
looking up its own rows (other ids give 0; a bag shifts its ids by the
rank's first row, and the kernel skips the ones outside its rows) and the
lookups summed over "model"; the batch is split over "dp" (JAX's two
`constrain` sites); the MLP's first weight is column-parallel on ("fsdp",
"tp"), gathered over "data", and the second layer row-parallel on its
replicated weight; retrieval splits the candidates over "fsdp" and takes
the top k of the ranks' top ks.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
from repro_torch.nn.core import dense_init, embed_init, rms_norm
from repro_torch.runtime.meshctx import (LOGICAL_AXES, gather_blocks,
                                         get_current_mesh, local_block,
                                         logical_to_spec)
from repro_torch.tree import tree_map


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


def init_params(generator: torch.Generator, cfg: BSTConfig, device=None):
    """Parameters drawn from `generator`, on its device
    (``torch.Generator("cuda")`` for the card) unless `device` names
    another (``"meta"``: shapes only), with JAX's structure and inits (not
    its values)."""
    d, dt = cfg.embed_dim, cfg.param_dtype
    dev = generator.device if device is None else torch.device(device)

    def dense(i, o):
        return dense_init(generator, i, o, dt, device=dev)

    def table(rows):
        return embed_init(generator, rows, d, dt, device=dev) * 0.02

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


class _Sh:
    """Where BST's parameters and batch live: whole in this process (no
    mesh: every collective returns its input and a lookup is a plain row
    gather), or each rank's blocks of JAX's layout on `mesh`."""

    def __init__(self, mesh=None):
        self.mesh = mesh
        if mesh is not None:
            self.dp = mesh.axes(LOGICAL_AXES["dp"])
            self.fsdp = mesh.axes(LOGICAL_AXES["fsdp"])
            self.tp = mesh.axes(LOGICAL_AXES["tp"])

    def use(self, w, logical):
        """A parameter block ready to use: all-gathered over "data" on its
        fsdp dim, its gradient summed over the dp axes it is replicated
        over (the batch is split there)."""
        if self.mesh is None:
            return w
        over = self.dp
        for d, l in enumerate(logical):
            if l == "fsdp":
                w = self.mesh.all_gather(w, self.fsdp, d)
                over = tuple(a for a in self.dp if a not in self.fsdp)
        return self.mesh.copy_to(w, over)

    def first_row(self, rows):
        """The global id of this rank's first row of a ("tp", None) table
        whose block has `rows` rows."""
        return 0 if self.mesh is None else self.mesh.index(self.tp) * rows

    def lookup(self, table, ids):
        """A ("tp", None) table's rows at global `ids`: on a mesh this
        rank's rows, 0 for the others' (summed over "model" by `sum`)."""
        w = self.use(table, ("tp", None))
        if self.mesh is None:
            return w[ids.long()]
        local = ids.long() - self.first_row(w.shape[0])
        hit = (local >= 0) & (local < w.shape[0])
        return torch.where(hit[..., None],
                           w[local.clamp(0, w.shape[0] - 1)], 0.0)

    def sum(self, x):
        """The sum over "model" of a partial whose consumer is the same on
        every rank of it."""
        return x if self.mesh is None else self.mesh.all_reduce(x, self.tp)

    def copy(self, x):
        """x, its gradient summed over "model" (Megatron's f)."""
        return x if self.mesh is None else self.mesh.copy_to(x, self.tp)

    def split(self, x, dim):
        """This rank's block of x on `dim` over "model"."""
        return x if self.mesh is None else self.mesh.split(x, self.tp, dim)

    def mean(self, x, grad=True):
        """The batch's mean of per-example x, the same on every rank."""
        if self.mesh is None:
            return x.mean() if grad else x.detach().mean()
        n = x.shape[0] * self.mesh.axis_size(self.dp)
        if grad:
            return self.mesh.all_reduce(x.sum(), self.dp) / n
        return self.mesh.reduce(x.sum().detach(), self.dp) / n


def _seq_tower(params, batch, cfg: BSTConfig, sh: _Sh):
    """The behaviour sequence plus the target item through the pool:
    (B, (S+1) * D)."""
    seq_ids = torch.cat([batch["hist_items"], batch["target_item"][:, None]],
                        dim=1)
    seq = sh.sum(sh.lookup(params["item_embed"], seq_ids))
    seq = seq + sh.use(params["pos_embed"], (None, None))[None]
    pool = {"blocks": [{k: sh.use(v, (None,) * v.ndim) for k, v in
                        blk.items()} for blk in params["blocks"]]}
    seq = _transformer_pool(pool, seq, cfg)
    return seq.reshape(seq.shape[0], -1)


def _profile_tower(params, batch, cfg: BSTConfig, impl: str, sh: _Sh):
    """The single-hot profile fields (one gather over the concatenated
    table) and the multi-hot bags, one bag call a field, the bags' ids
    shifted by this rank's first row: (B, (F + F2) * D)."""
    pids = batch["profile_ids"]
    b = pids.shape[0]
    offsets = torch.arange(cfg.n_profile_fields, device=pids.device)
    prof = sh.lookup(params["profile_embed"],
                     pids + offsets * cfg.profile_vocab)       # (B, F, D)
    w = sh.use(params["multihot_embed"], ("tp", None))
    lo = sh.first_row(w.shape[0])
    bags = []
    for f in range(cfg.n_multihot_fields):
        ids = batch["multihot_ids"][:, f]                       # (B, L)
        ids = torch.where(ids >= 0, ids + (f * cfg.multihot_vocab - lo), -1)
        bags.append(embedding_bag(w, ids, impl=impl))           # own rows
    bag = torch.stack(bags, dim=1)                              # (B, F2, D)
    return sh.sum(torch.cat([prof.reshape(b, -1), bag.reshape(b, -1)],
                            dim=-1))


def user_tower(params, batch, cfg: BSTConfig, impl: str = "auto"):
    """Everything but the final MLP: (seq_repr (B, (S+1)*D), profile_repr
    (B, (F + F2)*D)).  batch: tensors on one device (`hist_items` (B, S),
    `target_item` (B,), `profile_ids` (B, F), `multihot_ids` (B, F2, L))."""
    sh = _Sh(get_current_mesh())
    return (_seq_tower(params, batch, cfg, sh),
            _profile_tower(params, batch, cfg, impl, sh))


def forward(params, batch, cfg: BSTConfig, impl: str = "auto"):
    """CTR logits (B,); on a mesh this rank's (B/dp,) block of them.  On a
    mesh the MLP's first layer is column-parallel over "model" and its
    second row-parallel; the rest run whole."""
    x = torch.cat(user_tower(params, batch, cfg, impl), dim=-1)
    sh = _Sh(get_current_mesh())
    mlp = params["mlp"]
    x = sh.copy(x)
    for i, layer in enumerate(mlp):
        w = sh.use(layer["w"], ("fsdp", "tp") if i == 0 else (None, None))
        bias = sh.use(layer["b"], (None,))
        if i == 0:
            x = x @ w + sh.split(bias, 0)
        elif i == 1:
            x = sh.sum(x @ sh.split(w, 0)) + bias
        else:
            x = x @ w + bias
        if i < len(mlp) - 1:
            x = F.leaky_relu(x, 0.1)
    return x[:, 0]


def loss_fn(params, batch, cfg: BSTConfig, impl: str = "auto"):
    """Mean logistic loss of the CTR logits against batch["labels"] (B,)
    in {0, 1}, in the stable form max(z, 0) - z y + log1p(exp(-|z|)), and
    the share of logits on the label's side of 0 ("acc").  Returns (loss,
    {"acc"}); on a mesh the batch's means, the same on every rank."""
    logits = forward(params, batch, cfg, impl)
    y = batch["labels"].float()
    per = (torch.maximum(logits, torch.zeros_like(logits)) - logits * y
           + torch.log1p(torch.exp(-logits.abs())))
    hit = ((logits > 0) == (y > 0.5)).float()
    sh = _Sh(get_current_mesh())
    return sh.mean(per), {"acc": sh.mean(hit, grad=False)}


def retrieval_step(params, batch, cfg: BSTConfig, top_k: int = 100):
    """Score each user against its candidates (batch["candidates"] (B, N)
    item ids): the pooled user vector from the behaviour sequence, a
    batched dot with the candidates' embeddings, the top k.  Returns
    (scores (B, k), candidate ids (B, k)), ties lowest index first.  On a
    mesh the candidates are this rank's (B, N/fsdp) block and the result
    is the whole top k, the same on every rank."""
    sh = _Sh(get_current_mesh())
    seq_r = _seq_tower(params, batch, cfg, sh)
    b = seq_r.shape[0]
    u = seq_r.reshape(b, cfg.seq_len + 1, cfg.embed_dim).mean(dim=1)
    cand = sh.sum(sh.lookup(params["item_embed"], batch["candidates"]))
    scores = torch.einsum("bd,bnd->bn", u, cand)                # (B, N)
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    vals, ids = vals[:, :top_k], torch.gather(batch["candidates"], 1,
                                              idx[:, :top_k])
    if sh.mesh is None:
        return vals, ids
    # the ranks' top ks in block order: a stable sort keeps ties in
    # global candidate order, as `lax.top_k` does
    vals, ids = (sh.mesh.gather(vals, sh.fsdp, 1),
                 sh.mesh.gather(ids, sh.fsdp, 1))
    vals, idx = torch.sort(vals, dim=1, descending=True, stable=True)
    return vals[:, :top_k], torch.gather(ids, 1, idx[:, :top_k])


# --- on a mesh (runtime.meshctx) ------------------------------------------


def param_logical_specs(cfg: BSTConfig):
    """Logical spec tree matching `init_params` (JAX's
    `param_logical_specs`): the three tables row-sharded on "tp", the MLP's
    first weight on ("fsdp", "tp"), everything else replicated."""
    block = {"wqkv": (None, None), "wo": (None, None),
             "w1": (None, None), "w2": (None, None),
             "ln1": (None,), "ln2": (None,)}
    return {
        "item_embed": ("tp", None),       # row-sharded huge table
        "pos_embed": (None, None),
        "profile_embed": ("tp", None),
        "multihot_embed": ("tp", None),
        "blocks": [dict(block) for _ in range(cfg.n_blocks)],
        "mlp": [{"w": ("fsdp", "tp"), "b": (None,)},
                ] + [{"w": (None, None), "b": (None,)}
                     for _ in cfg.mlp_dims],
    }


def shard_params(params, cfg: BSTConfig, mesh):
    """Each rank's own blocks of the whole parameters under
    `param_logical_specs` on `mesh`, as copies."""
    return tree_map(lambda t, spec: local_block(
        t, logical_to_spec(spec, mesh), mesh).clone(), params,
        param_logical_specs(cfg))


def unshard_params(params, cfg: BSTConfig, mesh):
    """The whole parameters from every rank's blocks (no autograd)."""
    return tree_map(lambda t, spec: gather_blocks(
        t, logical_to_spec(spec, mesh), mesh), params,
        param_logical_specs(cfg))

"""GNN substrate (port of `repro/models/gnn.py`): GAT, SchNet, MeshGraphNet,
DimeNet.

All message passing is edge-list gathers and segment sums / maxes over a
padded graph batch, as in JAX, with PyTorch ops: `index_select` for a
gather, `index_add_` for `jax.ops.segment_sum` and `index_reduce_("amax")`
for `jax.ops.segment_max`.  No kernel of `repro_torch.kernels` runs here:
JAX's module reaches no Pallas kernel either.

Batch layout (a dict of tensors on one device, plus the int `n_graphs`;
-pads masked):
  node_feat (N, F) | positions (N, 3) | senders/receivers (E,)
  node_mask (N,) | edge_mask (E,) | graph_ids (N,) | labels
  edge_feat (E, F_e)        — MeshGraphNet only
  triplet_src/dst/mask (T,) — DimeNet only: edge-pair (k->j, j->i) lists
Padded edges point at node N-1 with edge_mask=0 and contribute zeros.

Ids follow JAX's index rules (checked once an apply, one host read an id
list; copied only when one is out of range): a gather wraps a negative id
once and clamps to [0, n - 1]; a segment sum or max drops an id outside
[0, n).

Parameters are drawn from the caller's `torch.Generator`, on its device,
with JAX's structure and inits (not its values), except that
MeshGraphNet's layers are a list of per-layer dicts where JAX stacks them
for its scan (`interop.gnn_params_from_jax` splits JAX's stacks).  JAX's
`jax.checkpoint`s (MeshGraphNet's layer, DimeNet's triplet chunks) become
`torch.utils.checkpoint` while gradients are on.

Where the port and JAX part on purpose: `segment_softmax`'s segment max
carries no gradient (the softmax does not depend on it; JAX's gradient
through it sums to zero up to rounding).

On a mesh (`runtime.meshctx.use_mesh`), as JAX's cells shard a graph
(`repro/launch/cells.py:217-230`), every node, edge and triplet array is
split into equal blocks over every mesh axis ("ep_all"; the cells pad
them to multiples of 512), ids stay global, per-graph arrays and the
parameters are whole on every rank.  The shared primitives carry the
sharding (`_Graph`), so one change covers the four models: a gather of
node (or edge) rows all-gathers the array, a segment sum is a
reduce-scatter into this rank's block, the softmax's segment max an
all-reduce max, per-graph sums and the loss's sums all-reduces, and each
parameter enters through `copy_to`, its gradient summed over every rank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.steepest import gather_ids
from repro_torch.nn.core import dense_init
from repro_torch.runtime.meshctx import get_current_mesh
from repro_torch.tree import tree_map


# --- ids and segment ops -------------------------------------------------------


def _ids(ids: torch.Tensor, n: int):
    """(gather ids, segment ids) of `ids` on an axis of n: `ids` itself
    twice when every id lies in [0, n); else the ids as JAX's gather reads
    them (`gather_ids`) and the ids with every one outside [0, n) moved to
    n, the row `segment_sum` drops."""
    g = gather_ids(ids, n) if n else ids
    if g is ids:
        return ids, ids
    return g, torch.where((ids >= 0) & (ids < n), ids, n)


def segment_sum(data: torch.Tensor, segments: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """`jax.ops.segment_sum` for segment ids from `_ids` (in [0, n], row n
    dropped): (num_segments, ...) sums of `data`'s rows, in data's dtype."""
    out = data.new_zeros((num_segments + 1,) + tuple(data.shape[1:]))
    return out.index_add_(0, segments, data)[:num_segments]


class _Graph:
    """Where a graph's arrays live: whole in this process (no mesh), or
    each rank's block of every node, edge and triplet array on `mesh`
    (split over all its axes, block r on rank r; ids global)."""

    def __init__(self, mesh=None):
        self.mesh = mesh
        self.parts = mesh.size if mesh is not None else 1

    def whole(self, x):
        """Every rank's block of x, in rank order (all-gather; its
        gradient reduce-scattered)."""
        if self.mesh is None:
            return x
        return self.mesh.all_gather(x, self.mesh.axis_names, 0)

    def scatter(self, x):
        """This rank's block of the sum of every rank's whole `x`
        (reduce-scatter; its gradient all-gathered)."""
        if self.mesh is None:
            return x
        return self.mesh.reduce_scatter(x, self.mesh.axis_names, 0)

    def segment_sum(self, data, segments, n):
        """`segment_sum` into n global segments: this rank's block of the
        sums over every rank's rows."""
        return self.scatter(segment_sum(data, segments, n))

    def max(self, x):
        """Elementwise max over the ranks (no gradient)."""
        if self.mesh is None:
            return x
        return self.mesh.reduce(x, self.mesh.axis_names, dist.ReduceOp.MAX)

    def sum(self, x):
        """The sum over the ranks of a partial whose consumer is the same
        on every rank (Megatron's g)."""
        if self.mesh is None:
            return x
        return self.mesh.all_reduce(x, self.mesh.axis_names)

    def count(self, x):
        """A count summed over the ranks (no gradient)."""
        if self.mesh is None:
            return x
        return self.mesh.reduce(x.detach(), self.mesh.axis_names)

    def params(self, params):
        """Whole parameters, each gradient summed over every rank."""
        if self.mesh is None:
            return params
        return tree_map(lambda p: self.mesh.copy_to(p, self.mesh.axis_names),
                        params)


def _softmax(logits, gather, segments, n, mask, G=_Graph()):
    """segment_softmax of (E, ...) logits, ids from `_ids`."""
    if mask is not None:
        mask = mask.reshape(mask.shape + (1,) * (logits.ndim - 1))
        logits = logits.masked_fill(~mask, -1e30)
    with torch.no_grad():
        mx = logits.new_full((n + 1,) + tuple(logits.shape[1:]), -math.inf)
        mx = G.max(mx.index_reduce_(0, segments, logits, "amax")[:n])
        mx = torch.nan_to_num(mx, neginf=0.0)
    e = torch.exp(logits - mx.index_select(0, gather))
    if mask is not None:
        e = e.masked_fill(~mask, 0.0)
    den = G.whole(G.segment_sum(e, segments, n))
    return e / torch.clamp(den.index_select(0, gather), min=1e-20)


def segment_softmax(logits, segments, num_segments, mask=None):
    """Numerically-stable softmax of edge logits grouped by receiver.
    logits: (E,) or (E, H), softmaxed over the edges of each segment, every
    trailing column apart; mask: (E,) bool, masked edges get 0.  A segment
    with no edge has max -inf, read as 0 (JAX's `nan_to_num`); one whose
    edges are all masked has max -1e30 and gives 0."""
    gather, seg = _ids(segments, num_segments)
    return _softmax(logits, gather, seg, num_segments, mask)


def _mlp_init(generator, dims, dtype=torch.float32, device=None):
    device = generator.device if device is None else device
    return [{"w": dense_init(generator, i, o, dtype, device=device),
             "b": torch.zeros(o, dtype=dtype, device=device)}
            for i, o in zip(dims[:-1], dims[1:])]


def _mlp(params, x, act=F.relu, final_act=False):
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1 or final_act:
            x = act(x)
    return x


_LOG2 = math.log(2.0)


def shifted_softplus(x):
    """softplus(x) - log 2, softplus as `jax.nn.softplus`'s
    logaddexp(x, 0)."""
    return torch.logaddexp(x, x.new_zeros(())) - _LOG2


def _species_embed(params, graph, n_species):
    species = graph["node_feat"].to(torch.int32).reshape(-1)
    return params["embed"][species.clamp(0, n_species - 1)]


def _energies(atom_e, graph, G):
    """Per-graph sums of the masked per-atom energies (n_graphs,)."""
    atom_e = torch.where(graph["node_mask"], atom_e, 0.0)
    seg = _ids(graph["graph_ids"], graph["n_graphs"])[1]
    return G.sum(segment_sum(atom_e, seg, graph["n_graphs"]))


def _norm(v):
    """Euclidean norm over the last axis, sqrt of the sum of squares."""
    return torch.sqrt(torch.sum(v * v, dim=-1))


def _remat(fn, *args):
    """fn(*args), recomputed in the backward pass while gradients are on
    (JAX's `jax.checkpoint`)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# --- GAT (Velickovic et al., arXiv:1710.10903) -------------------------------


@dataclasses.dataclass(frozen=True)
class GATConfig:
    name: str = "gat-cora"
    n_layers: int = 2
    d_hidden: int = 8
    n_heads: int = 8
    d_in: int = 1433
    n_classes: int = 7
    arch: str = "gat"


def gat_init(generator, cfg: GATConfig, device=None):
    layers = []
    d_in = cfg.d_in
    for i in range(cfg.n_layers):
        heads = cfg.n_heads
        d_out = cfg.d_hidden if i < cfg.n_layers - 1 else cfg.n_classes
        layers.append({
            "w": dense_init(generator, d_in, heads * d_out, device=device),
            # (heads, d_out)
            "a_src": dense_init(generator, d_out, heads,
                                device=device).T.contiguous(),
            "a_dst": dense_init(generator, d_out, heads,
                                device=device).T.contiguous(),
        })
        d_in = heads * d_out if i < cfg.n_layers - 1 else d_out
    return {"layers": layers}


def gat_apply(params, graph, cfg: GATConfig, G=_Graph()):
    x = graph["node_feat"]
    nl = x.shape[0]
    n = nl * G.parts
    snd = _ids(graph["senders"], n)[0]
    rcv, rcv_seg = _ids(graph["receivers"], n)
    emask = graph["edge_mask"]
    for i, lp in enumerate(params["layers"]):
        heads = cfg.n_heads
        d_out = lp["a_src"].shape[1]
        h = (x @ lp["w"]).reshape(nl, heads, d_out)
        att_s = (h * lp["a_src"]).sum(-1)                         # (N, H)
        att_d = (h * lp["a_dst"]).sum(-1)
        logits = F.leaky_relu(G.whole(att_s).index_select(0, snd)
                              + G.whole(att_d).index_select(0, rcv),
                              0.2)                                # (E, H)
        alpha = _softmax(logits, rcv, rcv_seg, n, emask, G)
        msg = G.whole(h).index_select(0, snd) * alpha[..., None]
        agg = G.segment_sum(msg.masked_fill(~emask[:, None, None], 0.0),
                            rcv_seg, n)
        if i < cfg.n_layers - 1:
            x = F.elu(agg).reshape(nl, heads * d_out)
        else:
            x = agg.mean(dim=1)  # average heads on the output layer
    return x


# --- SchNet (Schutt et al., arXiv:1706.08566) --------------------------------


@dataclasses.dataclass(frozen=True)
class SchNetConfig:
    name: str = "schnet"
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0
    n_species: int = 32
    arch: str = "schnet"


def schnet_init(generator, cfg: SchNetConfig, device=None):
    d = cfg.d_hidden
    device = generator.device if device is None else device
    embed = torch.randn((cfg.n_species, d), generator=generator,
                        device=device) * 0.1
    inter = [{"filter": _mlp_init(generator, [cfg.n_rbf, d, d],
                                  device=device),
              "in_dense": dense_init(generator, d, d, device=device),
              "out": _mlp_init(generator, [d, d, d], device=device)}
             for _ in range(cfg.n_interactions)]
    return {"embed": embed, "inter": inter,
            "readout": _mlp_init(generator, [d, d // 2, 1], device=device)}


def _centres(stop: float, num: int, device):
    """`jnp.linspace(0, stop, num)` in float32 as XLA computes it:
    i * (stop * (1 / (num - 1))), each operation rounded to float32, then
    `stop` itself.  (`torch.linspace` differs in the last bit of 124 of
    SchNet's 300 centres, and gamma = 30 widens the gap.)"""
    f32 = dict(dtype=torch.float32, device=device)
    step = torch.tensor(stop, **f32) * (torch.tensor(1.0, **f32) / (num - 1))
    return torch.cat([torch.arange(num - 1, **f32) * step,
                      torch.tensor([stop], **f32)])


def _gaussian_rbf(d, n_rbf, cutoff):
    mu = _centres(cutoff, n_rbf, d.device)
    gamma = n_rbf / cutoff
    return torch.exp(-gamma * (d[:, None] - mu[None, :]) ** 2)


def schnet_apply(params, graph, cfg: SchNetConfig, G=_Graph()):
    """Returns per-graph energies (n_graphs,)."""
    h = _species_embed(params, graph, cfg.n_species)
    n = h.shape[0] * G.parts
    pos = G.whole(graph["positions"])
    snd = _ids(graph["senders"], n)[0]
    rcv, rcv_seg = _ids(graph["receivers"], n)
    emask = graph["edge_mask"]
    dist = _norm(pos.index_select(0, snd) - pos.index_select(0, rcv) + 1e-12)
    rbf = _gaussian_rbf(dist, cfg.n_rbf, cfg.cutoff)
    for lp in params["inter"]:
        w = _mlp(lp["filter"], rbf, act=shifted_softplus, final_act=True)
        hx = G.whole(h @ lp["in_dense"])
        msg = (hx.index_select(0, snd) * w).masked_fill(~emask[:, None], 0.0)
        agg = G.segment_sum(msg, rcv_seg, n)
        h = h + _mlp(lp["out"], agg, act=shifted_softplus)
    atom_e = _mlp(params["readout"], h, act=shifted_softplus)[:, 0]
    return _energies(atom_e, graph, G)


# --- MeshGraphNet (Pfaff et al., arXiv:2010.03409) ---------------------------


@dataclasses.dataclass(frozen=True)
class MGNConfig:
    """`scan_unroll` is JAX's unroll of its layer scan (roofline tooling);
    the port runs its layers in a Python loop and ignores it."""
    name: str = "meshgraphnet"
    n_layers: int = 15
    d_hidden: int = 128
    mlp_layers: int = 2
    d_node_in: int = 8
    d_edge_in: int = 4
    d_out: int = 3
    arch: str = "meshgraphnet"
    scan_unroll: int = 1


def _mgn_mlp_dims(cfg, d_in):
    return [d_in] + [cfg.d_hidden] * cfg.mlp_layers


def mgn_init(generator, cfg: MGNConfig, device=None):
    d = cfg.d_hidden

    def mlp(dims):
        return _mlp_init(generator, dims, device=device)

    return {
        "node_enc": mlp(_mgn_mlp_dims(cfg, cfg.d_node_in)),
        "edge_enc": mlp(_mgn_mlp_dims(cfg, cfg.d_edge_in)),
        "layers": [{"edge_mlp": mlp(_mgn_mlp_dims(cfg, 3 * d)),
                    "node_mlp": mlp(_mgn_mlp_dims(cfg, 2 * d))}
                   for _ in range(cfg.n_layers)],
        "decoder": mlp([d, d, cfg.d_out]),
    }


def mgn_apply(params, graph, cfg: MGNConfig, G=_Graph()):
    """Returns per-node predictions (N, d_out)."""
    n = graph["node_feat"].shape[0] * G.parts
    snd = _ids(graph["senders"], n)[0]
    rcv, rcv_seg = _ids(graph["receivers"], n)
    emask = graph["edge_mask"][:, None]
    h = _mlp(params["node_enc"], graph["node_feat"], final_act=True)
    e = _mlp(params["edge_enc"], graph["edge_feat"], final_act=True)

    def body(h, e, lp):
        hw = G.whole(h)
        e_in = torch.cat([e, hw.index_select(0, snd),
                          hw.index_select(0, rcv)], dim=-1)
        e = e + _mlp(lp["edge_mlp"], e_in, final_act=True)
        agg = G.segment_sum(e.masked_fill(~emask, 0.0), rcv_seg, n)
        h = h + _mlp(lp["node_mlp"], torch.cat([h, agg], dim=-1),
                     final_act=True)
        return h, e

    for lp in params["layers"]:
        h, e = _remat(body, h, e, lp)
    return _mlp(params["decoder"], h)


# --- DimeNet (Gasteiger et al., arXiv:2003.03123) ----------------------------


@dataclasses.dataclass(frozen=True)
class DimeNetConfig:
    name: str = "dimenet"
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    cutoff: float = 5.0
    n_species: int = 32
    arch: str = "dimenet"
    # §Perf knobs: chunk the triplet gather (bounds the (T, b, d) live set)
    # and carry the triplet messages in `msg_dtype` (a torch dtype)
    triplet_chunks: int = 1
    msg_dtype: Any = torch.float32


def dimenet_init(generator, cfg: DimeNetConfig, device=None):
    d = cfg.d_hidden
    n_sbf = cfg.n_spherical * cfg.n_radial
    device = generator.device if device is None else device

    def dense(i, o):
        return dense_init(generator, i, o, device=device)

    def mlp(dims):
        return _mlp_init(generator, dims, device=device)

    embed = torch.randn((cfg.n_species, d), generator=generator,
                        device=device) * 0.1
    edge_emb = mlp([2 * d + cfg.n_radial, d])
    blocks = [{"w_rbf": dense(cfg.n_radial, d),
               "w_sbf": dense(n_sbf, cfg.n_bilinear),
               "w_kj": dense(d, cfg.n_bilinear * d),
               "msg_mlp": mlp([d, d, d]),
               "out_mlp": mlp([d, d, d])}
              for _ in range(cfg.n_blocks)]
    return {
        "embed": embed,
        "edge_emb": edge_emb,
        "blocks": blocks,
        "out_rbf": dense(cfg.n_radial, d),
        "readout": mlp([d, d // 2, 1]),
    }


def _bessel_rbf(d, n_radial, cutoff):
    """Radial Bessel basis (DimeNet eq. 7): sin(n pi d / c) / d."""
    freq = math.pi * torch.arange(1, n_radial + 1, dtype=torch.float32,
                                  device=d.device)
    dc = torch.clamp(d / cutoff, 1e-6, 1.0)
    # jnp.sqrt of the python float: a float32 sqrt of float32(2 / cutoff)
    scale = torch.sqrt(torch.tensor(2.0 / cutoff, dtype=torch.float32,
                                    device=d.device))
    return scale * torch.sin(freq * dc[:, None]) / (dc[:, None] * cutoff)


def _angular_sbf(angle, d, n_spherical, n_radial, cutoff):
    """Simplified spherical basis: cos(l * angle) x Bessel(d) outer basis
    (the full 2D spherical Bessel solution is replaced by a separable
    Fourier x Bessel product — documented deviation, same tensor shapes)."""
    ls = torch.arange(n_spherical, dtype=torch.float32, device=angle.device)
    ang = torch.cos(ls[None, :] * angle[:, None])
    rad = _bessel_rbf(d, n_radial, cutoff)
    return (ang[:, :, None] * rad[:, None, :]).reshape(
        angle.shape[0], n_spherical * n_radial)


def dimenet_apply(params, graph, cfg: DimeNetConfig, G=_Graph()):
    """Directional message passing; returns per-graph energies."""
    h = _species_embed(params, graph, cfg.n_species)
    n = h.shape[0] * G.parts
    pos = G.whole(graph["positions"])
    snd = _ids(graph["senders"], n)[0]
    rcv, rcv_seg = _ids(graph["receivers"], n)
    e = graph["senders"].shape[0] * G.parts
    emask = graph["edge_mask"]
    t_kj = _ids(graph["triplet_src"], e)[0]
    t_ji, t_ji_seg = _ids(graph["triplet_dst"], e)
    tmask = graph["triplet_mask"]

    vec = pos.index_select(0, snd) - pos.index_select(0, rcv)
    dist = _norm(vec + 1e-12)
    rbf = _bessel_rbf(dist, cfg.n_radial, cfg.cutoff)

    # initial directional messages m_ji
    hw = G.whole(h)
    m = _mlp(params["edge_emb"],
             torch.cat([hw.index_select(0, snd), hw.index_select(0, rcv),
                        rbf], dim=-1),
             act=shifted_softplus, final_act=True)

    # triplet angle between edge k->j and j->i
    vec_w = G.whole(vec)
    v_kj = vec_w.index_select(0, t_kj)
    v_ji = vec_w.index_select(0, t_ji)
    cosang = torch.sum(v_kj * v_ji, -1) / torch.clamp(
        _norm(v_kj) * _norm(v_ji), min=1e-9)
    angle = torch.arccos(torch.clamp(cosang, -1 + 1e-7, 1 - 1e-7))
    sbf = _angular_sbf(angle, G.whole(dist).index_select(0, t_kj),
                       cfg.n_spherical, cfg.n_radial, cfg.cutoff)

    d = cfg.d_hidden
    mdt = cfg.msg_dtype
    t = t_kj.shape[0]
    nch = cfg.triplet_chunks if t % cfg.triplet_chunks == 0 else 1

    def one(m, w_kj, kj, ji, msk, sb):
        mk = (m.to(mdt).index_select(0, kj) @ w_kj.to(mdt)).reshape(
            -1, cfg.n_bilinear, d)
        tr = torch.einsum("tb,tbd->td", sb.to(mdt), mk)
        tr = tr.masked_fill(~msk[:, None], 0)
        return segment_sum(tr, ji, e)

    def triplet_agg(m, bp):
        """sum over k of bilinear(sbf, m_kj) scattered to edge ji; chunked
        over the triplet list when cfg.triplet_chunks > 1 (§Perf), each
        chunk recomputed in the backward pass."""
        sb = sbf @ bp["w_sbf"]
        m = G.whole(m)
        if nch == 1:
            full = one(m, bp["w_kj"], t_kj, t_ji_seg, tmask, sb)
        else:
            parts = zip(t_kj.chunk(nch), t_ji_seg.chunk(nch),
                        tmask.chunk(nch), sb.chunk(nch))
            full = torch.stack([_remat(one, m, bp["w_kj"], *part)
                                for part in parts]).sum(0)
        return G.scatter(full)

    node_out = torch.zeros((h.shape[0], d), dtype=m.dtype, device=m.device)
    for bp in params["blocks"]:
        agg = triplet_agg(m, bp).to(m.dtype)
        m = m + _mlp(bp["msg_mlp"], agg * (rbf @ bp["w_rbf"]),
                     act=shifted_softplus)
        # per-block output: edge->node
        contrib = (m * (rbf @ params["out_rbf"])).masked_fill(
            ~emask[:, None], 0.0)
        hn = G.segment_sum(contrib, rcv_seg, n)
        node_out = node_out + _mlp(bp["out_mlp"], hn, act=shifted_softplus)

    atom_e = _mlp(params["readout"], node_out, act=shifted_softplus)[:, 0]
    return _energies(atom_e, graph, G)


# --- unified entry points ----------------------------------------------------

ARCHS = {
    "gat": (GATConfig, gat_init, gat_apply),
    "schnet": (SchNetConfig, schnet_init, schnet_apply),
    "meshgraphnet": (MGNConfig, mgn_init, mgn_apply),
    "dimenet": (DimeNetConfig, dimenet_init, dimenet_apply),
}


def init_params(generator: torch.Generator, cfg, device=None):
    """Parameters drawn from `generator`, on its device
    (``torch.Generator("cuda")`` for the card) unless `device` names
    another (``"meta"``: shapes only)."""
    dev = generator.device if device is None else torch.device(device)
    return ARCHS[cfg.arch][1](generator, cfg, device=dev)


def apply(params, graph, cfg):
    """The model's output: per node (gat, meshgraphnet; on a mesh this
    rank's block) or per graph (schnet, dimenet; whole)."""
    return _apply(params, graph, cfg, _Graph(get_current_mesh()))


def _apply(params, graph, cfg, G):
    return ARCHS[cfg.arch][2](G.params(params), graph, cfg, G)


def loss_fn(params, graph, cfg):
    """Node classification (gat), node regression (meshgraphnet), or
    per-graph energy regression (schnet/dimenet).  Returns (loss, aux), aux
    {"acc"} for gat and {} otherwise; on a mesh the whole graph's, the
    same on every rank."""
    G = _Graph(get_current_mesh())
    out = _apply(params, graph, cfg, G)
    if cfg.arch == "gat":
        labels = graph["labels"]
        mask = graph["node_mask"] & (labels >= 0)
        logp = F.log_softmax(out, dim=-1)
        lab = labels.clamp(min=0)
        nll = -logp.gather(1, lab.clamp(max=out.shape[1] - 1)[:, None].long()
                           )[:, 0]
        # a label past the classes reads NaN, as JAX's take_along_axis fills
        nll = torch.where(lab < out.shape[1], nll, math.nan)
        count = torch.clamp(G.count(mask.sum()), min=1)
        loss = G.sum(torch.sum(torch.where(mask, nll, 0.0))) / count
        acc = G.count(torch.sum(mask & (out.argmax(-1) == labels))) / count
        return loss, {"acc": acc}
    if cfg.arch == "meshgraphnet":
        err = (out - graph["labels"]) ** 2
        mask = graph["node_mask"][:, None]
        loss = G.sum(torch.sum(torch.where(mask, err, 0.0))) / torch.clamp(
            G.count(mask.sum()) * out.shape[-1], min=1)
        return loss, {}
    # energy models
    err = (out - graph["labels"]) ** 2
    return err.mean(), {}


def shard_batch(graph: dict, mesh) -> dict:
    """This rank's blocks of a whole graph batch on `mesh`, by the dry-run
    cells' rule: an array whose leading dim splits over every rank is cut
    to this rank's block ("ep_all"), any other (per-graph arrays, the int
    `n_graphs`) stays whole."""
    axes = mesh.axis_names
    return {k: mesh.block(v, axes, 0) if isinstance(v, torch.Tensor)
            and v.ndim and v.shape[0] % mesh.size == 0 else v
            for k, v in graph.items()}


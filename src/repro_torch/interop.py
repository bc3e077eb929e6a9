"""Arrays crossing between the JAX package and the port.

What crosses is a request payload (numpy, or a JAX array read back as
numpy), the result arrays, the LM's, BST's and the GNNs' parameters
(`lm_params_from_jax`, `bst_params_from_jax`, `gnn_params_from_jax`), so
that both packages can run on the same weights, and a GNN's graph batch
(`gnn_batch_from_numpy`).  JAX runs with x64 off
by default, so every payload it receives is canonicalised to 32 bits.  The
port applies the same rule, or a float64 field would be ordered in float64
here and in float32 by JAX, and ties would differ.

bfloat16 crosses bit for bit.  numpy has no bfloat16 of its own: a JAX bf16
array reads back as numpy with `ml_dtypes`' bfloat16 dtype, which
`torch.from_numpy` refuses, and the card's machine has neither jax nor
`ml_dtypes`.  So a numpy dtype named "bfloat16" is carried as its uint16
bits, without importing `ml_dtypes`, and `to_numpy` gives a bfloat16
tensor back as those uint16 bits.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ._device import resolve_device
from .tree import tree_leaves, tree_map

# JAX's x32 canonicalisation (jax.dtypes.canonicalize_dtype, x64 off)
_X32 = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
        np.dtype(np.uint64): np.uint32}
_X32_TORCH = {torch.float64: torch.float32, torch.int64: torch.int32,
              torch.uint64: torch.uint32}


def canonical_tensor(a, device=None) -> torch.Tensor:
    """`a` (numpy, anything numpy can read, or a tensor) as a tensor on
    `device` (default ``"cuda"``), with 64-bit dtypes cut to 32 bits as JAX
    does with x64 off: float64->float32, int64->int32, uint64->uint32.
    bool and 32-bit-or-narrower dtypes are kept; bfloat16 (a numpy dtype of
    that name) becomes torch.bfloat16 with the same bits."""
    dev = resolve_device(device)
    if isinstance(a, torch.Tensor):
        return a.to(device=dev, dtype=_X32_TORCH.get(a.dtype, a.dtype))
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        bits = np.array(arr, order="C").view(np.int16)   # a writable copy
        return torch.from_numpy(bits).view(torch.bfloat16).to(dev)
    arr = np.ascontiguousarray(arr.astype(_X32.get(arr.dtype, arr.dtype),
                                          copy=False))
    if not arr.flags.writeable:      # e.g. a JAX array read back as numpy
        arr = arr.copy()
    return torch.from_numpy(arr).to(dev)


def to_numpy(result):
    """A tensor -> numpy array (a bfloat16 tensor -> its uint16 bits); a
    NamedTuple (`MSSegmentation`, `CCResult`) or a dataclass
    (`topology.TopologyResult`) -> the same type with its tensor fields as
    numpy arrays; other values pass unchanged."""
    if isinstance(result, torch.Tensor):
        t = result.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    if isinstance(result, tuple) and hasattr(result, "_fields"):
        return type(result)(*(to_numpy(v) for v in result))
    if dataclasses.is_dataclass(result) and not isinstance(result, type):
        return dataclasses.replace(result, **{
            f.name: to_numpy(getattr(result, f.name))
            for f in dataclasses.fields(result) if f.init})
    return result


def _tree_to_torch(tree, device):
    """A pytree of dicts and lists of arrays -> the same of tensors."""
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to_torch(v, device) for v in tree]
    return canonical_tensor(tree, device)


def lm_params_from_jax(tree, device=None) -> dict:
    """The JAX LM's parameter pytree (`repro.models.lm.init_params`, arrays
    or numpy) -> `repro_torch.models.lm`'s parameters on `device` (default
    ``"cuda"``): the same tensors, bfloat16 bit for bit, JAX's stacked
    layers (leading axis L) split into a list of per-layer dicts, the MoE
    stacks (L, E, D, F) into per-layer (E, D, F) experts."""
    out = _tree_to_torch({k: v for k, v in tree.items() if k != "layers"},
                         device)
    stacked = _tree_to_torch(tree["layers"], device)
    n_layers = len(next(iter(stacked.values())))
    out["layers"] = [{k: v[i] for k, v in stacked.items()}
                     for i in range(n_layers)]
    return out


def bst_params_from_jax(tree, device=None) -> dict:
    """The JAX BST's parameter pytree (`repro.models.bst.init_params`) ->
    `repro_torch.models.bst`'s parameters on `device` (default ``"cuda"``):
    the same structure (tables, a list of blocks, a list of MLP layers)."""
    return _tree_to_torch(tree, device)


def gnn_params_from_jax(tree, device=None) -> dict:
    """The JAX GNN's parameter pytree (`repro.models.gnn.init_params`, any
    arch) -> `repro_torch.models.gnn`'s parameters on `device` (default
    ``"cuda"``): the same tensors bit for bit, MeshGraphNet's stacked
    layers (a dict of leading-axis-L stacks) split into a list of per-layer
    dicts, as `models.gnn.mgn_init` draws them."""
    layers = tree.get("layers")
    if not isinstance(layers, dict):          # GAT's list, or no "layers"
        return _tree_to_torch(tree, device)
    out = _tree_to_torch({k: v for k, v in tree.items() if k != "layers"},
                         device)
    stacked = _tree_to_torch(layers, device)
    n_layers = len(tree_leaves(stacked)[0])
    out["layers"] = [tree_map(lambda t, i=i: t[i], stacked)
                     for i in range(n_layers)]
    return out


def gnn_batch_from_numpy(batch, device=None) -> dict:
    """A GNN graph batch (`repro_torch.data.graphs`' dicts of numpy arrays)
    -> the same dict of tensors on `device` (default ``"cuda"``) through
    `canonical_tensor`; the int `n_graphs` stays an int."""
    return {k: v if k == "n_graphs" else canonical_tensor(v, device)
            for k, v in batch.items()}

"""Id / order-field utilities (port of `repro/core/ids.py`).

The paper (§3.1, §4.1) requires an injective scalar field, enforced by a
Simulation-of-Simplicity variant: sort vertices by (scalar, id) and use the
sort rank as the *order field*.  All DPC code operates on this integer order
field, never on raw scalars.  Ranks and ids are int32, as in JAX with x64 off.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device


def _sort_key(flat: torch.Tensor) -> torch.Tensor:
    """Float keys as JAX's sort comparator sees them: -0.0 equal to +0.0
    and every NaN one value sorted last.  (Torch's CUDA sort is a radix
    sort on the float's bits; canonical keys make the order independent of
    how it treats signed zeros and NaN payloads.)"""
    if not flat.is_floating_point():
        return flat
    return torch.where(torch.isnan(flat), float("nan"), flat + 0.0)


def compute_order(scalars: torch.Tensor,
                  ids: torch.Tensor | None = None) -> torch.Tensor:
    """Global order field: rank of each vertex under (scalar, id) lexsort.

    Mirrors TTK's ttkArrayPreconditioning (paper §4.1).  Returns int32 ranks
    in [0, N), shaped like `scalars`: a permutation, hence injective.
    """
    flat = _sort_key(scalars.reshape(-1))
    n = flat.numel()
    if ids is None:
        # a stable sort keeps equal scalars in id order: jnp.lexsort's tie rule
        perm = torch.sort(flat, stable=True).indices
    else:
        by_id = torch.sort(ids.reshape(-1), stable=True).indices
        perm = by_id[torch.sort(flat[by_id], stable=True).indices]
    order = torch.empty(n, dtype=torch.int32, device=flat.device)
    order[perm] = torch.arange(n, dtype=torch.int32, device=flat.device)
    return order.reshape(scalars.shape)


def inverse_permutation(perm: torch.Tensor) -> torch.Tensor:
    """inv[perm[i]] = i.  Used to map max-order values back to vertex ids."""
    flat = perm.reshape(-1)
    inv = torch.empty_like(flat)
    inv[flat.long()] = torch.arange(flat.numel(), dtype=flat.dtype,
                                    device=flat.device)
    return inv


def flat_ids(shape, dtype=torch.int32, device=None) -> torch.Tensor:
    """Row-major flat id grid for a structured grid of `shape`."""
    n = int(np.prod(shape))
    return torch.arange(n, dtype=dtype,
                        device=resolve_device(device)).reshape(shape)


def compact_labels(labels: torch.Tensor, fill_value: int = -1):
    """Relabel arbitrary label values to [0, k); returns (int32 compact, k).
    Negative labels (unmasked) get `fill_value`.  As in JAX, a label equal
    to the dtype's max is not counted in k (it is JAX's padding value)."""
    flat = labels.reshape(-1)
    uniq, rank = torch.unique(flat, sorted=True, return_inverse=True)
    neg = int((uniq < 0).sum())
    compact = torch.where(flat < 0, fill_value, rank - neg).to(torch.int32)
    k = (uniq.numel() - int((uniq == torch.iinfo(flat.dtype).max).any())
         - neg)
    return compact.reshape(labels.shape), k

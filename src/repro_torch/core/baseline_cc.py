"""VTK-connectivity stand-in baseline (port of `repro/core/baseline_cc.py`,
paper §5, Tab. 1-3 comparisons).

The VTK filter runs a *connected wave propagation* locally; the closest
analogue here is plain label propagation: every masked vertex repeatedly
takes the max label over its masked neighborhood.  Convergence needs
O(component diameter) rounds versus O(log diameter) for DPC pointer
doubling, the algorithmic gap the paper's benchmarks exercise.  JAX's
`lax.while_loop` is a Python loop here that reads one bool a round.

`extract_masked_edges` models VTK's structured->unstructured extraction:
the masked subgraph materialised as an edge list (O(#masked * degree) index
memory, while implicit DPC holds one extra label array).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .steepest import id_dtype_for, neighbor_offsets, shift_fill


class BaselineCC(NamedTuple):
    labels: torch.Tensor
    n_rounds: int


def label_propagation_grid(mask: torch.Tensor, connectivity: int = 6,
                           max_rounds: int = 100_000) -> BaselineCC:
    """Labels (largest vertex id of the component, -1 unmasked, shaped like
    `mask`) and the sweeps run, the final no-change sweep included."""
    n = mask.numel()
    m = mask.bool()
    ids = torch.arange(n, dtype=id_dtype_for(n),
                       device=mask.device).reshape(mask.shape)
    labels = torch.where(m, ids, -1)
    offsets = neighbor_offsets(mask.ndim, connectivity)
    changed, rounds = True, 0
    while changed and rounds < max_rounds:
        best = labels
        for off in offsets:
            best = torch.maximum(best, shift_fill(labels, off, -1))
        nxt = torch.where(m, best, -1)
        changed = bool((nxt != labels).any())
        labels, rounds = nxt, rounds + 1
    return BaselineCC(labels, rounds)


def extract_masked_edges(mask: torch.Tensor, connectivity: int = 6):
    """Explicit extraction (the VTK model): the masked subgraph's directed
    edge list, padded to the full grid-edge count (one slot per vertex and
    offset): (senders, receivers, valid), -1 in the invalid slots."""
    n = mask.numel()
    m = mask.bool()
    m_flat = m.reshape(-1)
    ids = torch.arange(n, dtype=torch.int32,
                       device=mask.device).reshape(mask.shape)
    send, recv, valid = [], [], []
    for off in neighbor_offsets(mask.ndim, connectivity):
        nb = shift_fill(ids, off, -1).reshape(-1)
        ok = m_flat & (nb >= 0) & shift_fill(m, off, False).reshape(-1)
        send.append(torch.where(ok, ids.reshape(-1), -1))
        recv.append(torch.where(ok, nb, -1))
        valid.append(ok)
    return torch.cat(send), torch.cat(recv), torch.cat(valid)

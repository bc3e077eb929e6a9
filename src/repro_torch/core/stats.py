"""Unified DPC run statistics for both distributed backends (port of
`repro/core/stats.py`).

`DPCStats` (structured block lattice) and `GraphDPCStats` (unstructured
vertex partitions) report the SAME fields in the SAME order, so the serving
layer and the benchmarks can consume either through one code path.  Both
expose `as_dict()`, the host-side uniform reporting hook: values become
Python scalars (0-d) or lists (batched stats with a leading request dim),
from tensors, numpy arrays or Python numbers alike.

The classes stay distinct NamedTuples on purpose: a backend can grow a
trailing field of its own later without perturbing the shared prefix the
serving layer keys on.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

# the shared field prefix, in the canonical order both classes use
STAT_FIELDS = ("local_iters", "table_iters", "stitch_rounds", "ghost_bytes",
               "masked_ghost_fraction", "pad_fraction", "comm_phases",
               "kernel_rounds", "global_iters_saved", "table_bytes_peak",
               "exchange_rounds", "converged")


def stats_as_dict(stats) -> dict:
    """Host-side uniform view of any *DPCStats NamedTuple: Python scalars
    (0-d) or lists (batched stats with a leading request dim)."""
    out = {}
    for name, val in zip(stats._fields, stats):
        a = val.detach().cpu() if isinstance(val, torch.Tensor) \
            else np.asarray(val)
        out[name] = a.item() if a.ndim == 0 else a.tolist()
    return out


class DPCStats(NamedTuple):
    """Per-run statistics of the structured (block-lattice) backend."""
    local_iters: Any            # pointer-doubling rounds in the local phase
    table_iters: Any            # rounds on the gathered ghost table
    stitch_rounds: Any          # CC only (0 for MS)
    ghost_bytes: Any            # in-domain bytes all-gathered (the ONE comm
                                # phase; pad slots excluded, deviation (p))
    masked_ghost_fraction: Any  # CC: fraction of boundary actually masked
                                # (over in-domain slots)
    pad_fraction: Any           # fraction of block cells that are padding
                                # (0 whenever the layout divides the grid)
    comm_phases: Any            # bulk exchange phases (paper budget: 1; the
                                # halo exchange is ghost setup, not a gather)
    kernel_rounds: Any          # max in-tile saturation rounds of the fused
                                # local-phase kernel (0 on the plain init)
    global_iters_saved: Any     # max(kernel_rounds - local_iters, 0): a
                                # lower bound on doubling rounds the fusion
                                # removed from the global loop
    table_bytes_peak: Any       # per-device bytes materialized for the
                                # boundary-table resolution (replicated: the
                                # full gathered table; sharded: own faces +
                                # halo stack, deviation (s))
    exchange_rounds: Any        # sharded mode: outer halo-exchange rounds of
                                # the table fixpoint (0 = replicated)
    converged: Any              # 1 iff every table fixpoint reached its
                                # fixed point within max_iter (a 0 here
                                # raises eagerly; see _table.check_converged)

    def as_dict(self) -> dict:
        return stats_as_dict(self)


class GraphDPCStats(NamedTuple):
    """Per-run statistics of the unstructured (vertex-partition) backend.
    Field names/order mirror `DPCStats` exactly (see module docstring)."""
    local_iters: Any            # pointer-doubling rounds in the local phase
    table_iters: Any            # chase + propagate rounds on the cut table
    stitch_rounds: Any          # local stitch fixpoint rounds
    ghost_bytes: Any            # real cut bytes all-gathered (the ONE comm
                                # phase; pad slots excluded, deviation (p))
    masked_ghost_fraction: Any  # fraction of REAL cut slots masked
    pad_fraction: Any           # fraction of owned slots that are padding
                                # (0 for a balanced partition)
    comm_phases: Any            # all_gather phases (paper budget: 1)
    kernel_rounds: Any          # always 0: the fused grid kernel does not
                                # apply to unstructured partitions
    global_iters_saved: Any     # always 0 (see kernel_rounds)
    table_bytes_peak: Any       # per-device bytes materialized for the
                                # cut-table resolution (replicated: full
                                # gathered table (+mask); sharded: own row +
                                # neighbor halo, deviation (s))
    exchange_rounds: Any        # sharded mode: outer halo-exchange rounds of
                                # the cut fixpoint (0 = replicated)
    converged: Any              # 1 iff every table fixpoint reached its
                                # fixed point within max_iter

    def as_dict(self) -> dict:
        return stats_as_dict(self)


assert DPCStats._fields == STAT_FIELDS == GraphDPCStats._fields

"""Path compression (pointer doubling), port of `repro/core/pathcompress.py`.

Each round is the whole-array gather `d_{t+1}[v] = d_t[d_t[v]]`; the loop
stops on the first round that changes nothing, so a chain of length L
resolves in ceil(log2 L) rounds plus that verification round.  Entries < 0
are "unmasked" sentinels (paper Alg. 3 line 12) and are left untouched.

`index_select` takes int32 indices, so a round needs no int64 copy of the
pointers; `d[idx]` would make one (1 GB at 512^3).  The convergence test
reads one bool back to the host each round (`_meta.again`: a shape-only
run on the meta device costs one round).
"""
from __future__ import annotations

import torch

from .._meta import again


def jump(d: torch.Tensor) -> torch.Tensor:
    """One pointer-doubling round on flat `d`: d[v] <- d[d[v]], masked
    entries (d < 0) fixed."""
    nd = d.index_select(0, d.clamp(min=0))
    return torch.where(d >= 0, nd, d)


def path_compress(d: torch.Tensor, max_iter: int = 64):
    """Iterate pointer doubling to the fixpoint.

    Args:
      d: flat int pointers into itself, -1 for unmasked entries.
      max_iter: safety bound; 64 covers any chain up to 2**64.

    Returns:
      (compressed pointers, number of rounds executed): the same count as
      the JAX while loop, the final no-change round included.
    """
    iters, changed = 0, True
    while changed and iters < max_iter:
        nxt = jump(d)
        changed = again((nxt != d).any())
        d, iters = nxt, iters + 1
    return d, iters


def path_compress_unrolled(d: torch.Tensor, rounds: int) -> torch.Tensor:
    """Fixed number of doubling rounds (for kernels / known-diameter blocks)."""
    for _ in range(rounds):
        d = jump(d)
    return d


def is_converged(d: torch.Tensor) -> bool:
    """True iff every masked pointer is a fixpoint (points at a root)."""
    return bool((jump(d) == d).all())

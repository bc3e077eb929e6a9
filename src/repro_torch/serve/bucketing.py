"""Layout bucketing for the batched topology engine (port of
`repro/serve/bucketing.py`, DESIGN.md §Serve).

Heterogeneous request extents are quantised to a small set of padded
layouts so that a handful of cached executables serves every tenant: each
grid extent rounds up to the next power of two (floored at `min_extent`),
and the request count of a bucket rounds up to the next power-of-two batch
capacity.  The pad region is filled with the same inert sentinels the
distributed pad-and-mask path uses (mask False / order -1, deviation (p) in
DESIGN.md), so padding can never win an argmax, and the capacity slack is
filled with all-inert dummy items.

Because row-major raveling is the lexicographic order of the coordinates,
padding extents preserves the relative flat-id order of the real vertices;
label VALUES (largest-member flat ids) from a padded run are mapped back to
real-extent flat ids by `remap_flat_labels` — unravel in the padded shape,
ravel in the real shape — which lands exactly on the ids the unpadded call
produces (the engine's bit-parity contract).

The layout arithmetic is plain Python, copied unchanged; `pad_to` and
`remap_flat_labels` work on tensors on their own device (int64 index math,
cast back to the label dtype), so no payload or label array makes a round
trip through the host.
"""
from __future__ import annotations

import math

import torch


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (int(n) - 1).bit_length()


def bucket_shape(shape, min_extent: int = 8) -> tuple:
    """Padded layout a request of `shape` is served under."""
    return tuple(max(next_pow2(s), min_extent) for s in shape)


def batch_capacity(n_items: int, max_batch: int = 64) -> int:
    """Padded batch size of a bucket occupancy (pow2, capped)."""
    return min(next_pow2(n_items), max_batch)


def pad_to(x: torch.Tensor, shape, fill, out=None) -> torch.Tensor:
    """Pad a single payload up to its bucket shape with an inert fill, on
    the payload's device.  `out`, a tensor of `shape` (the engine passes a
    slot of its batch stack), is written in place and returned."""
    same = tuple(x.shape) == tuple(shape)
    if out is None:
        if same:
            return x
        out = x.new_full(tuple(shape), fill)
    elif not same:
        out.fill_(fill)
    out[tuple(slice(0, s) for s in x.shape)] = x
    return out


def remap_flat_labels(labels, padded_shape, real_shape) -> torch.Tensor:
    """Slice a padded label grid to the real extent and rewrite label values
    from padded-shape flat ids to real-shape flat ids (identity when the
    shapes agree).  Entries < 0 (unmasked) are preserved.  Works on the
    labels' device; a numpy array is taken as a CPU tensor."""
    out = torch.as_tensor(labels)[tuple(slice(0, s) for s in real_shape)]
    if tuple(padded_shape) == tuple(real_shape):
        return out
    v = out.to(torch.int64)
    rest, flat = v.clamp(min=0), torch.zeros_like(v)
    stride = 1
    for p, r in zip(reversed(padded_shape), reversed(real_shape)):
        flat += (rest % p) * stride         # unravel in the padded shape,
        rest = rest // p                    # ravel in the real shape
        stride *= r
    return torch.where(v >= 0, flat, v).to(out.dtype)


def pad_waste(real_shapes, padded_shape, capacity) -> tuple:
    """(real_cells, padded_cells) of one bucket execution."""
    real = sum(math.prod(s) for s in real_shapes)
    return real, math.prod(padded_shape) * capacity


# --- cost-model layout merging (DESIGN.md §Serve-v2) -------------------------

def adjacent_layouts(small, big) -> bool:
    """Whether `small` can merge into `big` in one pow2 step: `big`
    dominates elementwise and costs at most 2x the cells (one axis
    doubled — the pow2 lattice's nearest-neighbor relation)."""
    return (len(small) == len(big) and small != big
            and all(b >= s for s, b in zip(small, big))
            and math.prod(big) <= 2 * math.prod(small))


def merge_adjacent_layouts(layout_counts: dict, slot_cost_cells: int) -> dict:
    """Cost-model merge plan over observed pow2 layouts.

    `layout_counts` maps each layout (a `bucket_shape` tuple) to the number
    of items it would serve; the returned dict maps every layout to the
    layout it should execute under (identity when unmerged).  A layout L
    merges into an adjacent layout B already in use when the modeled extra
    pad waste — `(cells(B) - cells(L)) * n_items(L)` — is cheaper than
    keeping a separate executable slot (`slot_cost_cells`, the cost model's
    exchange rate between executable slots and padded cells).  Merging is
    always *correct* (any dominating layout pads inertly and
    `remap_flat_labels` restores real-extent ids bit-identically); this
    function only decides when it is *cheap*.

    Greedy smallest-first.  The documented ≤2x pad bound (DESIGN.md
    §Serve-v2) must hold for every ORIGINAL layout, not just the direct
    edge: when L (already carrying items merged down from smaller layouts)
    would itself merge into B, each rider's own cells bound B too;
    `min_cells` tracks the smallest original member of each live group and
    vetoes chains A -> B -> C that would land A on cells(C) > 2x cells(A).
    """
    target = {L: L for L in layout_counts}
    if slot_cost_cells is None or slot_cost_cells <= 0:
        return target
    counts = dict(layout_counts)
    min_cells = {L: math.prod(L) for L in layout_counts}
    for L in sorted(layout_counts, key=lambda s: (math.prod(s), s)):
        best, best_extra = None, None
        for B in layout_counts:
            if target[B] != B or not adjacent_layouts(L, B):
                continue  # merged-away layouts cannot absorb others
            if math.prod(B) > 2 * min_cells[L]:
                continue  # would break the ≤2x bound for a rider on L
            extra = (math.prod(B) - math.prod(L)) * counts[L]
            if best is None or (extra, B) < (best_extra, best):
                best, best_extra = B, extra
        if best is not None and best_extra < slot_cost_cells:
            target[L] = best
            counts[best] = counts.get(best, 0) + counts.pop(L)
            min_cells[best] = min(min_cells[best], min_cells[L])
    for L in target:  # resolve merge chains L -> M -> N (the min_cells
        while target[target[L]] != target[L]:  # veto makes this a no-op on
            target[L] = target[target[L]]      # the pow2 lattice; kept as
    return target                              # a safety net

"""Shared machinery for the boundary-table phase (port of
`repro/core/_table.py`, paper Alg. 2).

Both distributed backends (the block decomposition of structured grids and
the vertex partition of edge-list meshes) end their local phase by
resolving cross-shard segments on a flat table of boundary/cut labels, in
one of two layouts (deviation (s) in DESIGN.md):

  * **replicated** (deviation (b)): ONE all_gather replicates every owned
    boundary slot on every device;
  * **sharded**: each device holds only its OWN slots plus a one-hop halo
    of neighbor slots (a "stack"), and the cross-shard fixpoint runs as
    outer rounds of [halo exchange -> local resolve -> global changed?]
    (`sharded_fixpoint_batch`, one item or a batch).

Two backend closures fix the layout: `lookup` (a label value -> its slot in
this device's view, bundled with the slot values as a `TableView`) and
`cut_max` (the max over masked cut edges between slots).  This module holds
the backend-independent pieces: the pointer-doubling chase (Alg. 2 lines
15-25), the equal-label group machinery and hook+propagate fixpoint of
deviation (d2), the value-search substitution (Alg. 2 lines 27-33
generalised to merged labels), and the sharded outer exchange loop.

Each of JAX's `lax.while_loop`s is a Python loop here that reads one bool
a round (`_meta.again`: once on the meta device), with the same round
counts; counts come back as ints and convergence flags as bools.

Sentinel contract (deviation (p)): ragged decompositions pad their tables
with slots whose label is -1 and whose mask is False; `pointer_chase` fixes
entries < 0 (the `lookup` closures gate on `t >= 0`), the cut hooks gate on
the mask, and `value_substitute` leaves negative labels untouched, so a
pad slot never leaks a label into a real component, nor acquires one.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from .._meta import again, cumsum
from .steepest import segment_max_into

TABLE_MODES = ("replicated", "sharded")


def check_table_mode(table_mode: str) -> None:
    if table_mode not in TABLE_MODES:
        raise ValueError(
            f"table_mode must be one of {TABLE_MODES}, got {table_mode!r}")


class TableView(NamedTuple):
    """One device's view of the boundary/cut table.

    `values` are the flat label slots this device holds: the FULL gathered
    table in replicated mode, own slots followed by the one-hop halo stack
    in sharded mode (the own chunk is ALWAYS `values[..., :n_own]`).
    `lookup(t)` maps label values through the view: value -> slot in this
    view -> entry at that slot, identity where the value has no slot here.
    """
    values: torch.Tensor
    lookup: Callable
    n_own: int


def pointer_chase(T, lookup, max_iter: int = 64):
    """Pointer doubling on a flat table (Alg. 2 lines 15-25): `lookup` maps
    every entry through the table, leaving unresolvable entries fixed, to
    the fixpoint.  Returns (table, rounds, converged); `converged` is False
    when the loop was cut off at `max_iter` with the last round still
    changing entries."""
    changed, iters = True, 0
    while changed and iters < max_iter:
        nt = lookup(T)
        changed = again((nt != T).any())
        T, iters = nt, iters + 1
    return T, iters, not changed


def chase_view(view: TableView, max_iter: int = 64):
    """`pointer_chase` over a `TableView`; returns (view', iters, converged)."""
    T, iters, ok = pointer_chase(view.values, view.lookup, max_iter)
    return view._replace(values=T), iters, ok


def make_group_max(Tstar: torch.Tensor):
    """Equal-label group structure of a flat (compressed) table.

    Slots sharing a label belong to one (partial) component; groups are the
    runs of the stably sorted table, so a group reduction is one segment
    max.  Returns (group_max fn, perm, sorted_vals); the latter two also
    drive the final value-search substitution.  perm is int32, as JAX's
    argsort gives it.
    """
    msize = Tstar.numel()
    perm = torch.argsort(Tstar, stable=True)
    sorted_vals = Tstar[perm]
    run_start = torch.ones(msize, dtype=torch.bool, device=Tstar.device)
    run_start[1:] = sorted_vals[1:] != sorted_vals[:-1]
    run_id = cumsum(run_start, torch.int32) - 1
    inv_perm = torch.empty_like(perm)
    inv_perm[perm] = torch.arange(msize, device=Tstar.device)

    def group_max(L):
        # the runs are filled with the dtype's minimum first, as JAX's
        # segment_max fills empty segments; every run has a slot
        gm = torch.full_like(L, torch.iinfo(L.dtype).min)
        segment_max_into(gm, run_id, L[perm])
        return gm[run_id][inv_perm]

    return group_max, perm.to(torch.int32), sorted_vals


def hook_propagate(Tstar, cut_max, group_max, max_iter: int = 64):
    """Hook + propagate fixpoint on the compressed table (deviation (d2) in
    DESIGN.md): alternate `cut_max` (max across masked cut edges between
    table slots) and `group_max` (max within equal-original-label groups)
    until no label changes.  Gives each slot the largest label of its
    *global* component.  Returns (labels, rounds, converged)."""
    changed, iters, L = True, 0, Tstar
    while changed and iters < max_iter:
        nxt = group_max(cut_max(L))
        changed = again((nxt != L).any())
        L, iters = nxt, iters + 1
    return L, iters, not changed


def value_substitute(o, chased, sorted_vals, g_sorted):
    """Final substitution for CC (Alg. 2 lines 27-33 generalised): take each
    owned label `chased` through the table, then adopt its equal-label
    group's propagated maximum, found by *value* (searchsorted over the
    sorted table): an owned label can name an interior root that is not
    itself a table slot but shares its value with cut vertices of the same
    local piece.  `o` is the pre-chase label; `< 0` entries stay -1."""
    idx = torch.searchsorted(sorted_vals, chased.to(sorted_vals.dtype))
    idx = idx.clamp_(0, sorted_vals.numel() - 1)
    found = sorted_vals[idx] == chased
    improved = torch.where(found & (chased >= 0),
                           torch.maximum(g_sorted[idx], chased), chased)
    return torch.where(o < 0, -1, improved)


def sharded_fixpoint_batch(own0, exchange, refine, reduce_any,
                           max_rounds: int = 64):
    """Outer halo-exchange loop of the sharded table mode (deviation (s))
    for a batch of B items: JAX's `lax.while_loop` under `vmap`.

    `own0` is the (B, n_own) stack of the device's owned slot chunks.
    `exchange(own) -> stacks` rebuilds the (b, stack) own+halo views of b
    items from their fresh (b, n_own) owned values (the own chunk MUST land
    at `stack[:n_own]`); `refine(stack, item) -> (stack', iters, ok)`
    resolves one item's view locally; `reduce_any(flags)` ORs a (b,) bool
    tensor of "changed" flags across the devices (one all_reduce MAX; the
    identity on one device).  A round refines, reduces and exchanges the
    items still running, each collective once for all of them; an item
    stops when no device's owned chunk changed, at its own fixpoint and with
    its own counts, as the batched while_loop freezes it by its select.
    The fixpoint, and hence the final labels, equal the replicated mode's
    (DESIGN.md §Table-sharding).

    Returns (stacks, owns, exchange_rounds, total inner iters, converged),
    the last three per-item lists.  Each stack holds the converged owned
    chunk plus a FRESH halo (the trailing exchange is counted in
    `exchange_rounds`).
    """
    B, n_own = own0.shape
    stack, own = exchange(own0), own0.clone()
    rounds, iters = [1] * B, [0] * B
    ok, changed = [True] * B, [True] * B
    while True:
        run = [b for b in range(B) if changed[b] and rounds[b] < max_rounds]
        if not run:
            break
        new_own, flags = [], []
        for b in run:
            stack2, inner, ok2 = refine(stack[b], b)
            new_own.append(stack2[:n_own])
            flags.append(again((new_own[-1] != own[b]).any()))
            iters[b] += int(inner)
            ok[b] = ok[b] and bool(ok2)
        ch = reduce_any(torch.tensor(flags))
        new_own = torch.stack(new_own)
        idx = torch.tensor(run, device=stack.device)
        stack[idx] = exchange(new_own)
        own[idx] = new_own
        for j, b in enumerate(run):
            changed[b] = bool(ch[j])
            rounds[b] += 1
    return stack, own, rounds, iters, [o and not c
                                       for o, c in zip(ok, changed)]


def sharded_fixpoint(own0, exchange, refine, reduce_any, max_rounds: int = 64):
    """`sharded_fixpoint_batch` for one item: `own0` is the (n_own,) owned
    chunk, `exchange(own) -> stack`, `refine(stack) -> (stack', iters, ok)`
    and `reduce_any(flag)` on a 0-d flag.  Returns (stack, own,
    exchange_rounds, total inner iters, converged)."""
    stack, own, rounds, iters, ok = sharded_fixpoint_batch(
        own0[None], lambda o: exchange(o[0])[None],
        lambda st, _: refine(st),
        lambda flags: torch.as_tensor(reduce_any(flags[0])).reshape(1),
        max_rounds)
    return stack[0], own[0], rounds[0], iters[0], ok[0]


def check_converged(flag, what: str, max_iter: int) -> None:
    """Raise when a table fixpoint was cut off at `max_iter` instead of
    returning a silently-wrong answer.  Torch runs eagerly, so the flag is
    always concrete and the check always runs (JAX skips it under
    tracing), except on the meta device, where no flag has a value."""
    if isinstance(flag, torch.Tensor) and flag.is_meta:
        return
    ok = bool(flag.all()) if isinstance(flag, torch.Tensor) \
        else bool(np.all(np.asarray(flag)))
    if not ok:
        raise RuntimeError(
            f"{what}: table resolution did not reach its fixpoint within "
            f"max_iter={max_iter} rounds; labels would be mid-chain/"
            f"mid-flood. Raise `table_max_iter` (the stats field "
            f"`converged` carries the same flag).")

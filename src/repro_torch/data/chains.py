"""Fields whose pointer chains run long inside an x-slab: the worst cases of
the block-local phase (`kernels.fused_local_phase`), where synchronous
doubling needs many rounds and a chase walks far.  Random fields give
chains of a few hops only.  Flipping a field along y and z
(``field.flip((1, 2))``) turns its steepest chains to falling ids.
"""
from __future__ import annotations

import torch

from .._device import resolve_device


def _coords(shape, dev):
    x, y, z = (torch.arange(s, device=dev) for s in shape)
    return x[:, None, None], y[None, :, None], z[None, None, :]


def z_ramp_order(shape, device=None) -> torch.Tensor:
    """int32 order ``(z * Y + y) * X + x`` of an (X, Y, Z) grid: every
    steepest chain climbs the whole Z, then y along the top face, then x to
    its slab's edge."""
    X, Y, _ = shape
    x, y, z = _coords(shape, resolve_device(device))
    return ((z * Y + y) * X + x).to(torch.int32)


def serpentine_order(shape, device=None) -> torch.Tensor:
    """int32 order of an (X, Y, Z) grid with a one-voxel-wide path in every
    x-plane: along z on every even y row, turning at alternate ends of the
    odd rows.  The path voxel at position s of plane x has order
    ``n + s * X + x`` (rising along the path, unique across planes); every
    other voxel is a wall, ordered by its flat id, below every path value.
    A steepest chain follows the path: about Y * Z / 2 hops in one plane."""
    X, Y, Z = shape
    n = X * Y * Z
    x, y, z = _coords(shape, resolve_device(device))
    row = y // 2
    # position on the path: even rows run z up and down in turn; the odd
    # row between rows 2r and 2r + 2 holds one voxel at the turn
    along = torch.where(row % 2 == 0, z, Z - 1 - z)
    s = row * (Z + 1) + torch.where(y % 2 == 0, along, Z)
    turn = torch.where(row % 2 == 0, Z - 1, 0)
    path = (y % 2 == 0) | ((z == turn) & (y + 1 < Y))
    flat = (x * Y + y) * Z + z
    return torch.where(path, n + s * X + x, flat).to(torch.int32)


def z_line_mask(shape, device=None) -> torch.Tensor:
    """bool mask of single lines along z at even x and even y: every line is
    a component of its own at any connectivity, and its cc chain runs its
    whole length."""
    x, y, z = _coords(shape, resolve_device(device))
    return ((x % 2 == 0) & (y % 2 == 0)).expand(tuple(shape)).contiguous()

"""Perlin noise (port of `repro/data/perlin.py`): the paper's synthetic
scaling dataset, "one layer of Perlin Noise with an amplitude of one and
frequency in every dimension of 0.1" (§5).

The field is the numpy reference's, value for value.  The lattice-corner
hash is uint64 arithmetic, which torch has no usable form of on CUDA, so the
few lattice corners the window touches get their gradients on the host with
the reference's numpy code; the card gathers them per point and does the
interpolation in float64, one x-slab at a time (at 512^3 the whole field's
float64 temporaries would take several GB), with the reference's operations
in the reference's order.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device


def _fade(t):
    return t * t * t * (t * (t * 6 - 15) + 10)


def _corner_gradients(c: np.ndarray) -> np.ndarray:
    """Unit-ish gradient of each lattice corner c (..., ndim) int64: the
    reference's `corner_grad` body, unchanged."""
    ndim = c.shape[-1]
    h = np.zeros(c.shape[:-1], dtype=np.uint64)
    for d in range(ndim):
        h = h * np.uint64(0x9E3779B97F4A7C15) + c[..., d].astype(np.uint64)
    h ^= h >> np.uint64(33)
    h *= np.uint64(0xFF51AFD7ED558CCD)
    h ^= h >> np.uint64(33)
    # map hash to a unit-ish gradient via ndim angles
    g = []
    hh = h.copy()
    for d in range(ndim):
        g.append(np.cos(2 * np.pi * (hh % np.uint64(65536)).astype(
            np.float64) / 65536.0 + d))
        hh = (hh >> np.uint64(16)) | (hh << np.uint64(48))
    g = np.stack(g, axis=-1)
    g /= np.maximum(np.linalg.norm(g, axis=-1, keepdims=True), 1e-12)
    return g


# points interpolated at once: ~80 B of float64 temporaries each, so about
# 0.7 GB per slab (a 512^3 field in 16 slabs)
SLAB_POINTS = 1 << 23


def perlin_noise(shape, frequency: float = 0.1, seed: int = 0, origin=None,
                 device=None) -> torch.Tensor:
    """N-D Perlin noise on an integer grid of `shape`, amplitude ~1, as a
    float32 tensor on `device` (default ``"cuda"``).

    `origin` offsets the sample window in lattice units (a shard's slab with
    origin=(x0, 0, 0) equals that slab of the global field); the seed folds
    into the origin, as in the reference.
    """
    dev = resolve_device(device)
    ndim = len(shape)
    origin = tuple(origin or (0,) * ndim)
    if seed:
        origin = tuple(o + seed * 1009 for o in origin)
    # per-axis sample positions, lattice cells and fractions: the
    # reference's meshgrid holds these same values broadcast
    pts = [(np.arange(s) + o) * frequency for s, o in zip(shape, origin)]
    cells = [np.floor(p).astype(np.int64) for p in pts]
    fracs = [p - c for p, c in zip(pts, cells)]
    lo = [int(c.min()) if c.size else 0 for c in cells]
    ext = [int(c.max()) - l + 2 if c.size else 1 for c, l in zip(cells, lo)]
    lattice = np.stack(np.meshgrid(*[np.arange(l, l + e) for l, e in
                                     zip(lo, ext)], indexing="ij"), axis=-1)
    grads = torch.from_numpy(
        _corner_gradients(lattice).reshape(-1, ndim)).to(dev)
    strides = [int(np.prod(ext[a + 1:])) for a in range(ndim)]

    def axis(vals, a):   # 1-D per-axis values, broadcast along axis a
        view = [1] * ndim
        view[a] = -1
        return torch.from_numpy(np.ascontiguousarray(vals)).to(dev).view(view)

    cell_idx = [axis(c - l, a) for a, (c, l) in enumerate(zip(cells, lo))]
    frac = [axis(f, a) for a, f in enumerate(fracs)]
    u = [_fade(f) for f in frac]
    out = torch.empty(tuple(shape), dtype=torch.float32, device=dev)
    row = int(np.prod(shape[1:]))
    step = max(1, SLAB_POINTS // max(row, 1))
    for x0 in range(0, shape[0], step):
        sl = slice(x0, min(x0 + step, shape[0]))
        ci = [cell_idx[0][sl]] + cell_idx[1:]
        fr = [frac[0][sl]] + frac[1:]
        uu = [u[0][sl]] + u[1:]
        acc = None
        for corner in np.ndindex(*(2,) * ndim):
            flat = sum((ci[a] + corner[a]) * strides[a] for a in range(ndim))
            grad = grads[flat]                        # (*slab, ndim)
            # np.sum(grad * disp, axis=-1) adds from 0.0, left to right
            dot = torch.zeros((), dtype=torch.float64, device=dev)
            for a in range(ndim):
                dot = dot + grad[..., a] * (fr[a] - corner[a])
            w = None
            for a in range(ndim):
                fa = uu[a] if corner[a] else (1 - uu[a])
                w = fa if w is None else w * fa       # np.ones * ... : 1*x == x
            term = dot * w
            acc = term if acc is None else acc + term
        out[sl] = acc.to(torch.float32)
    return out

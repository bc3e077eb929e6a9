"""`np.quantile(x, q)` (method "linear") on a tensor, value for value.

The feature mask of the paper's CC workload is ``field > quantile(field,
0.9)`` (`examples/quickstart.py`).  `torch.quantile` refuses inputs above
2**24 elements, so the order statistics come from `torch.kthvalue` on the
tensor's device and the interpolation runs on the host with numpy scalars of
the tensor's dtype, as numpy's own `_quantile` does: numpy 2 computes the
virtual index and the interpolation of a float32 array in float32.
"""
from __future__ import annotations

import numpy as np
import torch


def quantile(x: torch.Tensor, q: float):
    """The `q`-quantile of all of `x`'s values (linear interpolation), as
    the numpy scalar `np.quantile(x.numpy(), q)` returns.  NaNs are not
    supported."""
    flat = x.reshape(-1)
    n = flat.numel()
    dt = np.dtype(str(flat.dtype).removeprefix("torch."))
    qa = np.asanyarray(q, dtype=dt) if dt.kind == "f" else np.asanyarray(q)
    virtual = np.asanyarray((n - 1) * qa)          # linear: alpha = beta = 1
    prev = np.asanyarray(np.floor(virtual))
    nxt = np.asanyarray(prev + 1)
    if virtual >= n - 1:
        prev = nxt = np.asanyarray(n - 1)
    elif virtual < 0:
        prev = nxt = np.asanyarray(0)
    prev, nxt = int(prev), int(nxt)
    gamma = np.asanyarray(virtual - prev, dtype=virtual.dtype)
    a, b = (flat.kthvalue(k + 1).values.item() for k in (prev, nxt))
    a, b = dt.type(a), dt.type(b)
    # numpy's _lerp: a + (b-a)*t, or b - (b-a)*(1-t) where t >= 0.5
    diff = np.subtract(b, a)
    lerp = np.asanyarray(np.add(a, diff * gamma))
    if gamma >= 0.5:
        lerp = np.asanyarray(np.subtract(b, diff * (1 - gamma))).astype(
            lerp.dtype)
    return lerp[()]

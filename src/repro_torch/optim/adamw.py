"""AdamW and SGD over the port's parameter trees (port of
`repro/optim/adamw.py`), with JAX's functional contract: an `Optimizer` is
(init, update), `update(grads, state, params)` returns (new params, new
state, {"grad_norm", "lr"}) as new tensors and changes none of its
arguments in place (the training driver restarts from its initial state).

The state mirrors the parameter tree: "m", "v" (AdamW) in `moment_dtype`
(fp32 default) and "step", a 0-d int32 tensor on the device of the first
parameter.  Every update computes in fp32 and casts back, and
`apply_updates` adds in fp32 and casts to the parameter's dtype, as JAX
does."""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params) -> (params, state, metrics)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32, leaves in JAX's
    order."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float, norm_fn=global_norm):
    """(the tree scaled by min(1, max_norm / max(norm, 1e-9)), the norm);
    `norm_fn` gives the norm (a sharded tree's needs its mesh:
    `models.lm.global_norm_fn`)."""
    norm = norm_fn(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), tree), norm


def apply_updates(params, updates):
    """params + updates, added in fp32, cast to each parameter's dtype."""
    return tree_map(lambda p, u: (p.float() + u).to(p.dtype), params,
                    updates)


def _step_tensor(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def _lr_fn(lr):
    """A schedule fn(step) -> lr, or a constant lr as one."""
    return lr if callable(lr) else (lambda _: lr)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, grad_clip: float = 1.0,
          moment_dtype=torch.float32, norm_fn=global_norm) -> Optimizer:
    """lr: a float or a schedule fn(step tensor) -> lr; norm_fn: the
    gradient tree's global norm (`clip_by_global_norm`)."""
    lr_fn = _lr_fn(lr)

    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": _step_tensor(params)}

    def update(grads, state, params):
        step = state["step"] + 1
        if grad_clip:
            grads, gnorm = clip_by_global_norm(grads, grad_clip, norm_fn)
        else:
            gnorm = norm_fn(grads)
        lr_t = lr_fn(step)
        stepf = step.float()
        bc1, bc2 = 1 - b1 ** stepf, 1 - b2 ** stepf

        def upd(g, m, v, p):
            g32 = g.float()
            m32 = m.float() * b1 + g32 * (1 - b1)
            v32 = v.float() * b2 + g32 * g32 * (1 - b2)
            u = -lr_t * (m32 / bc1 / (torch.sqrt(v32 / bc2) + eps)
                         + weight_decay * p.float())
            return u, m32.to(moment_dtype), v32.to(moment_dtype)

        # (u, m, v) at each leaf; the params' structure picks them apart
        out = tree_map(upd, grads, state["m"], state["v"], params)
        updates, new_m, new_v = (tree_map(lambda _, t: t[i], params, out)
                                 for i in range(3))
        return (apply_updates(params, updates),
                {"m": new_m, "v": new_v, "step": step},
                {"grad_norm": gnorm, "lr": lr_t})

    return Optimizer(init, update)


def sgd(lr, momentum: float = 0.9, grad_clip: float = 0.0,
        norm_fn=global_norm) -> Optimizer:
    """SGD with momentum in fp32 (no weight decay); norm_fn as adamw's."""
    lr_fn = _lr_fn(lr)

    def init(params):
        return {"m": tree_map(lambda p: torch.zeros(
                    p.shape, dtype=torch.float32, device=p.device), params),
                "step": _step_tensor(params)}

    def update(grads, state, params):
        step = state["step"] + 1
        if grad_clip:
            grads, gnorm = clip_by_global_norm(grads, grad_clip, norm_fn)
        else:
            gnorm = norm_fn(grads)
        lr_t = lr_fn(step)
        new_m = tree_map(lambda m, g: m * momentum + g.float(), state["m"],
                         grads)
        updates = tree_map(lambda m: -lr_t * m, new_m)
        return (apply_updates(params, updates), {"m": new_m, "step": step},
                {"grad_norm": gnorm, "lr": lr_t})

    return Optimizer(init, update)

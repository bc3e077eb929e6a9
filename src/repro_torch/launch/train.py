"""End-to-end training launcher (port of `repro/launch/train.py`), with
JAX's flags plus `--device` (``cuda`` unless given):

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --smoke --steps 300 --batch 8 --seq 128 --device cpu

config -> parameters (drawn from a `torch.Generator` seeded with `--seed`,
on the device) -> the train step (`lm.loss_fn`, its gradient, AdamW with a
warmup-cosine schedule) -> the fault-tolerant driver (periodic checkpoints
written on a thread, restart on failure, straggler monitor) -> a final
evaluation of 4 fresh batches.  `--chaos` injects one failure at 60% of the
steps.  It drives the LM archs, dense and MoE.  `main` returns (eval
loss, the driver's report).

On one process nothing is sharded.  Under `torchrun` (or in a process
whose default group is initialised with more than one rank) it binds
`launch.mesh.make_smoke_mesh()` (or the `mesh` given to `main`) as JAX's
launcher does: parameters and moments are cut to each rank's FSDP x TP
blocks (`lm.shard_params`), each rank trains on its "dp" block of the
batch, the gradient norm is the global one (`lm.global_norm_fn`), and
checkpoints hold the whole state (`CheckpointManager(specs=...)`).
`torchrun` ranks join over NCCL with a card each, over gloo when they
share one card or run on the CPU:

  torchrun --nproc-per-node 2 -m repro_torch.launch.train --smoke \\
      --arch deepseek-moe-16b --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch._device import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data.tokens import TokenStream
from repro_torch.launch.mesh import join_torchrun, make_smoke_mesh
from repro_torch.models import lm
from repro_torch.optim import adamw, global_norm, warmup_cosine
from repro_torch.runtime.driver import TrainDriver
from repro_torch.runtime.meshctx import LOGICAL_AXES, use_mesh
from repro_torch.tree import tree_map


def _to_device(batch: dict, dev, mesh=None) -> dict:
    """A numpy batch on `dev`; on a mesh this rank's "dp" block of it."""
    out = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    if mesh is not None:
        dp = LOGICAL_AXES["dp"]
        out = {k: mesh.block(v, dp, 0) for k, v in out.items()}
    return out


def state_specs(cfg):
    """Logical specs of the (params, AdamW state) training state."""
    pspecs = lm.param_logical_specs(cfg)
    return (pspecs, {"m": pspecs, "v": pspecs, "step": ()})


def make_step(cfg, opt, dev, mesh=None):
    """The train step (state, numpy batch) -> (state, metrics): the loss,
    its gradient by autograd and one optimizer update, which returns new
    tensors, so `state` is never changed in place.  On a mesh the state
    holds this rank's blocks and the step runs under it."""
    def step_fn(state, batch):
        params, opt_state = state
        leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, metrics = lm.loss_fn(leaves, _to_device(batch, dev, mesh),
                                   cfg)
        loss.backward()
        grads = tree_map(lambda t: t.grad, leaves)
        params, opt_state, om = opt.update(grads, opt_state, params)
        return (params, opt_state), {
            "loss": loss.detach(),
            **{k: v.detach() for k, v in metrics.items()}, **om}
    return step_fn


def main(argv=None, mesh=None):
    """Run the launcher on `argv`.  `mesh`: the mesh to bind when the
    default group has several ranks (default `make_smoke_mesh()`)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--chaos", action="store_true",
                    help="inject a failure at 60%% progress (demo)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain versions)")
    args = ap.parse_args(argv)

    mod = configs.get(args.arch)
    if mod.FAMILY != "lm":
        raise ValueError(f"train.py drives LM archs, not {args.arch!r}")
    cfg = mod.smoke_config() if args.smoke else mod.full_config()
    if args.seq % cfg.loss_chunks:
        cfg = dataclasses.replace(cfg, loss_chunks=1)
    dev = join_torchrun(resolve_device(args.device))
    if not (dist.is_initialized() and dist.get_world_size() > 1):
        mesh = None
    elif mesh is None:
        mesh = make_smoke_mesh(device=dev)
    first = mesh is None or mesh.rank == 0
    if first:
        print(f"[train] {cfg.name}: {cfg.n_params():,} params "
              f"({cfg.n_active_params():,} active) on {dev}"
              + (f", mesh {mesh.shape}" if mesh else ""))

    params = lm.init_params(torch.Generator(device=dev).manual_seed(
        args.seed), cfg)
    norm_fn = global_norm
    if mesh is not None:
        cfg = lm.bind_mesh(cfg, mesh)
        params = lm.shard_params(params, cfg, mesh)
        norm_fn = lm.global_norm_fn(cfg, mesh)
    opt = adamw(warmup_cosine(args.lr, 20, args.steps), weight_decay=0.01,
                norm_fn=norm_fn)

    def make_data(start):
        return TokenStream(cfg.vocab, args.batch, args.seq, seed=args.seed,
                           start_step=start)

    chaos = {"armed": args.chaos}

    def injector(step):
        if chaos["armed"] and step == int(args.steps * 0.6):
            chaos["armed"] = False
            return True
        return False

    driver = TrainDriver(
        step_fn=make_step(cfg, opt, dev, mesh),
        init_state=(params, opt.init(params)), make_data=make_data,
        ckpt=CheckpointManager(args.ckpt_dir, keep_last=2,
                               specs=state_specs(cfg) if mesh else None),
        ckpt_every=args.ckpt_every,
        failure_injector=injector if args.chaos else None,
        log_every=max(args.steps // 20, 1))
    with use_mesh(mesh):
        state, report = driver.run(args.steps)

        # final eval on fresh batches
        stream = make_data(10_000)
        with torch.no_grad():
            losses = [float(lm.loss_fn(state[0], _to_device(
                next(stream), dev, mesh), cfg)[0]) for _ in range(4)]
    if first:
        print(f"[train] done: eval_loss={np.mean(losses):.4f} "
              f"report={report}")
    return np.mean(losses), report


if __name__ == "__main__":
    main()

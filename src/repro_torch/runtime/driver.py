"""Fault-tolerant training driver (port of `repro/runtime/driver.py`):
periodic checkpoints (atomic, optionally written on a thread), restore from
the latest one plus a data-stream seek on a failure, so a failure costs at
most `ckpt_every` steps of recompute; a failure-injection hook, so the
restart path is tested; and a straggler monitor: an EWMA of the step's wall
time, steps slower than `straggler_factor` times it logged and counted.

A step's wall time ends at a `torch.cuda.synchronize()` of the device of
the state's first tensor when that is a CUDA device (the CPU needs none).
`init_state` is what a restart without a checkpoint starts from, so the
step function must not change it in place (`repro_torch.optim`'s updates
return new tensors)."""
from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING, Any, Callable, Iterator, Optional

import torch
import torch.distributed as dist

from repro_torch.tree import tree_leaves

if TYPE_CHECKING:
    from repro_torch.checkpoint import CheckpointManager


class InjectedFailure(RuntimeError):
    """Simulated node failure (tests and chaos runs)."""


@dataclasses.dataclass
class StragglerStats:
    ewma: float = 0.0
    count: int = 0
    worst: float = 0.0


def _sync(state) -> None:
    """Wait for the device of the state's first tensor, if it is CUDA."""
    for leaf in tree_leaves(state):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_cuda:
                torch.cuda.synchronize(leaf.device)
            return


@dataclasses.dataclass
class TrainDriver:
    step_fn: Callable            # (state, batch) -> (state, metrics)
    init_state: Any              # a tree (params, opt_state, ...)
    make_data: Callable[[int], Iterator]   # start_step -> iterator
    ckpt: CheckpointManager
    ckpt_every: int = 50
    max_restarts: int = 3
    failure_injector: Optional[Callable[[int], bool]] = None
    straggler_factor: float = 3.0
    log_every: int = 10
    verbose: bool = True

    def _log(self, *a):
        if self.verbose and (not dist.is_initialized() or
                             dist.get_rank() == 0):
            print("[driver]", *a, flush=True)

    def run(self, n_steps: int):
        """Run to `n_steps` total (absolute), restarting on failures.
        Returns (state, {"restarts", "stragglers", "worst_step_ratio"})."""
        restarts = 0
        straggler = StragglerStats()
        state, start = self._restore_or_init()
        while True:
            try:
                state, start = self._run_from(state, start, n_steps,
                                              straggler)
                self.ckpt.wait()
                return state, {"restarts": restarts,
                               "stragglers": straggler.count,
                               "worst_step_ratio": straggler.worst}
            except InjectedFailure as e:
                restarts += 1
                self._log(f"FAILURE at step {start}: {e}; "
                          f"restart {restarts}/{self.max_restarts}")
                if restarts > self.max_restarts:
                    raise
                state, start = self._restore_or_init()

    def _restore_or_init(self):
        restored, manifest = self.ckpt.restore(self.init_state)
        if restored is None:
            return self.init_state, 0
        step = int(manifest["step"])
        self._log(f"restored checkpoint at step {step}")
        return restored, step

    def _run_from(self, state, start: int, n_steps: int,
                  straggler: StragglerStats):
        data = self.make_data(start)
        for step in range(start, n_steps):
            if self.failure_injector and self.failure_injector(step):
                raise InjectedFailure(f"injected at step {step}")
            batch = next(data)
            t0 = time.perf_counter()
            state, metrics = self.step_fn(state, batch)
            _sync(state)
            dt = time.perf_counter() - t0
            # straggler detection (EWMA of the steady-state step time)
            if step > start + 2:  # skip the warm-up steps
                if straggler.ewma == 0.0:
                    straggler.ewma = dt
                ratio = dt / straggler.ewma
                if ratio > self.straggler_factor:
                    straggler.count += 1
                    straggler.worst = max(straggler.worst, ratio)
                    self._log(f"straggler step {step}: {dt * 1e3:.1f}ms "
                              f"({ratio:.1f}x EWMA)")
                straggler.ewma = 0.9 * straggler.ewma + 0.1 * dt
            if self.log_every and step % self.log_every == 0:
                flat = {k: float(v) for k, v in metrics.items()
                        if not isinstance(v, torch.Tensor) or v.ndim == 0}
                self._log(f"step {step}: {flat}")
            if (step + 1) % self.ckpt_every == 0:
                self.ckpt.save(step + 1, state)
        return state, n_steps

"""Multi-pod dry run (port of `repro/launch/dryrun.py`): build every
(architecture x input-shape) cell on the production meshes and record its
memory, cost and collectives, as JAX records XLA's analyses of the
compiled program.

  PYTHONPATH=src python -m repro_torch.launch.dryrun                # all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch kimi-k2-1t-a32b \\
      --shape train_4k --multi-pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --smoke        # tiny

It runs in one process on the host: a fake process group
(`torch.distributed` backend "fake") of 256 or 512 ranks stands for the
mesh, and rank 0's step (`Cell.step_fn` on rank 0's blocks of meta
tensors, `launch.cells`) is traced on the meta device, so nothing is
allocated and no collective moves data.  Records land in
<out>/<mesh>/<arch>__<shape>.json with JAX's keys:

  memory       argument bytes (rank 0's blocks), output bytes, temp as the
               peak of the bytes the step allocates beyond its arguments
               (live storages followed op by op), alias as the donated
               arguments' bytes, and generated code 0 (an eager program
               has none);
  cost         `flops` from `torch.utils.flop_counter.FlopCounterMode`
               plus the kernels' formulas (`_meta`), `bytes accessed` as
               the operand plus result bytes of each op (views and bare
               allocations excluded; the kernels' bytes read once and
               written once), the eager counterpart of XLA's figure;
  collectives  the result-shape bytes of every collective the meshes issue
               (`_meta.counting`), under JAX's keys;
  compile_s    the trace's seconds (there is nothing to compile), and
               lower_s the cell's build seconds.

The DPC cells' fixpoint loops run their bodies once on meta (`_meta.again`),
as XLA costs a `while` body once: their terms are per doubling round.
Exits 1 on any failure.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import _meta
from repro_torch.launch.cells import all_cells, build_cell
from repro_torch.launch.mesh import make_production_mesh

MESHES = {"pod256": (False, 256), "pod2x256": (True, 512)}

_aten = torch.ops.aten
_ALLOCS = {_aten.empty.memory_format, _aten.empty_like.default,
           _aten.empty_strided.default, _aten.new_empty.default,
           _aten.new_empty_strided.default}


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _key(t):
    return t.untyped_storage()._cdata


class _Trace(TorchDispatchMode):
    """Per-op bytes (operands plus results) and the live bytes of the
    storages the traced ops allocate, followed until their last tensor
    dies; `peak` is their largest sum."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._refs = {}

    def _drop(self, key):
        ref = self._refs[key]
        ref[0] -= 1
        if ref[0] == 0:
            self.live -= ref[1]
            del self._refs[key]

    def _hold(self, t, key):
        self._refs[key][0] += 1
        weakref.finalize(t, self._drop, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if func not in _ALLOCS and not func.is_view:
            self.bytes += sum(map(_meta.nbytes, ins)) + sum(
                map(_meta.nbytes, outs))
        in_keys = {_key(t) for t in ins}
        for t in outs:
            k = _key(t)
            if k in self._refs:
                self._hold(t, k)
            elif k not in in_keys:               # a fresh storage
                self._refs[k] = [0, t.untyped_storage().nbytes()]
                self.live += self._refs[k][1]
                self.peak = max(self.peak, self.live)
                self._hold(t, k)
        return out


@contextlib.contextmanager
def fake_world(size: int):
    """A fake process group of `size` ranks in this process, as rank 0
    (destroyed on exit)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def trace_cell(cell):
    """Run `cell.step_fn` on rank 0's blocks of its meta arguments under
    the counters: (memory, cost, collectives, trace seconds, kernels)."""
    args = cell.local(cell.arg_shapes)
    arg_bytes = sum(map(_meta.nbytes, _tensors(args)))
    alias = sum(_meta.nbytes(t) for i in cell.donate_argnums
                for t in _tensors(args[i]))
    t0 = time.time()
    with _meta.counting() as counts, FlopCounterMode(display=False) as fc, \
            _Trace() as tr:
        out = cell.step_fn(*args)
        out_bytes = sum(map(_meta.nbytes, _tensors(out)))
        del out
    seconds = time.time() - t0
    memory = {"argument_size_in_bytes": int(arg_bytes),
              "output_size_in_bytes": int(out_bytes),
              "temp_size_in_bytes": int(tr.peak),
              "generated_code_size_in_bytes": 0,
              "alias_size_in_bytes": int(alias)}
    cost = {"flops": float(fc.get_total_flops() + counts.kernel_flops),
            "bytes accessed": float(tr.bytes + counts.kernel_bytes)}
    return memory, cost, counts.collectives, seconds, counts.kernel_calls


def run_cell(arch, shape_name, mesh, mesh_label, smoke, out_dir,
             cfg_transform=None, tag=""):
    t0 = time.time()
    cell = build_cell(arch, shape_name, mesh, smoke=smoke,
                      cfg_transform=cfg_transform)
    t_lower = time.time() - t0
    memory, cost, coll, t_trace, kernels = trace_cell(cell)
    rec = {
        "cell": cell.name, "mesh": mesh_label,
        "mesh_shape": dict(mesh.shape), "smoke": smoke, "rank": mesh.rank,
        "memory": memory, "cost": cost, "collectives": coll,
        "kernels": kernels,
        "lower_s": round(t_lower, 2), "compile_s": round(t_trace, 2),
        "note": cell.note,
    }
    os.makedirs(out_dir, exist_ok=True)
    fname = f"{arch.replace('-', '_')}__{shape_name}" + \
        (f"__{tag}" if tag else "") + ".json"
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(rec, f, indent=1)
    per_dev = memory["argument_size_in_bytes"] + memory["temp_size_in_bytes"]
    print(f"[dryrun] OK {cell.name} @ {mesh_label} "
          f"args+temp/dev={per_dev / 2**30:.2f}GiB "
          f"flops/dev={cost['flops']:.3e} "
          f"coll={coll['total'] / 2**20:.1f}MiB "
          f"(build {t_lower:.0f}s trace {t_trace:.0f}s)", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    labels = []
    if args.single_pod or not args.multi_pod:
        labels.append("pod256")
    if args.multi_pod or not args.single_pod:
        labels.append("pod2x256")

    cells = all_cells()
    if args.arch:
        cells = [(a, s) for a, s in cells
                 if a == args.arch or a.replace("_", "-") == args.arch]
    if args.shape:
        cells = [(a, s) for a, s in cells if s == args.shape]

    failures = []
    for label in labels:
        multi_pod, size = MESHES[label]
        out_dir = os.path.join(args.out, label)
        with fake_world(size):
            mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
            for arch, shape_name in cells:
                fname = os.path.join(
                    out_dir, f"{arch.replace('-', '_')}__{shape_name}.json")
                if args.skip_existing and os.path.exists(fname):
                    print(f"[dryrun] skip {arch}:{shape_name} @ {label}")
                    continue
                try:
                    run_cell(arch, shape_name, mesh, label, args.smoke,
                             out_dir)
                except Exception as e:  # noqa: BLE001 — report, keep going
                    failures.append((label, arch, shape_name, repr(e)))
                    print(f"[dryrun] FAIL {arch}:{shape_name} @ {label}: "
                          f"{e}", flush=True)
                    traceback.print_exc()
    print(f"[dryrun] done; {len(failures)} failures")
    for f in failures:
        print("  FAIL:", *f)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()

"""Checkpoints of the port's training state (port of
`repro/checkpoint/manager.py`), with JAX's layout: <dir>/step_<N>/ holds
arrays.npz and manifest.json, staged under a ".tmp" name and renamed into
place, so a killed writer never leaves a half-written checkpoint behind;
`keep_last` checkpoints are kept; the file write can run on a thread.

A leaf's name joins its keys and indices with "/" (`tree.tree_map_with_names`).
numpy has no bfloat16: a bfloat16 tensor is stored as its uint16 bits,
and the manifest's "dtypes" names every leaf's torch dtype, so a restore
gives the same bits back.  `restore` places each leaf on its template
leaf's device and dtype, and checks its shape.

A state sharded on a mesh (`runtime.meshctx`) is saved whole: given its
tree of logical specs (`specs`, e.g. `models.lm.param_logical_specs` for
the parameters and for each optimizer moment, () for the step) and with
the mesh bound, each leaf is all-gathered, rank 0 writes, and the other
ranks meet it at a barrier before the next save or any restore.  Loading
into a template sharded on the bound mesh, which need not be the saving
one, cuts every stored array to this rank's block: JAX's elastic
reshard."""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch.runtime.meshctx import (gather_blocks, get_current_mesh,
                                         local_block, logical_to_spec,
                                         shard_count)
from repro_torch.tree import tree_map, tree_map_with_names


class _Spec:
    """A leaf paired with its logical spec (a leaf of the trees below)."""

    def __init__(self, leaf, spec):
        self.leaf, self.spec = leaf, tuple(spec)


def _sharded(tree, specs):
    """(the tree with each leaf paired with its spec, the bound mesh), or
    (the tree, None) without specs or a mesh."""
    mesh = get_current_mesh()
    if specs is None or mesh is None:
        return tree, None
    return tree_map(_Spec, tree, specs), mesh


def _host(leaf):
    """A leaf as (a host numpy copy, dtype name): a tensor is copied to the
    host (a bfloat16 one as its uint16 bits), a CPU one too, since later
    steps may change it in place; anything else via numpy."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), name
        return t.numpy(), name
    a = np.array(leaf)
    return a, a.dtype.name


def _snapshot(tree, specs=None) -> dict:
    """{name: (host numpy array, dtype name)} of every leaf; with `specs`
    and a bound mesh, each leaf gathered whole (every rank joins; rank 0
    keeps the copies, the others get {})."""
    tree, mesh = _sharded(tree, specs)
    out = {}

    def take(name, leaf):
        if mesh is not None:
            leaf = gather_blocks(leaf.leaf, logical_to_spec(leaf.spec, mesh),
                                 mesh)
            if mesh.rank:
                return
        out[name] = _host(leaf)

    tree_map_with_names(take, tree)
    return out


def _write(path: str, named: dict, step, extra):
    """Write a snapshot to <path>/ through a staged <path>.tmp."""
    stage = path + ".tmp"
    if os.path.exists(stage):
        shutil.rmtree(stage)
    os.makedirs(stage)
    np.savez(os.path.join(stage, "arrays.npz"),
             **{k: a for k, (a, _) in named.items()})
    manifest = {"step": step, "keys": sorted(named),
                "dtypes": {k: dt for k, (_, dt) in named.items()},
                "time": time.time(), "extra": extra or {}}
    with open(os.path.join(stage, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(stage, path)


def save_pytree(path: str, tree, step: int | None = None,
                extra: dict | None = None):
    """Write the tree's leaves to <path>/ (staged, then renamed)."""
    _write(path, _snapshot(tree), step, extra)


def _leaf(a: np.ndarray, dtype_name: str | None, tmpl):
    """A stored array back as `tmpl`'s kind: a tensor on tmpl's device and
    dtype (bfloat16 from its stored bits), else a numpy array."""
    if not isinstance(tmpl, torch.Tensor):
        return a
    if dtype_name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=tmpl.device, dtype=tmpl.dtype)


def load_pytree(path: str, template, specs=None):
    """The checkpoint at <path>/ in `template`'s structure, each leaf on
    its template leaf's device and dtype; raises KeyError on a missing
    leaf and ValueError on a shape that differs.  With `specs` and a bound
    mesh the template holds this rank's blocks, and each stored (whole)
    array is cut to this rank's block under its spec on that mesh."""
    dtypes = {}
    manifest = os.path.join(path, "manifest.json")
    if os.path.exists(manifest):
        with open(manifest) as f:
            dtypes = json.load(f).get("dtypes", {})
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}

    template, mesh = _sharded(template, specs)

    def one(name, tmpl):
        if name not in arrays:
            raise KeyError(f"checkpoint missing leaf {name}")
        a = arrays[name]
        spec = None
        if mesh is not None:
            tmpl, spec = tmpl.leaf, logical_to_spec(tmpl.spec, mesh)
        want = tuple(np.shape(tmpl))
        if spec is not None:
            want = tuple(n * shard_count((p,), mesh)
                         for n, p in zip(want, spec))
        if tuple(a.shape) != want:
            raise ValueError(f"shape mismatch for {name}: {a.shape} vs "
                             f"{want}")
        if spec is not None:
            a = local_block(torch.from_numpy(a), spec,
                            mesh).contiguous().numpy()
        return _leaf(a, dtypes.get(name), tmpl)

    return tree_map_with_names(one, template)


class CheckpointManager:
    """`specs`: the state's tree of logical specs when it is sharded on the
    mesh bound around `save` and `restore` (module docstring)."""

    def __init__(self, directory: str, keep_last: int = 3,
                 async_write: bool = True, specs=None):
        self.dir = directory
        self.keep_last = keep_last
        self.async_write = async_write
        self.specs = specs
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def steps(self):
        return sorted(int(d.split("_")[1]) for d in os.listdir(self.dir)
                      if d.startswith("step_") and not d.endswith(".tmp"))

    def latest_step(self):
        s = self.steps()
        return s[-1] if s else None

    def wait(self):
        """Join the writer thread; re-raise what it raised.  On a mesh,
        every rank then meets at a barrier, so the written checkpoint is
        seen by all."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        mesh = get_current_mesh()
        if self.specs is not None and mesh is not None:
            mesh.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree, extra: dict | None = None):
        """Copy every leaf to host numpy before returning (later steps
        update the state); the file write overlaps the next train steps
        when `async_write`."""
        self.wait()
        named = _snapshot(tree, self.specs)
        if not named:
            return                      # a rank other than 0 on a mesh

        def write():
            _write(self._step_dir(step), named, step, extra)
            self._gc()

        if not self.async_write:
            write()
            return

        def run():
            try:
                write()
            except Exception as e:        # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def restore(self, template, step: int | None = None):
        """(the checkpoint at `step` (default the latest) in `template`'s
        structure, its manifest), or (None, None) when there is none."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        path = self._step_dir(step)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        return load_pytree(path, template, self.specs), manifest

    def _gc(self):
        for s in self.steps()[:-self.keep_last]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

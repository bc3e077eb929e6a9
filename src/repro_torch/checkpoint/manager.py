"""Checkpoints of the port's training state (port of
`repro/checkpoint/manager.py`), with JAX's layout: <dir>/step_<N>/ holds
arrays.npz and manifest.json, staged under a ".tmp" name and renamed into
place, so a killed writer never leaves a half-written checkpoint behind;
`keep_last` checkpoints are kept; the file write can run on a thread.

A leaf's name joins its keys and indices with "/" (`tree.tree_map_with_names`).
numpy has no bfloat16: a bfloat16 tensor is stored as its uint16 bits,
and the manifest's "dtypes" names every leaf's torch dtype, so a restore
gives the same bits back.  `restore` places each leaf on its template
leaf's device and dtype, and checks its shape."""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch.tree import tree_map_with_names


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


def _snapshot(tree) -> dict:
    """{name: (host numpy array, dtype name)} of every leaf."""
    out = {}

    def take(name, leaf):
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


def load_pytree(path: str, template):
    """The checkpoint at <path>/ in `template`'s structure, each leaf on
    its template leaf's device and dtype; raises KeyError on a missing
    leaf and ValueError on a shape that differs."""
    dtypes = {}
    manifest = os.path.join(path, "manifest.json")
    if os.path.exists(manifest):
        with open(manifest) as f:
            dtypes = json.load(f).get("dtypes", {})
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}

    def one(name, tmpl):
        if name not in arrays:
            raise KeyError(f"checkpoint missing leaf {name}")
        a = arrays[name]
        if tuple(a.shape) != tuple(np.shape(tmpl)):
            raise ValueError(f"shape mismatch for {name}: {a.shape} vs "
                             f"{tuple(np.shape(tmpl))}")
        return _leaf(a, dtypes.get(name), tmpl)

    return tree_map_with_names(one, template)


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3,
                 async_write: bool = True):
        self.dir = directory
        self.keep_last = keep_last
        self.async_write = async_write
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
        """Join the writer thread; re-raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree, extra: dict | None = None):
        """Copy every leaf to host numpy before returning (later steps
        update the state); the file write overlaps the next train steps
        when `async_write`."""
        self.wait()
        named = _snapshot(tree)

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
        return load_pytree(path, template), manifest

    def _gc(self):
        for s in self.steps()[:-self.keep_last]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

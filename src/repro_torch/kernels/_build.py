"""Builds the port's CUDA C++ sources with nvcc at first use and loads them
with ctypes.

Each source under `csrc/` becomes one shared library with a plain C
interface in `<checkout>/build/kernels/`, named by a hash of its source and
flags so that an edited source is rebuilt.  nvcc runs only when a kernel is
first needed on a CUDA tensor, never at import; `build()` starts one nvcc
per source, all at once.  ptxas's register and spill report for each
library is kept beside it as `<library>.log`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"fused_local_phase": _CSRC / "fused_local_phase.cu"}
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libraries: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then $PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and $PATH); the CUDA kernels "
                           "are built from source at first use")
    return found


def library_path(name: str) -> Path:
    src = SOURCES[name]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=None) -> dict:
    """Build the named libraries (default: all) that are not built yet, one
    nvcc per source, all started together.  Returns {name: library path};
    raises with nvcc's output if one fails."""
    names = list(SOURCES if names is None else names)
    paths = {name: library_path(name) for name in names}
    todo = [name for name in names if not paths[name].exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    procs = {}
    for name in todo:
        tmp = paths[name].with_suffix(f".so.tmp{os.getpid()}")
        procs[name] = (tmp, subprocess.Popen(
            [compiler, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        paths[name].with_suffix(".so.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def build_log(name: str) -> str:
    """nvcc/ptxas output of the last build of `name`."""
    return library_path(name).with_suffix(".so.log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The library for `name`, built first if needed (cached per process)."""
    if name not in _libraries:
        _libraries[name] = ctypes.CDLL(str(build([name])[name]))
    return _libraries[name]

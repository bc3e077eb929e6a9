"""Builds the port's CUDA C++ sources with nvcc at first use and loads them
with ctypes, and holds the checks every kernel wrapper makes around a launch.

Each source under `csrc/` becomes one shared library with a plain C
interface in `<checkout>/build/kernels/`, named by a hash of its source,
the shared headers (`csrc/*.cuh`) and the flags, so that an edited source
or header is rebuilt.  nvcc runs only when a kernel is
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

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {name: _CSRC / f"{name}.cu" for name in (
    "fused_local_phase", "steepest_neighbor", "block_pathcompress",
    "segment_bag", "flash_attention")}
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
    text = SOURCES[name].read_bytes() + b"".join(
        h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:12]
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


def entry(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """C function `symbol` of library `name`, declared with `argtypes` and
    returning a cudaError_t as an int."""
    fn = getattr(load(name), symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def raise_on_error(name: str, err: int) -> None:
    """Raise if a launch of library `name` returned a CUDA error (each
    library exports `<name>_error_string`)."""
    if err:
        describe = getattr(load(name), f"{name}_error_string")
        describe.argtypes, describe.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{name} CUDA error {err}: "
                           f"{describe(err).decode()}")


def check_tensor(t: torch.Tensor, what: str, dtypes, shape=None) -> None:
    """Raise ValueError unless `t` is a contiguous CUDA tensor of one of
    `dtypes` (and of `shape`, where given)."""
    if not t.is_cuda:
        raise ValueError(f"{what} must be a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        names = " or ".join(str(d) for d in dtypes)
        raise ValueError(f"{what} must be {names}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def stream(t: torch.Tensor) -> int:
    """The current CUDA stream of `t`'s device, as the pointer a C entry
    point takes (call inside ``torch.cuda.device(t.device)``)."""
    return torch.cuda.current_stream(t.device).cuda_stream

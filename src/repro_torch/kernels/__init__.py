"""Kernels of the port: CUDA C++ sources under `csrc/`, their ctypes
wrappers, their plain PyTorch versions (`ref.py`) and the dispatch
(`ops.py`).  Nothing is compiled at import: `_build` runs nvcc at first use
on a CUDA tensor."""

"""PyTorch/CUDA port of `repro` (Distributed Path Compression, Will et al.
2024): Morse-Smale segmentations and connected components of structured
grids and edge-list graphs by pointer doubling.

The package mirrors `repro`'s module names, so each JAX module has its
counterpart here at the same relative path.  It imports torch and numpy,
never jax and never `repro`.  Entry points (`topology.submit`,
`data.perlin_noise`) run on ``"cuda"`` unless the caller passes
``device="cpu"``; without CUDA they raise instead of falling back.

Every Pallas kernel of `repro` has a CUDA C++ counterpart for Hopper behind
`kernels.ops` (`fused_local_phase`, `steepest_neighbor`,
`block_pathcompress`, `flash_attention`, `embedding_bag`): it runs on CUDA
tensors, and its plain PyTorch version on CPU tensors.  Labels are
bit-identical to the JAX package on the same inputs.

The serving half of the LM and recsys substrate sits beside them: the dense
decoder-only LM (`models.lm`: prefill through the `flash_attention` kernel,
KV-cache decode), BST (`models.bst`: multi-hot bags through the
`segment_bag` kernel, retrieval), their configs (`configs.get`) and the
launcher `launch.serve`.  The launch tools (`launch.cells`, `launch.dryrun`)
trace any cell's per-rank program on the meta device (`_meta`: the
kernels' meta rules and the collective counts).
"""
from ._device import resolve_device

__all__ = ["resolve_device"]

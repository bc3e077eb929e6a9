"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here is marked `cuda` and skips without a CUDA device: a CUDA
kernel has no CPU mode (the plain versions are held to the JAX package by
the other `tests/test_torch_*.py` files).  This file imports neither jax nor
`repro`, so it runs on a machine that has only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import fused_local_phase as kmod, ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(mode, shape, seed, device):
    rng = np.random.default_rng(seed)
    if mode == "manifold":
        field = rng.permutation(int(np.prod(shape))).reshape(shape).astype(
            np.int32)
    else:
        field = rng.random(shape) < 0.6
    smask = rng.random(shape) < 0.2
    return (torch.from_numpy(field).to(device),
            torch.from_numpy(smask).to(device))


@pytest.mark.parametrize("mode", ["manifold", "cc"])
@pytest.mark.parametrize("conn", [6, 14, 18, 26])
def test_kernel_vs_plain(cuda, mode, conn):
    """Pointers and rounds exactly equal, ragged X, self_mask on and off,
    block_x 1/4/8; each launch counted once."""
    field, smask = _inputs(mode, (13, 11, 9), conn, cuda)
    before = kmod.launches[mode]
    for block_x in (1, 4, 8):
        for sm in (None, smask):
            got, rounds = ops.fused_local_phase(field, conn, mode=mode,
                                                self_mask=sm, block_x=block_x)
            want, wrounds = ref.fused_local_phase_ref(
                field, conn, mode=mode, self_mask=sm, block_x=block_x)
            torch.cuda.synchronize()
            assert got.dtype == want.dtype == torch.int32
            assert torch.equal(got, want) and rounds == wrounds
    assert kmod.launches[mode] - before == 6


def test_kernel_int64_ids(cuda):
    field, smask = _inputs("manifold", (9, 7, 5), 0, cuda)
    got, rounds = kmod.fused_local_phase(field, 14, self_mask=smask,
                                         block_x=4, id_dtype=torch.int64)
    want, wrounds = ref.fused_local_phase_ref(field, 14, self_mask=smask,
                                              block_x=4, id_dtype=torch.int64)
    assert got.dtype == torch.int64
    assert torch.equal(got, want) and rounds == wrounds


def test_kernel_rejects_what_it_cannot_take(cuda):
    field, smask = _inputs("manifold", (5, 4, 3), 1, cuda)
    with pytest.raises(ValueError, match="int32"):
        kmod.fused_local_phase(field.long(), 6)
    with pytest.raises(ValueError, match="contiguous"):
        kmod.fused_local_phase(field.transpose(0, 2), 6)
    with pytest.raises(ValueError, match="self_mask"):
        kmod.fused_local_phase(field, 6, self_mask=smask[:2])

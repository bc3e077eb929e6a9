"""The port's fused block-local phase against the JAX package.

On the CPU `repro_torch.kernels.ops.fused_local_phase` runs the kernel's
plain version (`repro_torch.kernels.ref.fused_local_phase_ref`).  It is held
to the JAX oracle `repro.kernels.ref.fused_local_phase_ref` on every case
(modes x connectivity 6/14/18/26 x self_mask x block_x {1, 4, 8} on a ragged
X), and to the Pallas kernel itself in interpret mode on a subset (each
interpret compile takes about a second).  Tolerance: pointers and rounds
exactly equal.  The CUDA kernel is held to the same plain version on the
card by `tests/test_torch_cuda.py` and `chip_smoke.py`.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.core.steepest as jst

from repro.kernels import ops as j_ops, ref as jref
from repro.kernels.fused_local_phase import fused_local_phase as j_kernel
from repro.core.pathcompress import path_compress as j_path_compress
from repro_torch.kernels import ops
from repro_torch.kernels import fused_local_phase as kmod
from repro_torch.core.pathcompress import path_compress
from repro_torch.core.steepest import grid_steepest, grid_mask_argmax

SHAPE = (13, 11, 9)     # X = 13: ragged last slab for block_x 4 and 8
CONNS = (6, 14, 18, 26)


@pytest.fixture(autouse=True)
def _jitted_jax_init(monkeypatch):
    """The JAX oracle calls grid_steepest / grid_mask_argmax eagerly, which
    compiles op by op (seconds at connectivity 26); the same functions
    jitted give the same arrays from one compile per shape."""
    monkeypatch.setattr(jst, "grid_steepest", _J_STEEPEST)
    monkeypatch.setattr(jst, "grid_mask_argmax", _J_MASK_ARGMAX)


_J_STEEPEST = jax.jit(jst.grid_steepest,
                      static_argnames=("connectivity", "descending"))
_J_MASK_ARGMAX = jax.jit(jst.grid_mask_argmax,
                         static_argnames=("connectivity",))


def _inputs(mode, conn, seed=0, shape=SHAPE):
    rng = np.random.default_rng(hash((mode, conn, seed)) % 2**31)
    if mode == "manifold":
        field = rng.permutation(int(np.prod(shape))).reshape(shape).astype(
            np.int32)
    else:
        field = rng.random(shape) < 0.6
    return field, rng.random(shape) < 0.2


def _port(field, conn, mode, smask, block_x, **kw):
    d, r = ops.fused_local_phase(
        torch.from_numpy(field), conn, mode=mode,
        self_mask=None if smask is None else torch.from_numpy(smask),
        block_x=block_x, **kw)
    return d.numpy(), r


@pytest.mark.parametrize("block_x", [1, 4, 8])
@pytest.mark.parametrize("with_mask", [False, True], ids=["nomask", "smask"])
@pytest.mark.parametrize("conn", CONNS)
@pytest.mark.parametrize("mode", ["manifold", "cc"])
def test_plain_vs_jax_oracle(mode, conn, with_mask, block_x):
    field, smask = _inputs(mode, conn)
    smask = smask if with_mask else None
    got, rounds = _port(field, conn, mode, smask, block_x)
    want, wrounds = jref.fused_local_phase_ref(
        jnp.asarray(field), conn, mode=mode,
        self_mask=None if smask is None else jnp.asarray(smask),
        block_x=block_x)
    assert got.dtype == np.asarray(want).dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))
    assert rounds == int(wrounds) >= 1


@pytest.mark.parametrize("conn,block_x,with_mask",
                         [(c, 4, True) for c in CONNS]
                         + [(6, 1, False), (6, 8, False)])
@pytest.mark.parametrize("mode", ["manifold", "cc"])
def test_plain_vs_pallas_interpret(mode, conn, block_x, with_mask):
    field, smask = _inputs(mode, conn, seed=1)
    smask = smask if with_mask else None
    got, rounds = _port(field, conn, mode, smask, block_x)
    want, wrounds = j_kernel(
        jnp.asarray(field), conn, mode=mode,
        self_mask=None if smask is None else jnp.asarray(smask),
        block_x=block_x, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert rounds == int(wrounds)


@pytest.mark.parametrize("mode", ["manifold", "cc"])
def test_plain_shares_the_fixpoint_of_the_init(mode):
    """The saturated pointers compress to the labels of the plain init
    (the contract that keeps final labels bit-identical), in the port and
    against JAX's path_compress."""
    field, _ = _inputs(mode, 14, seed=2)
    t = torch.from_numpy(field)
    init = grid_steepest(t, 14) if mode == "manifold" else \
        grid_mask_argmax(t, 14)
    want, _ = path_compress(init)
    d, _ = _port(field, 14, mode, None, 4)
    got, _ = path_compress(torch.from_numpy(d).reshape(-1))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    jwant, _ = j_path_compress(jnp.asarray(init.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jwant))


def test_int64_ids_match_int32():
    field, smask = _inputs("manifold", 6, seed=3)
    d32, r32 = _port(field, 6, "manifold", smask, 4)
    d64, r64 = _port(field, 6, "manifold", smask, 4, id_dtype=torch.int64)
    assert d64.dtype == np.int64 and r64 == r32
    np.testing.assert_array_equal(d64, d32)


@pytest.mark.parametrize("mode", ["manifold", "cc"])
def test_ref_impl_is_init_only(mode):
    """impl="ref": the plain init with the self_mask override and
    kernel_rounds == 0, equal to the JAX dispatch's impl="ref"."""
    field, smask = _inputs(mode, 14, seed=4)
    got, rounds = ops.fused_local_phase(
        torch.from_numpy(field), 14, mode=mode,
        self_mask=torch.from_numpy(smask), impl="ref")
    want, wrounds = j_ops.fused_local_phase(
        jnp.asarray(field), 14, mode=mode, self_mask=jnp.asarray(smask),
        impl="ref")
    assert rounds == int(wrounds) == 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_2d_and_other_connectivities_take_the_init_only_path():
    rng = np.random.default_rng(5)
    order2d = torch.from_numpy(rng.permutation(30).reshape(5, 6).astype(
        np.int32))
    d, r = ops.fused_local_phase(order2d, 4, impl="kernel")
    assert tuple(d.shape) == (5, 6) and r == 0
    np.testing.assert_array_equal(d.numpy().ravel(),
                                  grid_steepest(order2d, 4).numpy())


def test_kernel_impl_on_a_cpu_tensor_raises():
    field, _ = _inputs("manifold", 6, seed=6)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        ops.fused_local_phase(torch.from_numpy(field), 6, impl="kernel")
    with pytest.raises(ValueError, match="CUDA tensor"):
        kmod.fused_local_phase(torch.from_numpy(field), 6)


def test_dispatch_validation():
    field, _ = _inputs("manifold", 6, seed=7)
    t = torch.from_numpy(field)
    with pytest.raises(ValueError, match="impl"):
        ops.fused_local_phase(t, 6, impl="nope")
    with pytest.raises(ValueError, match="mode"):
        ops.fused_local_phase(t, 6, mode="nope")
    with pytest.raises(ValueError, match="3-D"):
        kmod.fused_local_phase(t[0], 6)
    with pytest.raises(ValueError, match="connectivit"):
        kmod.fused_local_phase(t, 5)


def test_entry_point_without_cuda_raises(monkeypatch):
    """No device named and no CUDA: the entry points raise instead of
    running on the CPU."""
    from repro_torch import topology
    from repro_torch.data import perlin_noise
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    field, _ = _inputs("manifold", 6, seed=8)
    req = topology.TopologyRequest("ms", order=field)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        topology.submit(req)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        perlin_noise((4, 4, 4))
    assert topology.submit(req, device="cpu").segmentation.device.type == "cpu"

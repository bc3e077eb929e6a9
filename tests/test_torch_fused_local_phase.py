"""The port's fused block-local phase against the JAX package.

On the CPU `repro_torch.kernels.ops.fused_local_phase` runs the kernel's
plain version (`repro_torch.kernels.ref.fused_local_phase_ref`).  It is held
to the JAX oracle `repro.kernels.ref.fused_local_phase_ref` on every case
(modes x connectivity 6/14/18/26 x self_mask x block_x {1, 4, 8} on a ragged
X), and to the Pallas kernel itself in interpret mode on a subset (each
interpret compile takes about a second).  Tolerance: pointers and rounds
exactly equal.  The CUDA kernel is held to the same plain version on the
card by `tests/test_torch_cuda.py` and `chip_smoke.py`.

The CUDA kernel does not run the plain version's synchronous rounds: it
chases every chain once and reports 1 + ceil(log2(longest chain's hops)).
The round-rule tests below hold that premise against the plain version on
the ragged corpus and on the long-chain fields, with a numpy chase.
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
from oracles import GRID_SEED_CORPUS, ragged_grid_case
from repro_torch.data import chains
from repro_torch.kernels import ops, ref as kref
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


# --- the round rule: what the CUDA kernel's single resolve pass relies on ---


def _hop_chase(p, tsize):
    """Hops H and end pointer of every voxel of the flat init pointers p,
    by a memoised chase: H(i) = 1 if p(i) is negative, outside i's
    `tsize`-voxel slab or a root (p(p(i)) == p(i)), else 1 + H(p(i)); the
    end is the pointer of the chain's last in-slab voxel."""
    hops = np.zeros(p.size, np.int64)
    end = np.empty_like(p)
    for i in range(p.size):
        path, j = [], i
        while not hops[j]:
            q = p[j]
            lo = j - j % tsize
            if q < lo or q >= lo + tsize or p[q] == q:
                hops[j], end[j] = 1, q
                break
            path.append(j)
            j = q
        for k in reversed(path):
            hops[k], end[k] = hops[p[k]] + 1, end[p[k]]
    return hops, end


def _assert_round_rule(field, conn, mode, smask, block_x):
    """The plain version's synchronous doubling ends at the chase's end
    pointers after 1 + ceil(log2(max H)) rounds, within its round cap."""
    t = torch.from_numpy(np.ascontiguousarray(field))
    sm = None if smask is None else torch.from_numpy(smask)
    want, rounds = kref.fused_local_phase_ref(t, conn, mode=mode,
                                              self_mask=sm, block_x=block_x)
    p = kref.local_phase_init(t, conn, mode, sm).numpy()
    tsize = block_x * (p.size // field.shape[0])
    hops, end = _hop_chase(p, tsize)
    np.testing.assert_array_equal(end, want.numpy().reshape(-1))
    assert rounds == 1 + (int(hops.max()) - 1).bit_length()
    assert rounds <= kref.max_saturation_rounds(tsize)
    return rounds


@pytest.mark.parametrize("conn_index", [0, 1])
@pytest.mark.parametrize("seed", GRID_SEED_CORPUS)
def test_round_rule_on_the_ragged_corpus(seed, conn_index):
    """`ragged_grid_case` shapes (3-D ones with connectivities 6 and 26,
    2-D ones with 4 and 6), both modes, self_mask off and on, block_x
    1/3/8."""
    shape, _, _, mask_p = ragged_grid_case(seed)
    conn = ((6, 26) if len(shape) == 3 else (4, 6))[conn_index]
    rng = np.random.default_rng(seed)
    fields = {"manifold": rng.permutation(int(np.prod(shape))).reshape(
        shape).astype(np.int32), "cc": rng.random(shape) < mask_p}
    smask = rng.random(shape) < 0.2
    for mode, field in fields.items():
        for sm in (None, smask):
            for block_x in (1, 3, 8):
                _assert_round_rule(field, conn, mode, sm, block_x)


def _long_chain_field(make, shape, flip):
    field = getattr(chains, make)(shape, device="cpu")
    return (field.flip((1, 2)) if flip else field).contiguous().numpy()


@pytest.mark.parametrize("conn", [6, 26])
@pytest.mark.parametrize("make,flip,shape,mode,block_x", [
    ("serpentine_order", False, (2, 32, 32), "manifold", 1),
    ("serpentine_order", True, (2, 32, 32), "manifold", 1),
    ("z_ramp_order", False, (5, 6, 40), "manifold", 3),
    ("z_ramp_order", True, (5, 6, 40), "manifold", 8),
    ("z_line_mask", False, (4, 4, 50), "cc", 3)])
def test_round_rule_on_long_chains(make, flip, shape, mode, block_x, conn):
    """The long-chain fields of `repro_torch.data.chains` (flipped along y
    and z: chains to falling ids), with and without a self_mask."""
    field = _long_chain_field(make, shape, flip)
    smask = np.random.default_rng(block_x).random(shape) < 0.05
    for sm in (None, smask):
        _assert_round_rule(field, conn, mode, sm, block_x)


@pytest.mark.parametrize("flip", [False, True])
def test_serpentine_chain_covers_half_a_slab(flip):
    """At (4, 64, 64) with block_x 1 the path of a plane is 2079 voxels long:
    a chain of 2079 hops, 13 rounds (the cap of a 4096-voxel slab), in
    either direction of the ids."""
    field = _long_chain_field("serpentine_order", (4, 64, 64), flip)
    assert _assert_round_rule(field, 6, "manifold", None, 1) == 13


def test_kernel_refuses_a_slab_of_2_31_voxels():
    """The kernel's slab-local indices are int32: the wrapper raises before
    it touches the tensor (a meta tensor here), counting min(block_x, X)
    planes."""
    big = torch.empty((4, 2**16, 2**14), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="2\\*\\*31"):
        kmod.fused_local_phase(big, 6, block_x=2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kmod.fused_local_phase(big[:1], 6, block_x=8)

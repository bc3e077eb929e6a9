"""The port's run statistics (`core/stats.py`), boundary-table machinery
(`core/_table.py`) and label-propagation baseline (`core/baseline_cc.py`)
against the JAX package, on the CPU.

The `_table` functions take closures from their backends (`lookup`,
`cut_max`, `exchange`).  Each closure here is written once, over an array
namespace `xp` (`jax.numpy` or `torch`), and handed to both sides, so both
resolve the same seeded tables through the same rules.  Labels, permutations
and every count are held exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracles import GRID_SEED_CORPUS, oracle_components, ragged_grid_case

from repro.core import _table as jt
from repro.core import stats as jstats
from repro.core.baseline_cc import (extract_masked_edges as j_extract,
                                    label_propagation_grid as j_label_prop)
from repro_torch.core import _table as tt
from repro_torch.core import stats as tstats
from repro_torch.core.baseline_cc import (extract_masked_edges,
                                          label_propagation_grid)
from repro_torch.interop import to_numpy

SIDES = ((jt, jnp), (tt, torch))


def _np(a):
    return to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a)


def _equal(got, want):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _arr(xp, a):
    return xp.asarray(a) if xp is jnp else torch.from_numpy(np.array(a))


# --- closures, written once over xp ------------------------------------------


def make_lookup(xp, gids):
    """value -> slot (the slot whose gid equals it) -> entry at that slot;
    identity for values that are no slot's gid and for values < 0."""
    gids = _arr(xp, gids)
    last = gids.shape[0] - 1

    def lookup(t):
        idx = xp.clip(xp.searchsorted(gids, t), 0, last)
        return xp.where((gids[idx] == t) & (t >= 0), t[idx], t)
    return lookup


def make_cut_max(xp, a, b):
    """Each slot takes the max of itself and its cut neighbors' labels
    (edges a[k] <-> b[k], both directions)."""
    a, b = _arr(xp, a), _arr(xp, b)
    src, dst = (xp.concatenate([a, b]), xp.concatenate([b, a])) if xp is jnp \
        else (torch.cat([a, b]), torch.cat([b, a]))

    def cut_max(L):
        if xp is jnp:
            return L.at[dst].max(L[src])
        return L.clone().scatter_reduce_(0, dst.long(), L[src], "amax")
    return cut_max


def table_case(seed, m=60):
    """(gids, T, cut a, cut b): m slots with sorted unique gids; each slot's
    label is the gid of a slot further along (long chains), of a non-slot
    value, itself, or -1 (a pad slot)."""
    rng = np.random.default_rng(seed)
    gids = np.sort(rng.choice(10 * m, m, replace=False)).astype(np.int32)
    T = gids.copy()
    for i in range(m):
        u = rng.random()
        if u < 0.6 and i + 1 < m:
            T[i] = gids[rng.integers(i + 1, min(m, i + 4))]
        elif u < 0.75:
            T[i] = 10 * m + rng.integers(0, 5)      # a non-slot target
        elif u < 0.85:
            T[i] = -1
    k = m // 3
    return gids, T, rng.integers(0, m, k), rng.integers(0, m, k)


SEEDS = (0, 1, 2, 3)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("max_iter", [64, 2])
def test_pointer_chase_and_chase_view(seed, max_iter):
    gids, T, _, _ = table_case(seed)
    out = []
    for mod, xp in SIDES:
        t, it, ok = mod.pointer_chase(_arr(xp, T), make_lookup(xp, gids),
                                      max_iter)
        view, it2, ok2 = mod.chase_view(
            mod.TableView(_arr(xp, T), make_lookup(xp, gids), 7), max_iter)
        _equal(view.values, t)
        assert (int(it2), bool(ok2), view.n_own) == (int(it), bool(ok), 7)
        out.append((t, int(it), bool(ok)))
    (tw, itw, okw), (tg, itg, okg) = out
    _equal(tg, tw)
    assert (itg, okg) == (itw, okw)
    assert okg == (max_iter == 64)     # 2 rounds cut the long chains off


@pytest.mark.parametrize("seed", SEEDS)
def test_group_max_hook_propagate_value_substitute(seed):
    gids, T, a, b = table_case(seed)
    rng = np.random.default_rng(100 + seed)
    owned = np.concatenate([T, rng.choice(T, 20), [-1, 10**6]]).astype(
        np.int32)
    out = []
    for mod, xp in SIDES:
        Tstar, _, _ = mod.pointer_chase(_arr(xp, T), make_lookup(xp, gids))
        group_max, perm, sorted_vals = mod.make_group_max(Tstar)
        labels, it, ok = mod.hook_propagate(
            Tstar, make_cut_max(xp, a, b), group_max)
        g_sorted = labels[perm]
        chased = make_lookup(xp, gids)(Tstar)[:len(T)]
        sub = mod.value_substitute(_arr(xp, owned), _arr(xp, owned),
                                   sorted_vals, g_sorted)
        sub2 = mod.value_substitute(Tstar, chased, sorted_vals, g_sorted)
        out.append((perm, sorted_vals, group_max(Tstar), labels, int(it),
                    bool(ok), sub, sub2))
    for w, g in zip(*out):
        if isinstance(w, (int, bool)):
            assert g == w
        else:
            _equal(g, w)
    assert out[1][4] > 1 and out[1][5]


@pytest.mark.parametrize("seed", SEEDS)
def test_hook_propagate_cut_off(seed):
    """max_iter=1 stops a flood mid-way: converged False on both sides."""
    gids, T, a, b = table_case(seed)
    out = []
    for mod, xp in SIDES:
        Tstar, _, _ = mod.pointer_chase(_arr(xp, T), make_lookup(xp, gids))
        group_max, _, _ = mod.make_group_max(Tstar)
        L, it, ok = mod.hook_propagate(Tstar, make_cut_max(xp, a, b),
                                       group_max, max_iter=1)
        out.append((L, int(it), bool(ok)))
    _equal(out[1][0], out[0][0])
    assert out[1][1:] == out[0][1:] == (1, False)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("max_rounds", [64, 2])
def test_sharded_fixpoint_one_device(seed, max_rounds):
    """One "device": the identity exchange and reduction, refine a full
    chase; 2 outer rounds stop while the owned chunk still changes."""
    gids, T, _, _ = table_case(seed)
    out = []
    for mod, xp in SIDES:
        lookup = make_lookup(xp, gids)
        stack, own, rounds, iters, ok = mod.sharded_fixpoint(
            _arr(xp, T), lambda own: own,
            lambda st, mod=mod, lookup=lookup: mod.pointer_chase(st, lookup),
            lambda flag: flag, max_rounds)
        out.append((stack, own, int(rounds), int(iters), bool(ok)))
    for w, g in zip(*out):
        if isinstance(w, (int, bool)):
            assert g == w
        else:
            _equal(g, w)
    assert out[1][4] == (max_rounds == 64) and out[1][2] >= 2


def test_check_converged_and_table_modes():
    for mod in (jt, tt):
        assert mod.TABLE_MODES == ("replicated", "sharded")
        mod.check_table_mode("sharded")
        with pytest.raises(ValueError, match="table_mode must be one of"):
            mod.check_table_mode("ring")
    for flag in (True, np.array([1, 1]), torch.tensor([True, True])):
        tt.check_converged(flag, "cc", 64)
    msgs = []
    for mod, flag in ((jt, jnp.array([1, 0])), (tt, torch.tensor([1, 0])),
                      (tt, False), (tt, np.int32(0))):
        with pytest.raises(RuntimeError, match="did not reach its fixpoint "
                           "within max_iter=3 rounds") as e:
            mod.check_converged(flag, "graph cc", 3)
        msgs.append(str(e.value))
    assert msgs[0].startswith("graph cc: table resolution")


# --- stats -------------------------------------------------------------------


def test_stat_fields_and_classes():
    assert tstats.STAT_FIELDS == jstats.STAT_FIELDS
    for name in ("DPCStats", "GraphDPCStats"):
        assert getattr(tstats, name)._fields == getattr(jstats, name)._fields


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("cls", ["DPCStats", "GraphDPCStats"])
def test_stats_as_dict(cls, batched):
    """0-d values give Python scalars, batched ones lists, from tensors or
    ints, equal to JAX's from jnp arrays."""
    n = len(jstats.STAT_FIELDS)
    vals = []
    for k, f in enumerate(jstats.STAT_FIELDS):
        dt = np.float32 if "fraction" in f else (
            bool if f == "converged" else np.int32)
        v = np.array([k, k + 1, 0] if batched else k % 2 + k).astype(dt)
        vals.append(v)
    want = getattr(jstats, cls)(*(jnp.asarray(v) for v in vals)).as_dict()
    got = getattr(tstats, cls)(*(torch.from_numpy(np.array(v))
                                 for v in vals)).as_dict()
    assert got == want and list(got) == list(jstats.STAT_FIELDS)
    for g, w in zip(got.values(), want.values()):
        assert type(g) is type(w)
    ints = getattr(tstats, cls)(*range(n)).as_dict()
    assert ints == dict(zip(jstats.STAT_FIELDS, range(n)))
    assert tstats.stats_as_dict(getattr(tstats, cls)(*vals)) == want


# --- baseline ----------------------------------------------------------------


@pytest.mark.parametrize("seed", GRID_SEED_CORPUS[:4])
def test_baseline_cc(seed):
    shape, _, conn, p = ragged_grid_case(seed)
    mask = np.random.default_rng(seed).random(shape) < p
    want = j_label_prop(jnp.asarray(mask), conn)
    got = label_propagation_grid(torch.from_numpy(mask), conn)
    _equal(got.labels, want.labels)
    assert got.n_rounds == int(want.n_rounds)
    _equal(got.labels, oracle_components(mask, conn).astype(np.int32))
    cut = label_propagation_grid(torch.from_numpy(mask), conn, max_rounds=2)
    assert cut.n_rounds == int(j_label_prop(jnp.asarray(mask), conn,
                                            max_rounds=2).n_rounds)
    for g, w in zip(extract_masked_edges(torch.from_numpy(mask), conn),
                    j_extract(jnp.asarray(mask), conn)):
        _equal(g, w)

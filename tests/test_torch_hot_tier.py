"""The port's HotTier (state_machine/hot_tier.py) against the JAX
package's: the reference's unit cases (tests/test_hot_tier.py) run on
both with the same call sequences, and both must end with equal maps,
LRU stamps, clocks and counters; then the shared helpers
(mirror_hot_table8, grow_zero_host, grow_zero_device)."""

import numpy as np
import pytest
import torch

from tigerbeetle_tpu.state_machine import hot_tier as ref
from tigerbeetle_tpu.state_machine.mirror import BalanceMirror as RefMirror
from tigerbeetle_tpu_torch.state_machine import hot_tier as port
from tigerbeetle_tpu_torch.state_machine.mirror import BalanceMirror

STATE = ("hot_rows", "logical_capacity", "hot_of", "logical_of", "_stamp", "_clock",
         "hits", "misses", "evicts", "prefetches", "prefetch_stall_us")


def _same_state(a, b):
    for name in STATE:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), name
        else:
            assert x == y, name


def _results_equal(x, y):
    if x is None or y is None:
        assert x is y
        return
    for u, v in zip(x, y):
        assert np.array_equal(u, v) and u.dtype == v.dtype


def case_plan(mod):
    tier = mod.HotTier(64, 8)
    uniq, missing = tier.plan(np.array([5, 3, 5, -1, 3, 7]))
    assert uniq.tolist() == [3, 5, 7] and missing.tolist() == [3, 5, 7]
    uniq, missing = tier.plan(np.array([-1, -1]))
    assert len(uniq) == 0 and len(missing) == 0
    return tier, [tier.plan(np.array([5, 3, 5, -1, 3, 7]))]


def case_lru(mod):
    tier = mod.HotTier(64, 4)
    out = []
    for row in (10, 11, 12, 13):
        out.append(tier.admit(np.array([row]), protect=np.array([row])))
        tier.record_use(np.array([row]), hits=0, misses=1)
    tier.record_use(np.array([10]), hits=1, misses=0)
    got = tier.admit(np.array([20, 21]), protect=np.array([20, 21, 10]))
    admitted, _hot_slots, evicted = got
    assert admitted.tolist() == [20, 21] and sorted(evicted.tolist()) == [11, 12]
    assert sorted(tier.occupied().tolist()) == [10, 13, 20, 21]
    for logical in tier.occupied():
        assert tier.logical_of[tier.hot_of[logical]] == logical
    assert tier.hot_of[11] == -1 and tier.hot_of[12] == -1 and tier.evicts == 2
    return tier, out + [got]


def case_protect_blocks(mod):
    tier = mod.HotTier(64, 2)
    out = [tier.admit(np.array([1, 2]), protect=np.array([1, 2]))]
    out.append(tier.admit(np.array([3]), protect=np.array([1, 2, 3])))
    assert out[-1] is None
    out.append(tier.admit(np.array([3]), protect=np.array([1, 2, 3]), partial=True))
    assert len(out[-1][0]) == 0 and len(out[-1][2]) == 0
    assert sorted(tier.occupied().tolist()) == [1, 2]
    return tier, out


def case_partial_prefix(mod):
    tier = mod.HotTier(64, 4)
    out = [tier.admit(np.array([1, 2, 3]), protect=np.array([1, 2, 3]))]
    out.append(tier.admit(np.array([7, 8, 9]), protect=np.array([1, 2, 3, 7, 8, 9]),
                          partial=True))
    assert out[-1][0].tolist() == [7]
    assert tier.hot_of[8] == -1 and tier.hot_of[9] == -1
    return tier, out


def case_grow_logical(mod):
    tier = mod.HotTier(16, 4)
    out = [tier.admit(np.array([3]), protect=np.array([3]))]
    tier.grow_logical(64)
    assert tier.logical_capacity == 64 and tier.hot_rows == 4 and len(tier.hot_of) == 64
    assert (tier.hot_of[16:] == -1).all() and tier.logical_of[tier.hot_of[3]] == 3
    return tier, out


def case_translate(mod):
    tier = mod.HotTier(16, 4)
    out = [tier.admit(np.array([5, 9]), protect=np.array([5, 9]))]
    got = tier.translate(np.array([5, -1, 9, -7]))
    assert got[1] == -1 and got[3] == -7
    assert got[0] == tier.hot_of[5] and got[2] == tier.hot_of[9]
    return tier, out + [(got,)]


def case_churn(mod):
    """A seeded stream of batches over 40 rows through a 6-row hot set:
    plan, admit (whole and partial), record_use and stalls, as both
    engines drive them."""
    rng = np.random.default_rng(11)
    tier = mod.HotTier(40, 6)
    out = []
    for step in range(60):
        touched = rng.integers(-1, 40, int(rng.integers(1, 9)))
        uniq, missing = tier.plan(touched)
        out.append((uniq, missing))
        if len(missing):
            got = tier.admit(missing, protect=uniq, partial=bool(step % 2))
            out.append(got)
            tier.note_stall(0.25)
        tier.record_use(uniq, len(uniq) - len(missing), len(missing))
        out.append((tier.translate(touched),))
    assert tier.evicts > 0
    return tier, out


CASES = {
    "plan": case_plan, "lru": case_lru, "protect_blocks": case_protect_blocks,
    "partial_prefix": case_partial_prefix, "grow_logical": case_grow_logical,
    "translate": case_translate, "churn": case_churn,
}


@pytest.mark.parametrize("name", list(CASES))
def test_hot_tier_matches_reference(name):
    t_ref, out_ref = CASES[name](ref)
    t_port, out_port = CASES[name](port)
    _same_state(t_ref, t_port)
    assert len(out_ref) == len(out_port)
    for x, y in zip(out_ref, out_port):
        _results_equal(x, y)


@pytest.mark.parametrize("budget,want", [(None, None), ("0", None), ("1024", None),
                                         ("2048", None), ("64", 64)])
def test_from_env_gates(budget, want, monkeypatch):
    if budget is None:
        monkeypatch.delenv("TB_HOT_CAPACITY", raising=False)
    else:
        monkeypatch.setenv("TB_HOT_CAPACITY", budget)
    for mod in (ref, port):
        tier = mod.from_env(1024)
        assert (tier is None) == (want is None)
        if tier is not None:
            assert tier.hot_rows == want and tier.logical_capacity == 1024


def test_mirror_hot_table8_matches_reference():
    rng = np.random.default_rng(3)
    mine, theirs = BalanceMirror(32), RefMirror(32)
    mine.lo[:] = rng.integers(0, 1 << 63, (32, 4), dtype=np.int64).astype(np.uint64) * 2 + 1
    mine.hi[:] = np.arange(128, dtype=np.uint64).reshape(32, 4)
    theirs.lo[:], theirs.hi[:] = mine.lo, mine.hi
    lof = np.array([7, -1, 0, 31, -1, 12], np.int64)
    got = port.mirror_hot_table8(mine, lof)
    want = ref.mirror_hot_table8(theirs, lof)
    assert got.dtype == want.dtype == np.uint64 and np.array_equal(got, want)
    assert not got[[1, 4]].any()


def test_grow_zero_host_noop_and_widen():
    a = np.arange(8, dtype=np.uint64).reshape(4, 2)
    assert port.grow_zero_host(a, 4) is a
    b = port.grow_zero_host(a, 6)
    assert np.array_equal(b, ref.grow_zero_host(a, 6)) and b.dtype == a.dtype


@pytest.mark.parametrize("dtype,width", [(torch.int64, 8), (torch.int32, 2)])
def test_grow_zero_device_is_cat(dtype, width):
    t = torch.arange(5 * width, dtype=dtype).reshape(5, width) - 7
    assert port.grow_zero_device(t, 5) is t
    got = port.grow_zero_device(t, 9)
    want = torch.cat([t, torch.zeros((4, width), dtype=dtype)])
    assert got.dtype == dtype and torch.equal(got, want)

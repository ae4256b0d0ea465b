"""u128 helpers on int64 lanes (tigerbeetle_tpu_torch/ops/u128.py)
against the JAX reference (tigerbeetle_tpu/ops/u128.py) — bit-exact,
including the edge values 0, 2^63 and 2^64 - 1 in every limb."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from tigerbeetle_tpu.ops import u128 as ref
from tigerbeetle_tpu_torch.ops import u128 as port

EDGES = np.array([0, 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1], np.uint64)


def _limbs(seed: int, n: int = 400) -> np.ndarray:
    """(n,) u64 values: random full-width words with the edge values
    spliced in at random positions."""
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 1 << 63, n, dtype=np.uint64) | (
        rng.integers(0, 2, n, dtype=np.uint64) << np.uint64(63)
    )
    pick = rng.random(n) < 0.4
    v[pick] = EDGES[rng.integers(0, len(EDGES), int(pick.sum()))]
    return v


def _pair(seed):
    return _limbs(seed), _limbs(seed + 1)


def _t(a):
    return port.from_u64(a)


def _j(a):
    return jnp.asarray(a, jnp.uint64)


def _same(t, j):
    return np.array_equal(port.to_u64(t) if t.dtype == torch.int64 else t.numpy(),
                          np.asarray(j))


@pytest.mark.parametrize("op", ["add", "sub"])
def test_add_sub_and_flags(op):
    (alo, ahi), (blo, bhi) = _pair(1), _pair(3)
    (tlo, thi), tflag = getattr(port, op)((_t(alo), _t(ahi)), (_t(blo), _t(bhi)))
    (jlo, jhi), jflag = getattr(ref, op)((_j(alo), _j(ahi)), (_j(blo), _j(bhi)))
    assert _same(tlo, jlo) and _same(thi, jhi)
    assert np.array_equal(tflag.numpy(), np.asarray(jflag))


@pytest.mark.parametrize("op", ["eq", "ne", "gt", "lt"])
def test_compares(op):
    (alo, ahi), (blo, bhi) = _pair(5), _pair(7)
    # Half the lanes share a high limb so the low-limb compare decides.
    bhi[::2] = ahi[::2]
    got = getattr(port, op)((_t(alo), _t(ahi)), (_t(blo), _t(bhi)))
    want = getattr(ref, op)((_j(alo), _j(ahi)), (_j(blo), _j(bhi)))
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("op", ["sub_sat", "minimum"])
def test_sub_sat_and_minimum(op):
    (alo, ahi), (blo, bhi) = _pair(9), _pair(11)
    tlo, thi = getattr(port, op)((_t(alo), _t(ahi)), (_t(blo), _t(bhi)))
    jlo, jhi = getattr(ref, op)((_j(alo), _j(ahi)), (_j(blo), _j(bhi)))
    assert _same(tlo, jlo) and _same(thi, jhi)


def test_is_zero_and_select():
    (alo, ahi), (blo, bhi) = _pair(13), _pair(15)
    alo[:50] = 0
    ahi[:50] = 0
    assert np.array_equal(
        port.is_zero((_t(alo), _t(ahi))).numpy(),
        np.asarray(ref.is_zero((_j(alo), _j(ahi)))),
    )
    pred = np.random.default_rng(17).random(len(alo)) < 0.5
    tlo, thi = port.select(torch.from_numpy(pred), (_t(alo), _t(ahi)), (_t(blo), _t(bhi)))
    jlo, jhi = ref.select(jnp.asarray(pred), (_j(alo), _j(ahi)), (_j(blo), _j(bhi)))
    assert _same(tlo, jlo) and _same(thi, jhi)


def test_limbs32_round_trip_and_carry():
    lo, hi = _pair(19)
    t = port.limbs32(_t(lo), _t(hi))
    j = ref.limbs32(_j(lo), _j(hi))
    assert _same(t, j)
    # Sums of many limb rows: carries past 2^128 must match too.
    rows_t = t.view(-1, 8, 4).sum(dim=1)
    rows_j = np.asarray(j).reshape(-1, 8, 4).sum(axis=1, dtype=np.uint64)
    for a, b in zip(port.from_limbs32(rows_t), ref.from_limbs32(jnp.asarray(rows_j))):
        assert _same(a, b)


def test_unsigned_compare_and_shift_edges():
    a = _limbs(21)
    b = _limbs(23)
    assert np.array_equal(port.ult(_t(a), _t(b)).numpy(), a < b)
    for n in (1, 16, 32, 33, 63):
        assert np.array_equal(port.to_u64(port.shr(_t(a), n)), a >> np.uint64(n))
    assert port.s64((1 << 64) - 1) == -1 and port.s64(1 << 63) == -(1 << 63)

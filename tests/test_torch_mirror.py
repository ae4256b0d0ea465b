"""The port's numpy balance mirror (tigerbeetle_tpu_torch/state_machine/
mirror.py) against the reference mirror: admission verdicts, deltas and
mirror contents bit for bit."""

import numpy as np
import pytest

from tigerbeetle_tpu.state_machine import mirror as ref
from tigerbeetle_tpu_torch.state_machine import mirror as port


def _adds(seed, n=3000, rows=200, huge=False):
    rng = np.random.default_rng(seed)
    dr = rng.integers(0, rows, n)
    cr = (dr + 1 + rng.integers(0, 7, n)) % rows
    lo = rng.integers(0, 1 << 63, n, dtype=np.uint64) << np.uint64(1)
    hi = rng.integers(0, 4, n, dtype=np.uint64)
    if huge:
        hi[:3] = np.uint64((1 << 64) - 1)
    return dr, cr, lo, hi, rng.random(n) < 0.4, rng.random(n) < 0.8


# 200 rows take the dense accumulation, 1 << 16 rows the sparse one.
@pytest.mark.parametrize(
    "seed,huge,rows",
    [(1, False, 200), (2, False, 200), (3, True, 200),
     (4, False, 1 << 16), (5, True, 1 << 16)],
)
def test_try_apply_adds_matches_reference(seed, huge, rows):
    mirrors = (ref.BalanceMirror(rows), port.BalanceMirror(rows))
    for step in range(3):
        args = _adds(10 * seed + step, rows=rows, huge=huge)
        outs = [m.try_apply_adds(*args) for m in mirrors]
        assert (outs[0] is None) == (outs[1] is None)
        if outs[0] is not None:
            for a, b in zip(*outs):
                assert np.array_equal(a, b)
        assert np.array_equal(mirrors[0].lo, mirrors[1].lo)
        assert np.array_equal(mirrors[0].hi, mirrors[1].hi)
    assert np.array_equal(mirrors[0].table8(rows), mirrors[1].table8(rows))


def test_compact_deltas_matches_reference():
    dr, cr, lo, hi, _, _ = _adds(7)
    cols = np.random.default_rng(8).integers(0, 4, len(dr))
    for a, b in zip(ref.compact_deltas(dr, cols, lo, hi), port.compact_deltas(dr, cols, lo, hi)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("rows", [200, 1 << 16])
def test_limb_sums_dense_and_sparse_agree(rows):
    """Both accumulation arms give the same keys and sums on one batch,
    whichever of them try_apply_adds would pick for the table."""
    dr, cr, lo, hi, pending, _ = _adds(11, rows=rows)
    idx_dr = dr * 4 + np.where(pending, 0, 1)
    idx_cr = cr * 4 + np.where(pending, 2, 3)
    dense = port.limb_sums(idx_dr, idx_cr, lo, hi, rows * 4, False)
    sparse = port.limb_sums(idx_dr, idx_cr, lo, hi, rows * 4, True)
    assert np.array_equal(dense[0], sparse[0])
    assert np.array_equal(dense[1], sparse[1])


@pytest.mark.parametrize("seed", [0, 1])
def test_set_rows8_matches_reference(seed):
    """Duplicate slots resolve to the last snapshot, as the reference's."""
    rng = np.random.default_rng(seed)
    mirrors = (ref.BalanceMirror(64), port.BalanceMirror(64))
    slots = rng.integers(0, 64, 300)
    rows = rng.integers(0, 1 << 63, (300, 8), dtype=np.uint64)
    for m in mirrors:
        m.set_rows8(slots, rows)
    assert np.array_equal(mirrors[0].lo, mirrors[1].lo)
    assert np.array_equal(mirrors[0].hi, mirrors[1].hi)
    assert mirrors[1].version == 1


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_subs_matches_reference(seed):
    """Pending releases, borrow across the limbs included."""
    rng = np.random.default_rng(seed)
    mirrors = (ref.BalanceMirror(32), port.BalanceMirror(32))
    for m in mirrors:
        m.lo[:] = np.uint64(5)
        m.hi[:] = np.uint64(3)
    slots = rng.integers(0, 32, 200)
    cols = rng.integers(0, 4, 200)
    lo = rng.integers(0, 1 << 62, 200, dtype=np.uint64) // np.uint64(64)
    hi = np.zeros(200, np.uint64)
    for m in mirrors:
        m.apply_subs(slots, cols, lo, hi)
    assert np.array_equal(mirrors[0].lo, mirrors[1].lo)
    assert np.array_equal(mirrors[0].hi, mirrors[1].hi)
    with pytest.raises(AssertionError):
        mirrors[1].apply_subs(np.array([0]), np.array([0]), np.array([0], np.uint64),
                              np.array([9], np.uint64))

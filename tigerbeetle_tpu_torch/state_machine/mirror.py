"""Host-side exact mirror of the account-balance table (numpy only).

This package's own copy of ``tigerbeetle_tpu/state_machine/mirror.py``
(the subset the port's engines read).  The device table is
authoritative; the mirror is the host's bookkeeping copy, updated by
the same additions the device applied, in commit order, so it equals
the device table at every window boundary (``verify_device_mirror``
asserts it).  Columns are (A, 4) uint64 limb pairs: dp, dpo, cp, cpo.
"""

from __future__ import annotations

import numpy as np

from tigerbeetle_tpu_torch.state_machine.hot_tier import grow_zero_host

_MASK32 = np.uint64(0xFFFFFFFF)
# The row factor of the table digest: row * GOLDEN + 1 (mod 2^64).
GOLDEN = 0x9E3779B97F4A7C15


def digest_columns(table: np.ndarray) -> np.ndarray:
    """Order-sensitive digest of a (rows, C) unsigned table: C column
    sums, then C row-mixed sums sum(v * (row * GOLDEN + 1)), all mod
    2^64, as u64 (a u32 table is zero-extended).  The host side of every
    integrity compare; kernel K11 (``device_kernels.checksum``) computes
    the same words on the card."""
    m = np.asarray(table).astype(np.uint64)
    col_sums = m.sum(axis=0, dtype=np.uint64)
    rows = np.arange(m.shape[0], dtype=np.uint64)[:, None]
    mixed = (m * (rows * np.uint64(GOLDEN) + np.uint64(1))).sum(axis=0, dtype=np.uint64)
    return np.concatenate([col_sums, mixed])


def _add_u128(a_lo, a_hi, b_lo, b_hi):
    """Vectorized (a + b) mod 2^128 plus overflow flag."""
    lo = a_lo + b_lo
    carry = (lo < a_lo).astype(np.uint64)
    hi_partial = a_hi + b_hi
    ov1 = hi_partial < a_hi
    hi = hi_partial + carry
    ov2 = hi < hi_partial
    return lo, hi, ov1 | ov2


def _sub_u128(a_lo, a_hi, b_lo, b_hi):
    """Vectorized (a - b) mod 2^128 plus borrow flag."""
    lo = a_lo - b_lo
    borrow = (a_lo < b_lo).astype(np.uint64)
    hi = a_hi - b_hi - borrow
    under = (a_hi < b_hi) | ((a_hi == b_hi) & (borrow == 1))
    return lo, hi, under


def compact_deltas(slots, cols, amt_lo, amt_hi):
    """Group (slot, col, amount) contributions into exact u128 sums.

    Returns (uniq_slots, uniq_cols, sum_lo, sum_hi, limb_overflow).
    Amounts are accumulated as 4x32-bit limbs; each limb sum of at
    most 2^21 entries stays below 2^53, so float64 bincount is exact.
    """
    assert len(slots) < 1 << 21, "limb sums must stay exact in float64"
    key = slots.astype(np.int64) * 4 + cols.astype(np.int64)
    uniq, inv = np.unique(key, return_inverse=True)
    k = len(uniq)
    limbs = (
        amt_lo & _MASK32, amt_lo >> np.uint64(32),
        amt_hi & _MASK32, amt_hi >> np.uint64(32),
    )
    c0, c1_, c2_, c3_ = (
        np.bincount(inv, limb.astype(np.float64), k).astype(np.uint64)
        for limb in limbs
    )
    c1 = c1_ + (c0 >> np.uint64(32))
    c2 = c2_ + (c1 >> np.uint64(32))
    c3 = c3_ + (c2 >> np.uint64(32))
    lo = (c0 & _MASK32) | ((c1 & _MASK32) << np.uint64(32))
    hi = (c2 & _MASK32) | ((c3 & _MASK32) << np.uint64(32))
    overflow = (c3 >> np.uint64(32)) != 0
    return (uniq // 4).astype(np.int64), (uniq % 4).astype(np.int64), lo, hi, overflow


# try_apply_adds accumulates sparsely once the dense key range is more
# than SPARSE_RATIO times the batch's contributions.  Measured with
# tools/mirror_accum.py on the H100 machine's host: dense is 4.4x faster
# on zipf's 100 accounts and still 11% faster at 4 keys per
# contribution, sparse 30% faster at 8 and 120x at 2^20 rows.
SPARSE_RATIO = 4


def limb_sums(idx_dr, idx_cr, amt_lo, amt_hi, K, sparse):
    """Exact per-key sums of the amounts' four 32-bit limbs, by float64
    bincount (limbs < 2^32, sums < events * 2^32 << 2^53) over
    (slot * 4 + col) keys below K.  Dense counts every key below K;
    sparse only the batch's distinct keys (a wide table's dense range
    costs O(table) per batch).  Both return (keys with a non-zero sum,
    ascending; (4, len(keys)) float64 limb sums)."""
    if sparse:
        keys, inv = np.unique(np.concatenate([idx_dr, idx_cr]), return_inverse=True)
        inv_dr, inv_cr = inv[: len(idx_dr)], inv[len(idx_dr) :]
        K = len(keys)
    else:
        inv_dr, inv_cr = idx_dr, idx_cr
    acc = np.empty((4, K))
    for i, limb in enumerate(
        (amt_lo & _MASK32, amt_lo >> np.uint64(32),
         amt_hi & _MASK32, amt_hi >> np.uint64(32))
    ):
        w = limb.astype(np.float64)
        acc[i] = np.bincount(inv_dr, weights=w, minlength=K)
        acc[i] += np.bincount(inv_cr, weights=w, minlength=K)
    nonzero = np.flatnonzero(acc.any(axis=0))
    return (keys[nonzero] if sparse else nonzero), acc[:, nonzero]


class BalanceMirror:
    """Exact host copy of the (A, 4)-column u128 balance table.

    ``version`` is a monotonic mutation stamp.  ``commitment`` (a
    commitment.HostCommitment, or None when TB_STATE_COMMIT=0) is
    refreshed with exactly the rows each mutation touched.
    """

    def __init__(self, capacity: int) -> None:
        self.lo = np.zeros((capacity, 4), np.uint64)
        self.hi = np.zeros((capacity, 4), np.uint64)
        self.version = 0
        self.commitment = None

    def _touch(self, slots) -> None:
        if self.commitment is not None:
            self.commitment.refresh(slots, self)

    def grow(self, capacity: int) -> None:
        if capacity <= len(self.lo):
            return
        self.lo = grow_zero_host(self.lo, capacity)
        self.hi = grow_zero_host(self.hi, capacity)
        self.version += 1
        # All-zero rows hash to 0: growth never moves the root.

    def rows8(self, slots: np.ndarray) -> np.ndarray:
        """(k, 8) interleaved rows matching the device layout."""
        out = np.empty((len(slots), 8), np.uint64)
        out[:, 0::2] = self.lo[slots]
        out[:, 1::2] = self.hi[slots]
        return out

    def table8(self, capacity: int) -> np.ndarray:
        """Full (capacity, 8) device-layout table (zero-padded past the
        mirror's rows) — the re-upload image for exact recovery."""
        table = np.zeros((capacity, 8), np.uint64)
        n = min(len(self.lo), capacity)
        table[:n, 0::2] = self.lo[:n]
        table[:n, 1::2] = self.hi[:n]
        return table

    def checksum8(self, capacity: int) -> np.ndarray:
        """Digest of the first `capacity` rows in device layout, word for
        word what K11 gives for the device table (16 u64 words)."""
        return digest_columns(self.table8(capacity))

    def set_rows8(self, slots: np.ndarray, rows: np.ndarray) -> None:
        """Overwrite rows from (k, 8) device-layout snapshots; duplicate
        slots resolve to the LAST occurrence (commit order)."""
        rev = slots[::-1]
        uniq, first = np.unique(rev, return_index=True)
        pick = len(slots) - 1 - first
        self.lo[uniq] = rows[pick][:, 0::2]
        self.hi[uniq] = rows[pick][:, 1::2]
        self.version += 1
        self._touch(uniq)

    def apply_subs(self, slots, cols, amt_lo, amt_hi) -> None:
        """Release amounts (pending expiry): column -= amount, exact."""
        u_slot, u_col, d_lo, d_hi, limb_ov = compact_deltas(
            slots, cols, amt_lo, amt_hi
        )
        assert not limb_ov.any()
        new_lo, new_hi, under = _sub_u128(
            self.lo[u_slot, u_col], self.hi[u_slot, u_col], d_lo, d_hi
        )
        assert not under.any(), "pending release underflow"
        self.lo[u_slot, u_col] = new_lo
        self.hi[u_slot, u_col] = new_hi
        self.version += 1
        self._touch(u_slot)

    def try_apply_adds(
        self, dr_slot, cr_slot, amt_lo, amt_hi, is_pending, mask,
        commit: bool = True,
    ):
        """Admission + commit of non-negative balance additions
        (pending -> dp/cp, posted -> dpo/cpo) iff no touched account's
        column sum or combined debit/credit total overflows u128.
        Returns the compact (slot, col, delta_lo, delta_hi) arrays, or
        None — the batch then needs the exact path (reference overflow
        codes: src/state_machine.zig:1531-1545).  commit=False is a
        pure admission dry-run."""
        m = mask
        if not m.any():
            z = np.zeros(0, np.int64)
            return (z, z.copy(), np.zeros(0, np.uint64), np.zeros(0, np.uint64))
        if not m.all():
            dr_slot, cr_slot = dr_slot[m], cr_slot[m]
            amt_lo, amt_hi = amt_lo[m], amt_hi[m]
            is_pending = is_pending[m]

        idx_dr = dr_slot * 4 + np.where(is_pending, 0, 1)
        idx_cr = cr_slot * 4 + np.where(is_pending, 2, 3)
        top = int(max(dr_slot.max(), cr_slot.max())) + 1
        sparse = top * 4 > SPARSE_RATIO * (len(idx_dr) + len(idx_cr))
        touched_idx, acc = limb_sums(idx_dr, idx_cr, amt_lo, amt_hi, top * 4, sparse)
        u_slot = (touched_idx >> 2).astype(np.int64)
        u_col = (touched_idx & 3).astype(np.int64)
        limbs = acc.astype(np.uint64)
        c0 = limbs[0]
        c1 = limbs[1] + (c0 >> np.uint64(32))
        c2 = limbs[2] + (c1 >> np.uint64(32))
        c3 = limbs[3] + (c2 >> np.uint64(32))
        d_lo = (c0 & _MASK32) | ((c1 & _MASK32) << np.uint64(32))
        d_hi = (c2 & _MASK32) | ((c3 & _MASK32) << np.uint64(32))
        if ((c3 >> np.uint64(32)) != 0).any():
            return None  # column delta alone exceeds u128
        if not self._admit_commit(u_slot, u_col, d_lo, d_hi, commit):
            return None
        return (u_slot, u_col, d_lo, d_hi)

    def try_apply_deltas(self, slots, cols, amt_lo, amt_hi):
        """Checked addition over explicit (slot, col) targets (the
        two-phase kernel's mixed dp/dpo/cp/cpo adds): the same admission
        as try_apply_adds, checked before any mutation.  Returns the
        compact (slot, col, delta_lo, delta_hi) arrays, or None (the
        mirror untouched)."""
        if len(slots) == 0:
            z = np.zeros(0, np.int64)
            return (z, z.copy(), np.zeros(0, np.uint64), np.zeros(0, np.uint64))
        u_slot, u_col, d_lo, d_hi, limb_ov = compact_deltas(
            np.asarray(slots, np.int64), np.asarray(cols, np.int64), amt_lo, amt_hi,
        )
        if limb_ov.any():
            return None
        if not self._admit_commit(u_slot, u_col, d_lo, d_hi, True):
            return None
        return (u_slot, u_col, d_lo, d_hi)

    def _admit_commit(self, u_slot, u_col, d_lo, d_hi, commit: bool) -> bool:
        """Per-column u128 overflow + combined dp+dpo / cp+cpo totals of
        every touched account against the all-applied bound; mutates
        only when both pass and commit=True."""
        old_lo = self.lo[u_slot, u_col]
        old_hi = self.hi[u_slot, u_col]
        new_lo, new_hi, add_ov = _add_u128(old_lo, old_hi, d_lo, d_hi)
        if add_ov.any():
            return False
        touched = np.unique(u_slot)
        cand_lo = self.lo[touched].copy()
        cand_hi = self.hi[touched].copy()
        pos = np.searchsorted(touched, u_slot)
        cand_lo[pos, u_col] = new_lo
        cand_hi[pos, u_col] = new_hi
        _, _, dr_tot_ov = _add_u128(
            cand_lo[:, 0], cand_hi[:, 0], cand_lo[:, 1], cand_hi[:, 1]
        )
        _, _, cr_tot_ov = _add_u128(
            cand_lo[:, 2], cand_hi[:, 2], cand_lo[:, 3], cand_hi[:, 3]
        )
        if dr_tot_ov.any() or cr_tot_ov.any():
            return False
        if commit:
            self.lo[u_slot, u_col] = new_lo
            self.hi[u_slot, u_col] = new_hi
            self.version += 1
            self._touch(touched)
        return True

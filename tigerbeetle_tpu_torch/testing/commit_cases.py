"""Seeded inputs for kernel K2's update and admit (numpy only).

The reference (``commitment._update`` / ``_admit``) treats only -1 as
padding: a slot past the table (s >= H) is live, reads row H-1 as it
was before the call (a clamped gather), moves the digest by new - old
and stores nothing.  ``PAST_CASES`` name slot sets that reach past the
table, with and without a lane that owns row H-1 in the same call; the
CPU tests hold the plain versions against the reference on them, the
card tests and ``chip_smoke.py`` the kernels against the plain versions.
``admit_case`` and ``update_case`` make the whole inputs.
"""

from __future__ import annotations

import numpy as np

# name -> the slots for a table of H rows (distinct, as the contract
# asks; -1 is padding).  All below 2^31: the reference on XLA's CPU
# backend narrows a gather's and a scatter's indices to 32 bits (from
# 2^31 it reads row 0, from 2^32 it wraps), which no table reaches.
PAST_CASES = {
    "one_past": lambda H: [1, H + 1, -1],
    "several_past": lambda H: [0, H, 5, H + 3, -1, H + 100, -1, (1 << 31) - 1],
    "last_row_and_past": lambda H: [H + 2, 4, H - 1, H + 7, -1],
    "past_after_last_row": lambda H: [H - 1, H, 2, H + 1],
    "only_past": lambda H: [H, H + 1, H + 5, -1],
    "last_row_only": lambda H: [3, H - 1, -1],
}


def past_slots(name: str, H: int) -> np.ndarray:
    return np.asarray(PAST_CASES[name](H), np.int64)


def _u64(rng, shape):
    return rng.integers(0, 1 << 64, shape, dtype=np.uint64)


def admit_case(slots, H: int, seed: int):
    """(row_hash (H, 2), digest (2,), slots, new_lo, new_hi): u64 arrays
    (a fifth of the rows (0, 0), free slots) and int64 slots."""
    rng = np.random.default_rng(seed)
    row_hash = _u64(rng, (H, 2))
    row_hash[rng.random(H) < 0.2] = 0
    slots = np.asarray(slots, np.int64)
    return row_hash, _u64(rng, 2), slots, _u64(rng, len(slots)), _u64(rng, len(slots))


def update_case(slots, A: int, seed: int):
    """(balances (A, 8) u64, meta (A, 2) u32, row_hash (A, 2), digest
    (2,), slots, rows): random tables (some rows all zero), stored
    hashes that are not the rows' (the update must not care), logical
    row ids of full 64 bits."""
    rng = np.random.default_rng(seed)
    bal = _u64(rng, (A, 8))
    meta = rng.integers(0, 1 << 32, (A, 2), dtype=np.uint64).astype(np.uint32)
    zero = rng.random(A) < 0.2
    bal[zero], meta[zero] = 0, 0
    slots = np.asarray(slots, np.int64)
    return bal, meta, _u64(rng, (A, 2)), _u64(rng, 2), slots, _u64(rng, len(slots))

"""Seeded write-behind flushes for kernel K4's checks (numpy only).

``timed_case`` is ``chip_smoke.py``'s timed K4 call: 28,672 distinct
random cells of a 2^20-row table with full 64-bit deltas (carries from
lo into hi and wraps past 2^128 are common) and 4,096 padding entries
(slot >= A) that must be dropped.  ``flush_case`` builds what the host
engine hands K4: the queued (slot, column, u128 delta) entries of a few
batches of order-free transfers, compacted as ``DeviceTable.flush``
compacts them (``mirror.compact_deltas``: one exact sum per (slot,
col), sorted), cut into launches of ``kernel_fast.FLUSH_CHUNK``
entries; on a full table, or, as a sharded table's flush runs it, on
the compact table of the flushed rows (their positions for slots).
The card tests, ``chip_smoke.py`` and ``tools/serial_probes.py`` share
it.
"""

from __future__ import annotations

import numpy as np

from tigerbeetle_tpu_torch.state_machine.kernel_fast import FLUSH_CHUNK, FLUSH_THRESHOLD
from tigerbeetle_tpu_torch.state_machine.mirror import compact_deltas

BATCH = 8190


def flush_entries(seed, n_accounts, batches=None):
    """The compacted entries (slots, cols, d_lo, d_hi) of one flush of
    gen_simple-like batches: each event debits a uniform account d
    (debits_posted, column 1) and credits d % n_accounts + 1 (credits
    posted, column 3), as many batches as reach FLUSH_THRESHOLD queued
    entries; amounts full 64-bit with a small high limb, so sums carry."""
    rng = np.random.default_rng(seed)
    if batches is None:
        batches = -(-FLUSH_THRESHOLD // (2 * BATCH))
    E = batches * BATCH
    d = rng.integers(0, n_accounts, E)
    slots = np.concatenate([d, (d + 1) % n_accounts])
    cols = np.concatenate([np.full(E, 1), np.full(E, 3)])
    lo = rng.integers(0, 1 << 64, 2 * E, dtype=np.uint64)
    hi = rng.integers(0, 4, 2 * E, dtype=np.uint64)
    u_slot, u_col, s_lo, s_hi, _ = compact_deltas(slots, cols, lo, hi)
    return u_slot, u_col, s_lo, s_hi


def flush_case(seed, A, n_accounts, compact=False):
    """(table (R, 8) int64, [packed (4, k) int64 per launch]) of one
    flush: R = A rows of random balances, or with `compact` the flushed
    rows only (sorted, as the K14 gather lays them out) with the
    entries' slots their positions there."""
    rng = np.random.default_rng(seed + 1)
    u_slot, u_col, s_lo, s_hi = flush_entries(seed, n_accounts)
    if compact:
        rows = np.unique(u_slot)
        u_slot = np.searchsorted(rows, u_slot)
        A = len(rows)
    table = rng.integers(-(1 << 63), (1 << 63) - 1, (A, 8), dtype=np.int64)
    packed = np.stack([u_slot.astype(np.uint64), u_col.astype(np.uint64), s_lo, s_hi]).view(
        np.int64)
    return table, [np.ascontiguousarray(packed[:, at:at + FLUSH_CHUNK])
                   for at in range(0, packed.shape[1], FLUSH_CHUNK)]


def timed_case(A, K=32_768, padding=4096, seed=2028):
    """(table (A, 8) int64, packed (4, K) int64): K - padding distinct
    random (slot, col) cells in random order with random 64-bit limbs,
    then `padding` entries at slots A, A + 1, ..."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(-(1 << 63), (1 << 63) - 1, (A, 4), dtype=np.int64)
    hi = rng.integers(0, 1 << 40, (A, 4), dtype=np.int64)
    table = np.stack([lo, hi], axis=-1).reshape(A, 8)
    live = K - padding
    keys = rng.choice(A * 4, live, replace=False)
    packed = np.zeros((4, K), np.int64)
    packed[0, :live] = keys // 4
    packed[1, :live] = keys % 4
    packed[2, :live] = rng.integers(-(1 << 63), (1 << 63) - 1, live)
    packed[3, :live] = rng.integers(-(1 << 63), (1 << 63) - 1, live)
    packed[0, live:] = A + np.arange(padding)
    packed[2, live:] = 99
    return table, packed

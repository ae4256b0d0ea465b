"""Seeded batches for the order-free kernel (K1).

Each case is (table (A, 8) u64, meta (A, 2) u32, pk, n): the packed
batch as the host packers lay it out (``device_kernels`` column layout:
(B, 5) u32 for the tight format, (B, 6) u64 for lo and full).  The
timed cases of ``chip_smoke.py`` and ``tools/serial_probes.py`` and the
edge cases of the card tests come from here.  numpy only.
"""

from __future__ import annotations

import numpy as np

from tigerbeetle_tpu_torch import workload
from tigerbeetle_tpu_torch.state_machine import device_kernels as dk
from tigerbeetle_tpu_torch.types import TRANSFER_DTYPE

# The hash of csrc/orderfree.cu's table: a row's home is the top bits
# of (slot + 1) x HASH_MUL (mod 2^64), down to its bucket of eight.
HASH_MUL = 0x9E3779B97F4A7C15
ZIPF_ACCOUNTS = 100      # gen_zipf's default: the skewed case's accounts
COMPACT_ROWS = 1 << 18   # one of the sharded engine's four shards of 2^20 rows


def tables(rng, A):
    """Random balances (full low limbs, high limbs below 2^40, so no
    total overflows) and meta on ledger 1."""
    lo = rng.integers(-(1 << 63), (1 << 63) - 1, (A, 4), dtype=np.int64).view(np.uint64)
    hi = rng.integers(0, 1 << 40, (A, 4), dtype=np.int64).astype(np.uint64)
    meta = np.zeros((A, 2), np.uint32)
    meta[:, 1] = 1
    return np.stack([lo, hi], axis=-1).reshape(A, 8), meta


def pack_tight(B, dr, cr, amount):
    """(B, 5) u32: events [0, len(dr)) on slots dr / cr (-1 = not
    found), code 1, ledger 1, no flags."""
    n = len(dr)
    pk = np.zeros((B, dk.N_COLS_TIGHT), np.uint32)
    pk[:n, 0] = dk.TIGHT_CODE_BIT
    pk[:n, 1] = np.asarray(dr, np.int64) + 1
    pk[:n, 2] = np.asarray(cr, np.int64) + 1
    pk[:n, 3] = amount
    pk[:n, 4] = 1
    return pk


def pack_wide(B, dr, cr, amt_lo, amt_hi=0, flags=0):
    """(B, 6) u64 for the lo and full formats, events [0, len(dr)):
    code 1, ledger 1, no timeout."""
    n = len(dr)
    pk = np.zeros((B, dk.N_COLS), np.uint64)
    pk[:n, dk.COL_SLOTS] = (np.asarray(dr, np.int64) + 1).astype(np.uint64) | (
        (np.asarray(cr, np.int64) + 1).astype(np.uint64) << np.uint64(32))
    pk[:n, dk.COL_AMT_LO] = np.asarray(amt_lo, np.uint64)
    pk[:n, dk.COL_AMT_HI] = np.asarray(amt_hi, np.uint64)
    pk[:n, dk.COL_MISC] = np.asarray(flags, np.uint64) | np.uint64((1 << 16) | (1 << 32))
    return pk


def tight(rng, B, n, n_acct, meta):
    """The simple-like tight batch of chip_smoke.py: uniform debit rows
    of `n_acct`, credit = debit + 1, amounts 1..99; 40 debit rows not
    found, 30 same-account and 30 ledger-mismatch failures (> FAIL_CAP
    in all).  Returns (pk, meta with the mismatched rows on ledger 2)."""
    dr = rng.integers(0, n_acct, n)
    cr = (dr + 1) % n_acct
    pk = pack_tight(B, dr, cr, rng.integers(1, 100, n))
    pk[:40, 1] = 0                       # debit account not found
    pk[40:70, 0] |= dk.BIT_SAME_ACCT     # accounts must be different
    meta = meta.copy()
    meta[pk[70:100, 1].astype(np.int64) - 1, 1] = 2  # ledger mismatch
    return pk, meta


def zipf_slots(n):
    """(dr, cr) rows of gen_zipf's first timed batch of n events: 100
    accounts (account k on row k - 1), p ~ 1 / rank."""
    _setup, timed, _sizing = workload.gen_zipf(n, n_accounts=ZIPF_ACCOUNTS, batch=n)
    t = np.frombuffer(timed[0][1], TRANSFER_DTYPE)
    return (t["debit_account_id_lo"].astype(np.int64) - 1,
            t["credit_account_id_lo"].astype(np.int64) - 1)


def skewed(seed, B, n, A):
    """A tight batch of gen_zipf's skew: n events over 100 accounts, on
    a table of A rows."""
    rng = np.random.default_rng(seed)
    table, meta = tables(rng, A)
    dr, cr = zipf_slots(n)
    return table, meta, pack_tight(B, dr, cr, rng.integers(1, 100, n)), n


def compact(seed, B, n, A=COMPACT_ROWS):
    """A tight batch on a compact table of one shard's 2^18 rows, every
    row an account, as the sharded engine's compact tables hold them:
    uniform debit rows, credit = debit + 1."""
    rng = np.random.default_rng(seed)
    table, meta = tables(rng, A)
    dr = rng.integers(0, A, n)
    return table, meta, pack_tight(B, dr, (dr + 1) % A, rng.integers(1, 100, n)), n


def home_of(slots, batch):
    """Each row's home bucket start in K1's hash table for a scratch
    made for `batch` events (csrc/orderfree.cu claim, table_slots)."""
    sp = 64
    while sp < 8 * batch:
        sp *= 2
    key = np.asarray(slots, np.uint64) + np.uint64(1)
    h = (key * np.uint64(HASH_MUL)) >> np.uint64(64 - sp.bit_length() + 1)  # wraps mod 2^64
    return h & ~np.uint64(7)


def crowded_slots(A, count, batch, window):
    """`count` distinct rows of an A-row table whose homes in K1's hash
    table all lie in its first `window` slots: long probe chains."""
    s = np.arange(A, dtype=np.int64)
    s = s[home_of(s, batch) < np.uint64(window)]
    if len(s) < count:
        raise ValueError(f"only {len(s)} rows of {A} have a home below {window}")
    return s[:count]

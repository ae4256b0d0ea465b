"""Seeded inputs and oracles for the row-sharded paths.

numpy only, shared by the CPU tests and ``chip_smoke.py``:

- ``join_tables``: the shard tables of a mesh (``sharded.shard_balances``
  splits a whole table) joined back into the whole (A, 8) u64 table;
- ``apply_oracle``: the arithmetic of the reference's sharded-apply
  oracle (``tests/test_sharded.py`` ``_oracle``: per-row u128 sums,
  row-granularity overflow admission, the admitted sums applied),
  vectorised over 32-bit limbs so a 2^20-row table takes milliseconds;
- ``apply_events``: random order-free event slices with rows seeded
  near 2^128 and out-of-range slots, so some events reject;
- ``mixed_case``: a batch whose wave plan is wave, chains, wave, chains
  (``wave_cases.wide_case`` and ``chain_case`` parts on disjoint rows),
  some events naming no account (slot -1);
- ``shardable_cases``: the wave_cases plans the sharded wave executor
  takes (wave and chain segments only);
- ``wave_stream``: a stream of full batches of those shapes, each on
  its own rows of one table;
- ``pv_balancing_stream``: create_transfers wire batches of
  (pending, post) pairs with balancing riders (the reference's
  ``_pv_balancing_batch`` shape, tests/test_device_waves.py:191) at
  full size, which the device engine wave-dispatches with wave-only
  plans, some batches carrying a pending between history accounts
  (a scan segment: the sharded engine declines those).
"""

from __future__ import annotations

import numpy as np

from tigerbeetle_tpu_torch import workload
from tigerbeetle_tpu_torch.ops.u128 import to_u64
from tigerbeetle_tpu_torch.state_machine import waves
from tigerbeetle_tpu_torch.testing import wave_cases
from tigerbeetle_tpu_torch.types import AccountFlags, Operation, TransferFlags

M32 = np.uint64(0xFFFFFFFF)
S32 = np.uint64(32)
R_DEBIT_ACCOUNT_NOT_FOUND = 21


def join_tables(tables) -> np.ndarray:
    """Shard tables (int64 tensors, any device) -> the whole (A, 8) u64."""
    return np.concatenate([to_u64(t) for t in tables])


def _limbs(lo, hi):
    return [lo & M32, lo >> S32, hi & M32, hi >> S32]


def _cell_sums(slots, cols, lo, hi, keep):
    """(distinct row * 4 + col keys, (k, 4) u64 limb sums) of the kept
    entries."""
    key = slots[keep].astype(np.int64) * 4 + cols[keep]
    uniq, inv = np.unique(key, return_inverse=True)
    sums = np.zeros((len(uniq), 4), np.uint64)
    for k, limb in enumerate(_limbs(lo[keep], hi[keep])):
        np.add.at(sums[:, k], inv, limb)
    return uniq, sums


def _add_cells(table, keys, sums):
    """(old + sums) per cell as (lo, hi, overflowed past 2^128)."""
    rows, cols = keys // 4, keys % 4
    old = _limbs(table[rows, 2 * cols], table[rows, 2 * cols + 1])
    t, carry = [], np.zeros(len(keys), np.uint64)
    for k in range(4):
        v = old[k] + sums[:, k] + carry
        t.append(v & M32)
        carry = v >> S32
    return t[0] | (t[1] << S32), t[2] | (t[3] << S32), carry != 0


def apply_oracle(balances, dr, cr, amount_lo, amount_hi, pending):
    """The sharded apply's expected (table, admitted): every in-range
    (slot, column) entry's u128 sum; a row where some column's old value
    + sum reaches 2^128 rejects every event touching it; an event naming
    a row outside the table is rejected; the admitted events' sums are
    added.  Returns a new table."""
    rows = balances.shape[0]
    dr = np.asarray(dr, np.int64)
    cr = np.asarray(cr, np.int64)
    pending = np.asarray(pending, bool)
    slots = np.concatenate([dr, cr])
    cols = np.concatenate([np.where(pending, 0, 1), np.where(pending, 2, 3)])
    lo = np.concatenate([amount_lo, amount_lo]).astype(np.uint64)
    hi = np.concatenate([amount_hi, amount_hi]).astype(np.uint64)
    in_range = (slots >= 0) & (slots < rows)
    keys, sums = _cell_sums(slots, cols, lo, hi, in_range)
    _, _, over = _add_cells(balances, keys, sums)
    bad_rows = np.unique(keys[over] // 4)
    E = len(dr)
    admitted = ~(np.isin(dr, bad_rows) | np.isin(cr, bad_rows))
    admitted &= in_range[:E] & in_range[E:]
    keys, sums = _cell_sums(slots, cols, lo, hi, in_range & np.concatenate([admitted] * 2))
    new_lo, new_hi, _ = _add_cells(balances, keys, sums)
    out = balances.copy()
    out[keys // 4, 2 * (keys % 4)] = new_lo
    out[keys // 4, 2 * (keys % 4) + 1] = new_hi
    return out, admitted


def apply_events(seed, rows, n_events, near_ceiling=4, out_of_range=2):
    """(balances, dr, cr, amount_lo, amount_hi, pending) for one sharded
    apply: random slots, u128 amounts, `near_ceiling` rows seeded within
    2^40 of 2^128 in one column (events touching them reject), and
    `out_of_range` events naming a row outside the table."""
    rng = np.random.default_rng(seed)
    balances = np.zeros((rows, 8), np.uint64)
    balances[:, 0::2] = rng.integers(0, 1 << 40, (rows, 4)).astype(np.uint64)
    hot = rng.choice(rows, near_ceiling, replace=False)
    col = rng.integers(0, 4, near_ceiling)
    balances[hot, 2 * col] = np.uint64((1 << 64) - (1 << 40)) + rng.integers(
        0, 1 << 20, near_ceiling).astype(np.uint64)
    balances[hot, 2 * col + 1] = np.uint64((1 << 64) - 1)
    dr = rng.integers(0, rows, n_events).astype(np.int32)
    cr = ((dr + rng.integers(1, rows, n_events)) % rows).astype(np.int32)
    # Every hot row is named by a few events, in each column.
    k = min(n_events, 4 * near_ceiling)
    dr[:k] = np.resize(hot, k)
    amount_lo = rng.integers(1, 1 << 41, n_events).astype(np.uint64)
    wide = rng.random(n_events) < 0.05  # events whose amount has a high limb
    amount_hi = np.where(wide, rng.integers(0, 3, n_events), 0)
    pending = rng.random(n_events) < 0.5
    bad = rng.choice(n_events, out_of_range, replace=False)
    dr[bad[: (out_of_range + 1) // 2]] = rows + 3
    cr[bad[(out_of_range + 1) // 2:]] = -1
    perm = rng.permutation(n_events)
    return (balances, dr[perm], cr[perm], amount_lo[perm], amount_hi.astype(np.uint64)[perm],
            pending[perm])


def _join_parts(parts, B):
    """Concatenate (ev, dstat, n) batch parts into one B-event batch:
    indices, id groups and durable-pending targets renumbered."""
    ev = wave_cases._blank(B)
    dstat = np.zeros(B, np.uint32)
    at, tgt = 0, 0
    for part_ev, part_dstat, n in parts:
        for name in ev:
            if name not in ("i", "id_group", "p_group", "p_tgt"):
                ev[name][at:at + n] = part_ev[name][:n]
        pt = part_ev["p_tgt"][:n]
        n_tgt = int(pt.max()) + 1 if (pt >= 0).any() else 0
        ev["p_tgt"][at:at + n] = np.where(pt >= 0, pt + tgt, -1)
        dstat[tgt:tgt + n_tgt] = part_dstat[:n_tgt]
        at, tgt = at + n, tgt + n_tgt
    return ev, dstat, at


def mixed_case(seed, B, A, rows=None, n=None):
    """(table, ev, dstat, n, ts_base, plan) for a batch planned as wave,
    chains, wave, chains: wide_case and chain_case parts on disjoint row
    pools (their balances added into one table), each chain run closed
    at its end, and about 2 % of the wave events naming no debit account
    (slot -1, its static code set).  With `n`, the two wave parts fill
    the batch to n events."""
    rng = np.random.default_rng(seed)
    rows = np.arange(A) if rows is None else np.asarray(rows)
    pools = np.array_split(rng.permutation(rows), 4)
    n_chains = max(2, B // 25)
    # The chain parts first: a filled batch's wave parts take what they leave.
    chains = {k: wave_cases.chain_case(seed * 4 + k, n_chains, 8 * n_chains, A=A,
                                       rows=pools[k]) for k in (1, 3)}
    if n is None:
        n_wide = [B // 5, B // 5]
    else:
        rest = n - sum(case[3] for case in chains.values())
        n_wide = [rest // 2, rest - rest // 2]
    table = np.zeros((A, 8), np.uint64)
    parts = []
    for k, pool in enumerate(pools):
        if k % 2 == 0:
            t, ev, dstat, m, _ts, _plan = wave_cases.wide_case(
                seed * 4 + k, n_wide[k // 2] + 2, A, rows=pool, n=n_wide[k // 2])
            missing = (rng.random(m) < 0.02) & ~ev["p_found"][:m]
            ev["dr_slot"][:m][missing] = -1
            ev["static_result"][:m][missing] = R_DEBIT_ACCOUNT_NOT_FOUND
        else:
            t, ev, dstat, m, _ts, _plan = chains[k]
            ev["flags"][m - 1] &= ~np.uint32(wave_cases.F_LINKED)
        table += t
        parts.append((ev, dstat, m))
    ev, dstat, n = _join_parts(parts, B)
    plan = wave_cases._plan(ev, n)
    assert [k for k, _ in plan.segments] == ["wave", "chains", "wave", "chains"], (
        [k for k, _ in plan.segments])
    return table, ev, dstat, n, wave_cases.TS_BASE, plan


def chains_case(seed, B, A, rows):
    """(table, ev, dstat, B, ts_base, plan) for a batch of exactly B
    events planned as a chain wave, then a wave: chain_case's
    independent chains (about three quarters of the batch, the last
    chain closed) followed by a wide_case part filling the batch, on
    disjoint halves of `rows`."""
    pools = np.array_split(np.random.default_rng(seed).permutation(np.asarray(rows)), 2)
    t_c, ev_c, dstat_c, n_c, _ts, _plan = wave_cases.chain_case(seed, B // 6, B, A=A,
                                                                rows=pools[0])
    ev_c["flags"][n_c - 1] &= ~np.uint32(wave_cases.F_LINKED)
    t_w, ev_w, dstat_w, n_w, _ts, _plan = wave_cases.wide_case(seed + 1, B - n_c, A,
                                                               rows=pools[1], n=B - n_c)
    ev, dstat, n = _join_parts([(ev_c, dstat_c, n_c), (ev_w, dstat_w, n_w)], B)
    plan = wave_cases._plan(ev, n)
    assert [k for k, _ in plan.segments] == ["chains", "wave"], [k for k, _ in plan.segments]
    return t_c + t_w, ev, dstat, n, wave_cases.TS_BASE, plan


def full_case(seed, shape, B, A, rows):
    """(table, ev, dstat, B, ts_base, plan) for a batch of exactly B
    events on `rows` whose plan the sharded executor takes: "wide" (one
    wave), "chains" (a chain wave, then a wave) or "mixed" (wave,
    chains, wave, chains)."""
    if shape == "wide":
        return wave_cases.wide_case(seed, B, A, rows=rows, n=B)
    if shape == "chains":
        return chains_case(seed, B, A, rows)
    return mixed_case(seed, B, A, rows=rows, n=B)


STREAM_SHAPES = ("wide", "chains", "mixed")


def wave_stream(seed, n_batches, B, A):
    """(table, batches): `n_batches` batches of exactly B events, each a
    (ev, dstat, n, ts_base, plan) of full_case cycling through
    STREAM_SHAPES, on its own pool of rows of one (A, 8) u64 table that
    holds every batch's balances.  The batches run one after another on
    that table; each touches only its pool."""
    pools = np.array_split(np.random.default_rng(seed).permutation(A), n_batches)
    table = np.zeros((A, 8), np.uint64)
    batches = []
    for k, pool in enumerate(pools):
        t, *batch = full_case(seed + 10 * (k + 1), STREAM_SHAPES[k % len(STREAM_SHAPES)], B,
                              A, np.sort(pool))
        assert batch[2] == B and waves.plan_shardable(batch[4]), (k, batch[2])
        table += t
        batches.append(tuple(batch))
    return table, batches


def shardable_cases(seed, B, A, rows=None):
    """(name, case) of every wave_cases shape whose plan the sharded
    executor takes: one wide wave, one chain wave, and the mixed plan."""
    cases = [
        ("wide", wave_cases.wide_case(seed, B, A, rows=rows)),
        ("chains", wave_cases.chain_case(seed + 1, max(2, B // 8), B, A=A, rows=rows)),
        ("mixed", mixed_case(seed + 2, B, A, rows=rows)),
    ]
    for name, case in cases:
        assert waves.plan_shardable(case[5]), name
    return cases


def hist_fix(plan, n, B) -> np.ndarray:
    """The (B,) mask of events whose snapshots become batch finals."""
    fix = np.zeros(B, bool)
    fix[:n] = plan.wave_mask
    return fix


def pv_balancing_stream(seed, n_batches, batch, n_accounts, history_batches=()):
    """(setup, timed): accounts 1..n_accounts, then 2 * len(history_batches)
    history accounts after them; `n_batches` create_transfers batches of
    exactly `batch` events.  A batch is P (pending, post) pairs (P =
    2 * batch // 5) over accounts drawn from the pool below the riders'
    accounts, then balancing_debit riders, each on its own account pair
    (reused by every batch).  A batch whose index is in
    `history_batches` has its first pair's pending between two history
    accounts instead (its post stays on it)."""
    rng = np.random.default_rng(seed)
    P = 2 * batch // 5
    Q = batch - 2 * P
    pool = n_accounts - 2 * Q
    hist0 = n_accounts + 1
    setup = workload._create_accounts(n_accounts)
    if history_batches:
        ids = np.arange(hist0, hist0 + 2 * len(history_batches), dtype=np.uint64)
        setup.append((Operation.create_accounts, workload.accounts_bytes(
            ids, flags=np.full(len(ids), int(AccountFlags.history), np.uint16))))
    pend, post, bal = (int(TransferFlags.pending), int(TransferFlags.post_pending_transfer),
                       int(TransferFlags.balancing_debit))
    rider_dr = np.arange(pool + 1, pool + 1 + 2 * Q, 2, dtype=np.uint64)
    timed, tid = [], workload.TID0
    for k in range(n_batches):
        dr = rng.integers(1, pool + 1, P).astype(np.uint64)
        cr = (dr + rng.integers(1, pool, P).astype(np.uint64) - 1) % np.uint64(pool) + 1
        if k in history_batches:
            h = hist0 + 2 * list(history_batches).index(k)
            dr[0], cr[0] = h, h + 1
        ids = np.arange(tid, tid + batch, dtype=np.uint64)
        pair_dr = np.zeros(2 * P, np.uint64)
        pair_cr = np.zeros(2 * P, np.uint64)
        pair_dr[0::2], pair_cr[0::2] = dr, cr
        amount = np.zeros(2 * P, np.uint64)
        amount[0::2] = rng.integers(1, 50, P)
        flags = np.zeros(batch, np.uint16)
        flags[0:2 * P:2], flags[1:2 * P:2], flags[2 * P:] = pend, post, bal
        pending_id = np.zeros(batch, np.uint64)
        pending_id[1:2 * P:2] = ids[0:2 * P:2]
        timed.append((Operation.create_transfers, workload.transfers_bytes(
            ids, np.concatenate([pair_dr, rider_dr]), np.concatenate([pair_cr, rider_dr + 1]),
            np.concatenate([amount, rng.integers(1, 20, Q).astype(np.uint64)]),
            flags=flags, pending_id=pending_id)))
        tid += batch
    return setup, timed

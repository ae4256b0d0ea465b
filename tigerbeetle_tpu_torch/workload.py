"""create_transfers workload generators (the reference's bench shapes).

This package's own copy of the generators in the repository's
``bench.py`` (which imports the JAX package): the same seeds and draws,
so with default arguments the streams are byte-identical to bench's.
``n_accounts`` widens a workload's account set (default: bench's
value); ``batch`` is the events per create_transfers batch (bench's
BENCH_BATCH, default 8190).

Each generator returns (setup_ops, timed_ops, sizing): ops are
[(Operation, bytes)] and sizing is (account_capacity, transfer_capacity).
Setup holds the create_accounts batches plus one untimed warmup
transfer batch (ids from WARM0).
"""

from __future__ import annotations

import numpy as np

from tigerbeetle_tpu_torch.types import (
    ACCOUNT_DTYPE,
    TRANSFER_DTYPE,
    AccountFlags,
    Operation,
    TransferFlags,
)

AF = AccountFlags
TF = TransferFlags

BATCH = 8_190   # events per create_transfers batch (the wire maximum)
TID0 = 1        # first timed transfer id
WARM0 = 50_000_000  # warmup transfer ids


def accounts_bytes(ids, ledger=None, flags=None) -> bytes:
    ids = np.asarray(ids, np.uint64)
    arr = np.zeros(len(ids), dtype=ACCOUNT_DTYPE)
    arr["id_lo"] = ids
    arr["ledger"] = 1 if ledger is None else ledger
    arr["code"] = 1
    if flags is not None:
        arr["flags"] = flags
    return arr.tobytes()


def transfers_bytes(ids, dr, cr, amount, *, ledger=1, flags=None,
                    pending_id=None, timeout=None) -> bytes:
    arr = np.zeros(len(ids), dtype=TRANSFER_DTYPE)
    arr["id_lo"] = ids
    arr["debit_account_id_lo"] = dr
    arr["credit_account_id_lo"] = cr
    arr["amount_lo"] = amount
    arr["ledger"] = ledger
    arr["code"] = 1
    if flags is not None:
        arr["flags"] = flags
    if pending_id is not None:
        arr["pending_id_lo"] = pending_id
    if timeout is not None:
        arr["timeout"] = timeout
    return arr.tobytes()


def batched(ops_arrays, batch: int = BATCH, op=Operation.create_transfers):
    """Split one big per-event array dict into (op, bytes) batches."""
    out = []
    n = len(ops_arrays["ids"])
    for at in range(0, n, batch):
        sl = slice(at, min(at + batch, n))
        out.append(
            (
                op,
                transfers_bytes(
                    ops_arrays["ids"][sl], ops_arrays["dr"][sl],
                    ops_arrays["cr"][sl], ops_arrays["amount"][sl],
                    ledger=ops_arrays.get("ledger", 1),
                    **{
                        key: ops_arrays[key][sl]
                        for key in ("flags", "pending_id", "timeout")
                        if key in ops_arrays
                    },
                ),
            )
        )
    return out


def _create_accounts(n_accounts: int):
    """create_accounts ops for ids 1..n_accounts, at most BATCH per op
    (one op for bench's account counts)."""
    return [
        (Operation.create_accounts,
         accounts_bytes(range(at + 1, min(at + BATCH, n_accounts) + 1)))
        for at in range(0, n_accounts, BATCH)
    ]


def _sizing(n_accounts: int, transfer_capacity: int):
    cap = 1 << 12
    while cap < n_accounts:
        cap <<= 1
    return cap, transfer_capacity


def gen_simple(n_events: int, n_accounts: int = 1_000, batch: int = BATCH):
    """Uniform debit account, credit = debit % n + 1, amounts 1..99."""
    rng = np.random.default_rng(42)
    setup = _create_accounts(n_accounts)
    warm_n = min(batch, n_events)
    dr = rng.integers(1, n_accounts + 1, warm_n, np.uint64)
    setup += batched(
        {
            "ids": np.arange(WARM0, WARM0 + warm_n, dtype=np.uint64),
            "dr": dr,
            "cr": dr % np.uint64(n_accounts) + np.uint64(1),
            "amount": rng.integers(1, 100, warm_n, np.uint64),
        },
        batch,
    )
    dr = rng.integers(1, n_accounts + 1, n_events, np.uint64)
    timed = batched(
        {
            "ids": np.arange(TID0, TID0 + n_events, dtype=np.uint64),
            "dr": dr,
            "cr": dr % np.uint64(n_accounts) + np.uint64(1),
            "amount": rng.integers(1, 100, n_events, np.uint64),
        },
        batch,
    )
    return setup, timed, _sizing(n_accounts, n_events + 2 * batch + 1024)


def gen_zipf(n_events: int, n_accounts: int = 100, batch: int = BATCH):
    """Zipf-skewed (p ~ 1/rank) debit and credit accounts: the
    hot-account contention shape."""
    rng = np.random.default_rng(45)
    ranks = np.arange(1, n_accounts + 1, dtype=np.float64)
    p = (1.0 / ranks) / (1.0 / ranks).sum()
    setup = _create_accounts(n_accounts)
    warm_n = min(batch, n_events)

    def draw(n):
        dr = rng.choice(n_accounts, size=n, p=p).astype(np.uint64) + np.uint64(1)
        cr = rng.choice(n_accounts, size=n, p=p).astype(np.uint64) + np.uint64(1)
        clash = cr == dr
        cr[clash] = dr[clash] % np.uint64(n_accounts) + np.uint64(1)
        return dr, cr

    dr, cr = draw(warm_n)
    setup += batched(
        {
            "ids": np.arange(WARM0, WARM0 + warm_n, dtype=np.uint64),
            "dr": dr, "cr": cr,
            "amount": rng.integers(1, 100, warm_n, np.uint64),
        },
        batch,
    )
    dr, cr = draw(n_events)
    timed = batched(
        {
            "ids": np.arange(TID0, TID0 + n_events, dtype=np.uint64),
            "dr": dr, "cr": cr,
            "amount": rng.integers(1, 100, n_events, np.uint64),
        },
        batch,
    )
    return setup, timed, _sizing(n_accounts, n_events + 2 * batch + 1024)


def gen_linked(n_events: int, n_accounts: int = 1_000, batch: int = BATCH):
    """Chains of 1-7 (mean 4), half the accounts debit-limited and
    funded in setup, so most chains succeed while some trip the limit
    and roll back whole chains."""
    rng = np.random.default_rng(43)
    limited = np.arange(1, n_accounts // 2 + 1, dtype=np.uint64)
    flags = np.zeros(n_accounts, np.uint16)
    flags[: n_accounts // 2] = int(AF.debits_must_not_exceed_credits)
    setup = [
        (Operation.create_accounts,
         accounts_bytes(range(at + 1, min(at + BATCH, n_accounts) + 1),
                        flags=flags[at : at + BATCH]))
        for at in range(0, n_accounts, BATCH)
    ]
    # Fund the limited accounts: credit each from the last plain account.
    setup += batched(
        {
            "ids": np.arange(WARM0, WARM0 + len(limited), dtype=np.uint64),
            "dr": np.full(len(limited), n_accounts, np.uint64),
            "cr": limited,
            "amount": np.full(len(limited), 50_000, np.uint64),
        },
        batch,
    )
    warm = _chain_events(rng, 2 * batch, n_accounts, WARM0 + 1_000_000, batch)
    setup += _chain_batches(warm, batch)
    timed = _chain_batches(_chain_events(rng, n_events, n_accounts, TID0, batch), batch)
    n_total = sum(len(b) // 128 for _op, b in timed)
    return setup, timed, _sizing(n_accounts, n_total + 4 * batch + len(limited) + 1024)


def _chain_events(rng, n_events, n_acct, id0, batch=BATCH):
    lens = rng.integers(1, 8, size=n_events // 2 + batch)  # mean 4
    ends = np.cumsum(lens)
    n_chains = int(np.searchsorted(ends, n_events, side="left")) + 1
    lens = lens[:n_chains]
    total = int(lens.sum())
    # The linked flag on every chain member except the last.
    last_idx = np.cumsum(lens) - 1
    flags = np.full(total, int(TF.linked), np.uint16)
    flags[last_idx] = 0
    dr = rng.integers(1, n_acct + 1, total, np.uint64)
    cr = rng.integers(1, n_acct + 1, total, np.uint64)
    clash = cr == dr
    cr[clash] = dr[clash] % np.uint64(n_acct) + np.uint64(1)
    return {
        "ids": np.arange(id0, id0 + total, dtype=np.uint64),
        "dr": dr,
        "cr": cr,
        "amount": rng.integers(1, 200, total, np.uint64),
        "flags": flags,
        "chain_ends": np.cumsum(lens),
    }


def _chain_batches(ev, batch=BATCH):
    """Batch without splitting a chain across batches (an open chain at
    the end of a batch fails with linked_event_chain_open)."""
    out = []
    ends = ev["chain_ends"]
    total = len(ev["ids"])
    start = 0
    while start < total:
        hi = int(np.searchsorted(ends, start + batch, side="right"))
        if hi == 0 or ends[hi - 1] <= start:
            break
        stop = int(ends[hi - 1])
        sl = slice(start, stop)
        out.append((
            Operation.create_transfers,
            transfers_bytes(ev["ids"][sl], ev["dr"][sl], ev["cr"][sl],
                            ev["amount"][sl], flags=ev["flags"][sl]),
        ))
        start = stop
    return out


def gen_two_phase(n_events: int, n_accounts: int = 1_000, batch: int = BATCH):
    """Adjacent (pending, post | void) pairs, 30 % void, the amount
    inherited (zero means inherit; reference:
    src/state_machine.zig:1743-1804)."""
    rng = np.random.default_rng(44)
    setup = _create_accounts(n_accounts)
    n_pairs = n_events // 2

    def pairs(n, id0):
        ids = np.arange(id0, id0 + 2 * n, dtype=np.uint64)
        flags = np.zeros(2 * n, np.uint16)
        flags[0::2] = int(TF.pending)
        void = rng.random(n) < 0.30
        flags[1::2] = np.where(
            void, int(TF.void_pending_transfer), int(TF.post_pending_transfer)
        ).astype(np.uint16)
        pending_id = np.zeros(2 * n, np.uint64)
        pending_id[1::2] = ids[0::2]
        dr = np.zeros(2 * n, np.uint64)
        cr = np.zeros(2 * n, np.uint64)
        dr[0::2] = rng.integers(1, n_accounts + 1, n, np.uint64)
        cr[0::2] = dr[0::2] % np.uint64(n_accounts) + np.uint64(1)
        amount = np.zeros(2 * n, np.uint64)
        amount[0::2] = rng.integers(1, 100, n, np.uint64)
        return {
            "ids": ids, "dr": dr, "cr": cr, "amount": amount,
            "flags": flags, "pending_id": pending_id,
        }

    setup += batched(pairs(batch // 2, WARM0), batch)
    timed = batched(pairs(n_pairs, TID0), batch)
    return setup, timed, _sizing(n_accounts, 2 * n_pairs + 4 * batch + 1024)


def gen_offkernel(n_events: int, n_accounts: int = 1_001, batch: int = BATCH):
    """Batches the semantic kernels cannot express: (pending, post)
    pairs with balancing riders on a funded side pool, and independent
    3-member linked chains whose first member is a pending.  Creates
    accounts 1 .. n_accounts - 1 (bench's odd count); the last 200 are
    the balancing pool."""
    rng = np.random.default_rng(46)
    n_bal = 200
    bal0 = n_accounts - n_bal
    setup = [
        (Operation.create_accounts,
         accounts_bytes(range(at + 1, min(at + BATCH, n_accounts - 1) + 1)))
        for at in range(0, n_accounts - 1, BATCH)
    ]
    # Fund the balancing pool so riders usually apply.
    setup += batched(
        {
            "ids": np.arange(WARM0, WARM0 + n_bal, dtype=np.uint64),
            "dr": np.full(n_bal, 1, np.uint64),
            "cr": np.arange(bal0, bal0 + n_bal, dtype=np.uint64),
            "amount": np.full(n_bal, 1_000_000, np.uint64),
        },
        batch,
    )

    def pvbal_batch(m, id0):
        riders = min(8, m // 4)
        n_pairs = (m - riders) // 2
        m = 2 * n_pairs + riders
        ids = np.arange(id0, id0 + m, dtype=np.uint64)
        flags = np.zeros(m, np.uint16)
        flags[0 : 2 * n_pairs : 2] = int(TF.pending)
        flags[1 : 2 * n_pairs : 2] = int(TF.post_pending_transfer)
        flags[2 * n_pairs :] = int(TF.balancing_debit)
        pending_id = np.zeros(m, np.uint64)
        pending_id[1 : 2 * n_pairs : 2] = ids[0 : 2 * n_pairs : 2]
        dr = np.zeros(m, np.uint64)
        cr = np.zeros(m, np.uint64)
        dr[0 : 2 * n_pairs : 2] = rng.integers(1, bal0, n_pairs, np.uint64)
        cr[0 : 2 * n_pairs : 2] = dr[0 : 2 * n_pairs : 2] % np.uint64(
            bal0 - 1
        ) + np.uint64(1)
        # Distinct funded accounts per rider.
        pick = rng.choice(n_bal, 2 * riders, replace=False).astype(np.uint64)
        dr[2 * n_pairs :] = bal0 + pick[:riders]
        cr[2 * n_pairs :] = bal0 + pick[riders:]
        amount = np.zeros(m, np.uint64)
        amount[0 : 2 * n_pairs : 2] = rng.integers(1, 100, n_pairs, np.uint64)
        amount[2 * n_pairs :] = rng.integers(1, 50, riders, np.uint64)
        return {
            "ids": ids, "dr": dr, "cr": cr, "amount": amount,
            "flags": flags, "pending_id": pending_id,
        }, id0 + m

    def chain_batch(m, id0):
        n_chains = m // 3
        m = 3 * n_chains
        ids = np.arange(id0, id0 + m, dtype=np.uint64)
        flags = np.zeros(m, np.uint16)
        flags[0::3] = int(TF.linked | TF.pending)
        flags[1::3] = int(TF.linked)
        # Disjoint account pairs per chain.
        base = rng.permutation(bal0 - 2)[:n_chains].astype(np.uint64)
        dr = np.repeat(base + 1, 3)
        cr = np.repeat(base + 2, 3)
        amount = rng.integers(1, 60, m).astype(np.uint64)
        return {
            "ids": ids, "dr": dr, "cr": cr, "amount": amount,
            "flags": flags,
        }, id0 + m

    timed = []
    tid = TID0
    events = 0
    k = 0
    while events < n_events:
        m = min(batch, n_events - events)
        if m < 8:
            break
        arrs, tid = chain_batch(m, tid) if k % 3 == 2 else pvbal_batch(m, tid)
        timed += batched(arrs, batch)
        events += len(arrs["ids"])
        k += 1
    return setup, timed, (n_accounts + 1, (tid - TID0) + 4 * batch + 1024)


def gen_waves_host(n_events: int, n_accounts: int = 1_000_000, n_limited: int = 1_000,
                   batch: int = BATCH, chain_share: float = 0.1, runs: int = 8):
    """The host engine's wave stream (no counterpart in bench): per
    batch, about (1 - chain_share) of the events are transfers between
    random pairs of the plain accounts n_limited + 1 .. n_accounts, the
    rest gen_linked-style chains of 1-7 over the first n_limited
    accounts, all debit-limited and funded in setup, placed as `runs`
    contiguous runs at random batch positions.  The chains read the
    balances they debit, so a wave plan runs them as scan segments
    among parallel waves of the plain transfers."""
    rng = np.random.default_rng(49)
    flags = np.zeros(n_accounts, np.uint16)
    flags[:n_limited] = int(AF.debits_must_not_exceed_credits)
    setup = [
        (Operation.create_accounts,
         accounts_bytes(range(at + 1, min(at + BATCH, n_accounts) + 1),
                        flags=flags[at : at + BATCH]))
        for at in range(0, n_accounts, BATCH)
    ]
    limited = np.arange(1, n_limited + 1, dtype=np.uint64)
    setup += batched(
        {
            "ids": np.arange(WARM0, WARM0 + n_limited, dtype=np.uint64),
            "dr": np.full(n_limited, n_accounts, np.uint64),
            "cr": limited,
            "amount": np.full(n_limited, 50_000, np.uint64),
        },
        batch,
    )
    timed = []
    tid = TID0
    done = 0
    n_plain_acct = n_accounts - n_limited
    while done < n_events:
        m = min(batch, n_events - done)
        ch = _chain_events(rng, max(2, int(chain_share * m)), n_limited, 0, batch)
        k = len(ch["ids"])
        p = m - k
        dr = rng.integers(0, n_plain_acct, p)
        cr = (dr + rng.integers(1, n_plain_acct, p)) % n_plain_acct
        # Split the chains into runs at chain boundaries and slot each
        # run in before a random plain event.
        ends = ch["chain_ends"]
        cuts = np.sort(rng.choice(len(ends) - 1, min(runs, len(ends)) - 1, replace=False))
        bounds = np.concatenate([[0], ends[cuts], [k]])
        at = np.sort(rng.integers(0, p + 1, len(bounds) - 1))
        order = []
        prev = 0
        for r, pos in enumerate(at):
            order.append(np.arange(prev, pos))
            order.append(p + np.arange(bounds[r], bounds[r + 1]))
            prev = pos
        order.append(np.arange(prev, p))
        order = np.concatenate(order)
        all_dr = np.concatenate([dr.astype(np.uint64) + np.uint64(n_limited + 1), ch["dr"]])
        all_cr = np.concatenate([cr.astype(np.uint64) + np.uint64(n_limited + 1), ch["cr"]])
        amount = np.concatenate([rng.integers(1, 100, p, np.uint64), ch["amount"]])
        fl = np.concatenate([np.zeros(p, np.uint16), ch["flags"]])
        timed.append((
            Operation.create_transfers,
            transfers_bytes(np.arange(tid, tid + m, dtype=np.uint64), all_dr[order],
                            all_cr[order], amount[order], flags=fl[order]),
        ))
        tid += m
        done += m
    return setup, timed, _sizing(n_accounts, done + n_limited + 1024)

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

from tigerbeetle_tpu_torch.types import ACCOUNT_DTYPE, TRANSFER_DTYPE, Operation

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


def transfers_bytes(ids, dr, cr, amount, *, ledger=1, flags=None) -> bytes:
    arr = np.zeros(len(ids), dtype=TRANSFER_DTYPE)
    arr["id_lo"] = ids
    arr["debit_account_id_lo"] = dr
    arr["credit_account_id_lo"] = cr
    arr["amount_lo"] = amount
    arr["ledger"] = ledger
    arr["code"] = 1
    if flags is not None:
        arr["flags"] = flags
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
                    flags=ops_arrays["flags"][sl] if "flags" in ops_arrays else None,
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

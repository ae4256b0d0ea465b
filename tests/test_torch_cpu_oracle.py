"""The port's CPU oracle (tigerbeetle_tpu_torch/state_machine/cpu.py, a
copy of the reference's) against the JAX package's CpuStateMachine on
the same wire streams: create_accounts with every account flag and the
invalid fields, create_transfers with every combination of the six
transfer flags, random streams with id reuse, chains, two-phase races,
balancing and limit accounts, expiry pulses from clock jumps, then
lookup_accounts / lookup_transfers, get_account_transfers and
get_account_balances under every filter flag, state_root, and the
snapshot bytes and a restore.  Every reply and timestamp bit for bit."""

import numpy as np
import pytest

from tigerbeetle_tpu import types as ref_types
from tigerbeetle_tpu.state_machine.cpu import CpuStateMachine as RefCpu
from tigerbeetle_tpu.testing import harness as ref_hz
from tigerbeetle_tpu_torch import types
from tigerbeetle_tpu_torch.state_machine import CpuStateMachine
from tigerbeetle_tpu_torch.testing import harness as hz

AF = types.AccountFlags
TF = types.TransferFlags
Op = types.Operation
NS = 1_000_000_000


class Pair:
    """The port's oracle and the reference's, fed the same ops."""

    def __init__(self) -> None:
        self.port = hz.SingleNodeHarness(CpuStateMachine())
        self.ref = ref_hz.SingleNodeHarness(RefCpu())

    def submit(self, op, body: bytes, realtime=None) -> bytes:
        want = self.ref.submit(op, body, realtime=realtime)
        got = self.port.submit(op, body, realtime=realtime)
        assert got == want, f"{op.name} replies diverge"
        for name in ("commit_timestamp", "pulse_next_timestamp"):
            assert getattr(self.port.sm, name) == getattr(self.ref.sm, name), name
        return got


def account_filter(account_id, flags, timestamp_min=0, timestamp_max=0, limit=8190,
                   reserved=0) -> bytes:
    row = np.zeros(1, dtype=types.ACCOUNT_FILTER_DTYPE)[0]
    types.u128_set(row, "account_id", account_id)
    row["timestamp_min"] = timestamp_min
    row["timestamp_max"] = timestamp_max
    row["limit"] = limit
    row["flags"] = flags
    row["reserved"][0] = reserved
    return row.tobytes()


def queries(pair: Pair, account_ids, transfer_ids, ts_mid: int) -> None:
    """Lookups, both history queries under every filter flag combination
    (the invalid ones too), limits and timestamp ranges; state roots."""
    pair.submit(Op.lookup_accounts, hz.ids_bytes(list(account_ids) + [0, 999_999]))
    pair.submit(Op.lookup_transfers, hz.ids_bytes(sorted(set(transfer_ids)) + [0, 777_777]))
    for aid in list(account_ids) + [0, 999_999]:
        for flags in range(8):
            for kw in ({}, {"limit": 2}, {"timestamp_min": ts_mid},
                       {"timestamp_max": ts_mid}, {"limit": 0}, {"reserved": 1}):
                body = account_filter(aid, flags, **kw)
                pair.submit(Op.get_account_transfers, body)
                pair.submit(Op.get_account_balances, body)
    assert pair.port.sm.state_root() == pair.ref.sm.state_root()


def test_types_match_reference():
    for name in ("AccountFlags", "TransferFlags", "AccountFilterFlags", "TransferPendingStatus",
                 "CreateAccountResult", "CreateTransferResult", "Operation"):
        mine, theirs = getattr(types, name), getattr(ref_types, name)
        assert {m.name: int(m) for m in mine} == {m.name: int(m) for m in theirs}, name
    for name in ("AccountFlags", "TransferFlags", "AccountFilterFlags"):
        assert int(getattr(types, name)._valid_mask) == int(getattr(ref_types, name)._valid_mask)
    assert types.READ_OPERATIONS == ref_types.READ_OPERATIONS
    for name in ("TRANSFER_DTYPE", "ACCOUNT_DTYPE", "ACCOUNT_FILTER_DTYPE",
                 "ACCOUNT_BALANCE_DTYPE", "CREATE_RESULT_DTYPE"):
        assert getattr(types, name) == getattr(ref_types, name), name


def test_every_account_and_transfer_flag():
    """Accounts under every account-flag combination and the invalid
    fields; then one transfer for every combination of the six transfer
    flags (valid and refused alike), in linked and unlinked batches,
    with pendings for the post/void combinations to name."""
    pair = Pair()
    accts = [hz.account(i + 1, flags=f) for i, f in enumerate(range(16))]  # 1..16
    accts += [
        hz.account(0), hz.account((1 << 128) - 1), hz.account(17, ledger=0),
        hz.account(18, code=0), hz.account(19, flags=1 << 9), hz.account(3),
        hz.account(20, debits_posted=5), hz.account(21, flags=int(AF.debits_must_not_exceed_credits
                                                                 | AF.credits_must_not_exceed_debits)),
        hz.account(22, timestamp=7), hz.account(23), hz.account(23, code=2),
    ]
    pair.submit(Op.create_accounts, hz.pack(accts))
    # Fund the limit accounts so limits both pass and trip.
    pair.submit(Op.create_transfers, hz.pack([
        hz.transfer(10_000 + a, debit_account_id=1 if a != 1 else 9, credit_account_id=a,
                    amount=50) for a in range(2, 17)
    ]))
    pendings = [hz.transfer(20_000 + k, debit_account_id=1 + k % 16, credit_account_id=1 + (k + 1) % 16,
                            amount=20, flags=int(TF.pending), timeout=k % 3)
                for k in range(64)]
    pair.submit(Op.create_transfers, hz.pack(pendings))
    ids = [r["id_lo"] for r in pendings]
    for linked_batch in (False, True):
        rows = []
        for f in range(64):
            tid = 30_000 + 100 * linked_batch + f
            flags = f if linked_batch else f & ~int(TF.linked)
            pv = f & int(TF.post_pending_transfer | TF.void_pending_transfer)
            rows.append(hz.transfer(
                tid, debit_account_id=0 if pv else 1 + f % 16,
                credit_account_id=0 if pv else 1 + (f + 3) % 16,
                amount=f % 7 * 10, pending_id=20_000 + f if pv else 0,
                timeout=1 if f & int(TF.pending) else 0, flags=flags, ledger=1 if f % 11 else 2,
            ))
            ids.append(tid)
        pair.submit(Op.create_transfers, hz.pack(rows))
    pair.submit(Op.create_transfers, hz.pack([hz.transfer(40_000, debit_account_id=1,
                                                          credit_account_id=2, amount=1,
                                                          flags=1 << 9)]))
    queries(pair, range(1, 24), ids, pair.ref.sm.commit_timestamp - 40)


def random_transfer(rng, ids, account_ids, t_index):
    """One event (tests/test_parity_fuzz.py's distribution)."""
    kind = rng.random()
    flags = 0
    amount = int(rng.integers(0, 50))
    timeout = 0
    pending_id = 0
    if kind < 0.45:
        if rng.random() < 0.4:
            flags |= TF.pending
            if rng.random() < 0.5:
                timeout = int(rng.integers(1, 4))
        if rng.random() < 0.25:
            flags |= TF.balancing_debit if rng.random() < 0.5 else TF.balancing_credit
    elif kind < 0.75:
        flags |= TF.post_pending_transfer if rng.random() < 0.6 else TF.void_pending_transfer
        pending_id = (int(rng.choice(ids)) if len(ids) and rng.random() < 0.8
                      else int(rng.integers(0, 30)))
    else:
        flags |= TF.pending if rng.random() < 0.3 else 0
    if rng.random() < 0.25:
        flags |= TF.linked
    new_id = int(rng.choice(ids)) if len(ids) and rng.random() < 0.35 else t_index + 100
    return hz.transfer(
        new_id,
        debit_account_id=(int(rng.choice(account_ids)) if rng.random() < 0.9
                          else int(rng.integers(0, 99))),
        credit_account_id=(int(rng.choice(account_ids)) if rng.random() < 0.9
                           else int(rng.integers(0, 99))),
        amount=amount, pending_id=pending_id,
        user_data_128=int(rng.integers(0, 3)), user_data_64=int(rng.integers(0, 3)),
        user_data_32=int(rng.integers(0, 3)), timeout=timeout,
        ledger=int(rng.choice([1, 1, 1, 2])), code=int(rng.integers(0, 3)), flags=int(flags),
    ), new_id


@pytest.mark.parametrize("seed", range(6))
def test_random_stream_with_expiry_and_queries(seed):
    """Random batches with clock jumps (so the harness injects expiry
    pulses), then every query; then the snapshot bytes, and a restored
    port oracle that continues the stream as the reference does."""
    rng = np.random.default_rng(seed)
    pair = Pair()
    account_ids = list(range(1, 13))
    rows = []
    for aid in account_ids:
        flags = 0
        r = rng.random()
        if r < 0.2:
            flags |= AF.debits_must_not_exceed_credits
        elif r < 0.4:
            flags |= AF.credits_must_not_exceed_debits
        if rng.random() < 0.3:
            flags |= AF.history
        if rng.random() < 0.1:
            flags |= AF.linked
        rows.append(hz.account(aid, flags=int(flags), ledger=1 if rng.random() < 0.85 else 2))
    pair.submit(Op.create_accounts, hz.pack(rows))

    ids: list[int] = []
    t_index = 0
    realtime = 0
    ts_mid = 0
    for batch_no in range(12):
        batch = []
        for _ in range(int(rng.integers(1, 30))):
            row, new_id = random_transfer(rng, ids, account_ids, t_index)
            batch.append(row)
            ids.append(new_id)
            t_index += 1
        if rng.random() < 0.3:  # jump the clock: expiry pulses
            realtime += int(rng.integers(1, 4)) * NS
        pair.submit(Op.create_transfers, hz.pack(batch), realtime=realtime)
        if batch_no == 6:
            ts_mid = pair.ref.sm.commit_timestamp
    realtime += 5 * NS  # every timeout passes: the next op's pulses expire them all
    pair.submit(Op.lookup_accounts, hz.ids_bytes(account_ids), realtime=realtime)
    queries(pair, account_ids, ids, ts_mid)

    snap = pair.port.sm.snapshot()
    assert snap == pair.ref.sm.snapshot()
    restored = CpuStateMachine()
    restored.restore(snap)
    assert restored.snapshot() == snap
    cont = hz.pack([random_transfer(rng, ids, account_ids, t_index + k)[0] for k in range(20)])
    # prepare_timestamp is primary-only state the snapshot leaves out:
    # the queries advanced it past commit_timestamp.
    restored.prepare_timestamp = pair.ref.sm.prepare_timestamp
    pair.port = hz.SingleNodeHarness(restored)
    pair.port.realtime = pair.ref.realtime
    pair.port.op = pair.ref.op
    pair.submit(Op.create_transfers, cont)
    assert pair.port.sm.state_root() == pair.ref.sm.state_root()

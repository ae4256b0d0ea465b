"""get_account_transfers / get_account_balances and checkpoint snapshot /
restore of TorchStateMachine, on both engines, against TpuStateMachine.

tests/test_queries.py's cases, with every reply of the port asserted
byte-equal to the reference machine's on the same engine; a stream with
history accounts, two-phase transfers and linked chains queried in
every direction; and snapshot -> restore -> continue: the port's blob
equals the reference's, a restored machine snapshots to the same blob,
and its later replies and roots equal an uninterrupted run's and the
reference's restored machine's (tiered included)."""

import numpy as np
import pytest

from tigerbeetle_tpu.state_machine.cpu import CpuStateMachine
from tigerbeetle_tpu.state_machine.tpu import TpuStateMachine
from tigerbeetle_tpu.testing import harness as ref_hz
from tigerbeetle_tpu_torch import types
from tigerbeetle_tpu_torch.state_machine.gpu import TorchStateMachine
from tigerbeetle_tpu_torch.testing import harness as hz
from torch_link_quiet import link_quiet  # noqa: F401  (autouse: no engine lost its link)

AF = types.AccountFlags
FF = types.AccountFilterFlags
TF = types.TransferFlags
Op = types.Operation


def account_filter(account_id, *, timestamp_min=0, timestamp_max=0, limit=8190,
                   flags=FF.debits | FF.credits, reserved=b"\x00" * 24) -> bytes:
    row = np.zeros(1, dtype=types.ACCOUNT_FILTER_DTYPE)[0]
    types.u128_set(row, "account_id", account_id)
    row["timestamp_min"] = timestamp_min
    row["timestamp_max"] = timestamp_max
    row["limit"] = limit
    row["flags"] = flags
    row["reserved"] = np.frombuffer(reserved, dtype=np.uint8)
    return row.tobytes()


class Pair:
    """The port and the reference machine on one engine, one harness
    each; every reply must be byte-equal."""

    def __init__(self, engine, account_capacity=1 << 12):
        self.sm = TorchStateMachine(account_capacity=account_capacity, device="cpu",
                                    engine=engine)
        self.ref = TpuStateMachine(account_capacity=account_capacity, engine=engine)
        self.h = hz.SingleNodeHarness(self.sm)
        self.h_ref = ref_hz.SingleNodeHarness(self.ref)

    def submit(self, op, body):
        reply = self.h.submit(op, body)
        assert reply == self.h_ref.submit(op, body), f"{op!r} differs from the reference"
        return reply

    def create_accounts(self, rows):
        return self.submit(Op.create_accounts, hz.pack(rows))

    def create_transfers(self, rows):
        return self.submit(Op.create_transfers, hz.pack(rows))

    def transfers(self, filter_bytes):
        return np.frombuffer(self.submit(Op.get_account_transfers, filter_bytes),
                             dtype=types.TRANSFER_DTYPE)

    def balances(self, filter_bytes):
        return np.frombuffer(self.submit(Op.get_account_balances, filter_bytes),
                             dtype=types.ACCOUNT_BALANCE_DTYPE)


@pytest.fixture(params=["host", "device"])
def h(request):
    p = Pair(request.param)
    assert p.create_accounts(
        [hz.account(1, flags=AF.history), hz.account(2), hz.account(3, flags=AF.history)]
    ) == b""
    # 1 -> 2 (x2), 2 -> 1, 1 -> 3
    assert p.create_transfers([
        hz.transfer(100, debit_account_id=1, credit_account_id=2, amount=10),
        hz.transfer(101, debit_account_id=1, credit_account_id=2, amount=20),
        hz.transfer(102, debit_account_id=2, credit_account_id=1, amount=5),
        hz.transfer(103, debit_account_id=1, credit_account_id=3, amount=1),
    ]) == b""
    return p


def tids(rows):
    return [types.u128_get(r, "id") for r in rows]


def test_get_account_transfers_both_sides(h):
    assert tids(h.transfers(account_filter(1))) == [100, 101, 102, 103]


def test_get_account_transfers_debits_only(h):
    assert tids(h.transfers(account_filter(1, flags=FF.debits))) == [100, 101, 103]


def test_get_account_transfers_credits_only(h):
    assert tids(h.transfers(account_filter(1, flags=FF.credits))) == [102]


def test_get_account_transfers_reversed(h):
    rows = h.transfers(account_filter(1, flags=FF.debits | FF.credits | FF.reversed))
    assert tids(rows) == [103, 102, 101, 100]


def test_get_account_transfers_limit(h):
    assert tids(h.transfers(account_filter(1, limit=2))) == [100, 101]


def test_get_account_transfers_timestamp_range(h):
    ts = [int(r["timestamp"]) for r in h.transfers(account_filter(1))]
    rows = h.transfers(account_filter(1, timestamp_min=ts[1], timestamp_max=ts[2]))
    assert tids(rows) == [101, 102]


def test_get_account_transfers_invalid_filters(h):
    invalid = [
        account_filter(0),
        account_filter(types.U128_MAX),
        account_filter(1, timestamp_min=types.U64_MAX),
        account_filter(1, timestamp_max=types.U64_MAX),
        account_filter(1, timestamp_min=5, timestamp_max=4),
        account_filter(1, limit=0),
        account_filter(1, flags=0),
        account_filter(1, flags=1 << 30),
        account_filter(1, reserved=b"\x01" + b"\x00" * 23),
    ]
    for f in invalid:
        assert len(h.transfers(f)) == 0
        assert len(h.balances(f)) == 0


def test_get_account_balances_history(h):
    rows = h.balances(account_filter(1))
    assert [types.u128_get(r, "debits_posted") for r in rows] == [10, 30, 30, 31]
    assert [types.u128_get(r, "credits_posted") for r in rows] == [0, 0, 5, 5]


def test_get_account_balances_non_history_account(h):
    assert len(h.balances(account_filter(2))) == 0


def test_get_account_balances_missing_account(h):
    assert len(h.balances(account_filter(99))) == 0


def test_get_account_balances_other_side_zeroed(h):
    rows = h.balances(account_filter(3))
    assert len(rows) == 1
    assert types.u128_get(rows[0], "credits_posted") == 1
    assert types.u128_get(rows[0], "debits_posted") == 0


def test_lookup_missing_are_omitted(h):
    assert len(h.submit(Op.lookup_accounts, hz.ids_bytes([1, 99, 2]))) == 2 * 128
    assert len(h.submit(Op.lookup_transfers, hz.ids_bytes([100, 999]))) == 128


def test_rollback_does_not_leak_history(h):
    before = h.sm.history_count
    reply = h.create_transfers([
        hz.transfer(200, debit_account_id=1, credit_account_id=2, amount=1, flags=TF.linked),
        hz.transfer(0),
    ])
    results = np.frombuffer(reply, dtype=types.CREATE_RESULT_DTYPE)
    assert [(int(r["index"]), int(r["result"])) for r in results] == [
        (0, types.CreateTransferResult.linked_event_failed),
        (1, types.CreateTransferResult.id_must_not_be_zero),
    ]
    assert h.sm.history_count == before
    assert tids(h.transfers(account_filter(1))) == [100, 101, 102, 103]


def test_introspection_helpers(h):
    assert h.sm.transfer_timestamp(101) == h.ref.transfer_timestamp(101)
    assert h.sm.transfer_timestamp(999) is None
    assert h.sm.account_balances_raw(1) == h.ref.account_balances_raw(1) == (0, 31, 0, 5)
    assert h.sm.account_balances_raw(99) is None
    h.create_transfers([hz.transfer(300, debit_account_id=2, credit_account_id=3,
                                    amount=4, flags=TF.pending)])
    pending = types.TransferPendingStatus.pending
    assert h.sm.pending_status(300) == h.ref.pending_status(300) == pending
    assert h.sm.pending_status(100) is None


# ---------------------------------------------------------------------------
# A longer stream: history accounts, pending -> post | void, chains.


N_ACCOUNTS = 24


def history_stream(seed=7, n_batches=10):
    rng = np.random.default_rng(seed)
    ops = [(Op.create_accounts, hz.pack([
        hz.account(i, flags=AF.history if i % 3 == 0 else 0) for i in range(1, N_ACCOUNTS + 1)
    ]))]
    tid = 1000
    pendings = []
    for k in range(n_batches):
        rows = []
        for _ in range(int(rng.integers(4, 12))):
            a, b = (int(x) for x in rng.choice(np.arange(1, N_ACCOUNTS + 1), 2, replace=False))
            r = rng.random()
            if r < 0.25:
                rows.append(hz.transfer(tid, debit_account_id=a, credit_account_id=b,
                                        amount=int(rng.integers(1, 50)), flags=TF.pending))
                pendings.append(tid)
            elif r < 0.45 and pendings:
                pid = pendings.pop(int(rng.integers(0, len(pendings))))
                flag = TF.post_pending_transfer if rng.random() < 0.6 else TF.void_pending_transfer
                rows.append(hz.transfer(tid, pending_id=pid, flags=flag))
            elif r < 0.6:
                rows.append(hz.transfer(tid, debit_account_id=a, credit_account_id=b,
                                        amount=int(rng.integers(1, 9)), flags=TF.linked))
                tid += 1
                rows.append(hz.transfer(tid, debit_account_id=b, credit_account_id=a,
                                        amount=int(rng.integers(1, 9))))
            else:
                rows.append(hz.transfer(tid, debit_account_id=a, credit_account_id=b,
                                        amount=int(rng.integers(1, 90))))
            tid += 1
        ops.append((Op.create_transfers, hz.pack(rows)))
        if k % 4 == 3:
            ops.append((Op.lookup_accounts, hz.ids_bytes(list(range(1, N_ACCOUNTS + 1)))))
    return ops


def query_ops():
    ops = []
    for acct in (1, 3, 6, 7, 24, 99):
        for flags in (FF.debits | FF.credits, FF.debits, FF.credits,
                      FF.debits | FF.credits | FF.reversed, FF.credits | FF.reversed):
            for limit in (8190, 3):
                f = account_filter(acct, flags=flags, limit=limit)
                ops.append((Op.get_account_transfers, f))
                ops.append((Op.get_account_balances, f))
    return ops


@pytest.mark.parametrize("engine", ["host", "device"])
def test_queries_after_a_history_stream(engine):
    """Every direction, limit and reversal, on history and plain
    accounts: byte-equal to the reference and the oracle."""
    p = Pair(engine)
    h_cpu = ref_hz.SingleNodeHarness(CpuStateMachine())
    for op, body in history_stream() + query_ops():
        assert p.submit(op, body) == h_cpu.submit(op, body)
    # Timestamp windows cut from the account's own history.
    ts = [int(r["timestamp"]) for r in p.transfers(account_filter(6))]
    assert len(ts) >= 3
    for lo, hi in ((ts[0], ts[-1]), (ts[1], ts[1]), (ts[1], 0), (0, ts[-2])):
        f = account_filter(6, timestamp_min=lo, timestamp_max=hi)
        for op in (Op.get_account_transfers, Op.get_account_balances):
            assert p.submit(op, f) == h_cpu.submit(op, f)
    assert p.sm.state_root() == p.ref.state_root()


# ---------------------------------------------------------------------------
# Snapshot -> restore -> continue.


@pytest.mark.parametrize("tiered", [False, True])
@pytest.mark.parametrize("engine", ["host", "device"])
def test_snapshot_restore_continue(monkeypatch, engine, tiered):
    if tiered:
        monkeypatch.setenv("TB_HOT_CAPACITY", "16")
    ops = history_stream(seed=11, n_batches=12) + query_ops()[:8]
    half = len(ops) // 2

    def port():
        return TorchStateMachine(account_capacity=1 << 12, device="cpu", engine=engine)

    def reference():
        return TpuStateMachine(account_capacity=1 << 12, engine=engine)

    whole = port()
    h_whole = hz.SingleNodeHarness(whole)
    replies = [h_whole.submit(op, body) for op, body in ops]

    first, ref_first = port(), reference()
    h, h_ref = hz.SingleNodeHarness(first), ref_hz.SingleNodeHarness(ref_first)
    for op, body in ops[:half]:
        assert h.submit(op, body) == h_ref.submit(op, body)
    blob = first.snapshot()
    assert blob == ref_first.snapshot(), "snapshot blob differs from the reference's"

    restored, ref_restored = port(), reference()
    restored.restore(blob)
    ref_restored.restore(blob)
    if tiered:
        assert restored._dev.hot is not None
    assert restored.snapshot() == blob
    assert restored.state_root() == first.state_root() == ref_restored.state_root()
    restored.verify_device_mirror()
    # The harnesses carry on from the restored clocks.
    h2, h2_ref = hz.SingleNodeHarness(restored), ref_hz.SingleNodeHarness(ref_restored)
    h2.realtime, h2_ref.realtime = h.realtime, h_ref.realtime
    later = [h2.submit(op, body) for op, body in ops[half:]]
    assert later == [h2_ref.submit(op, body) for op, body in ops[half:]]
    assert later == replies[half:]
    assert restored.state_root() == whole.state_root() == ref_restored.state_root()
    restored.verify_device_mirror()
    assert restored.snapshot() == whole.snapshot()


def test_restore_on_a_lost_link_serves_degraded():
    """A restore whose re-upload crosses a dead link demotes the fresh
    engine: the restored mirror serves exactly until re-promotion."""
    from tigerbeetle_tpu_torch.testing.chaos import ChaosLink
    from tigerbeetle_tpu_torch.types import EngineState

    ops = history_stream(seed=3, n_batches=6)
    half = len(ops) // 2
    first = TorchStateMachine(account_capacity=1 << 12, device="cpu", engine="device")
    h = hz.SingleNodeHarness(first)
    for op, body in ops[:half]:
        h.submit(op, body)
    blob = first.snapshot()
    link = ChaosLink()
    restored = TorchStateMachine(account_capacity=1 << 12, device="cpu", engine="device",
                                 device_link=link)
    link.kill()
    restored.restore(blob)
    assert restored._dev.state is EngineState.degraded
    h2 = hz.SingleNodeHarness(restored)
    h2.realtime = h.realtime
    later = [h2.submit(op, body) for op, body in ops[half:]]
    assert later == [h.submit(op, body) for op, body in ops[half:]]
    assert restored.state_root() == first.state_root()
    link.heal()
    assert restored._dev.try_repromote()
    restored.verify_device_mirror()

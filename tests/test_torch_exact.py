"""The exact lane end to end: TorchStateMachine on both engines (here on
the CPU through the kernels' plain versions) against TpuStateMachine
with TB_WAVES=scan and TB_DEV_WAVES=0 (so its JAX exact scan runs on
every host-path batch) and against CpuStateMachine, on the bench's
linked, two_phase and offkernel streams at 400 events per batch, the
order-free streams on the host engine, an expiry stream driven by the
harness's pulses, history accounts and the overflow recovery.  Replies,
state_root, lookup_accounts / lookup_transfers rows, stored pending
statuses, history rows and the live expires index bit for bit."""

import importlib
import os

import numpy as np
import pytest

from tigerbeetle_tpu.state_machine.cpu import CpuStateMachine
from tigerbeetle_tpu.state_machine.tpu import TpuStateMachine
from tigerbeetle_tpu.testing import harness as ref_hz
from tigerbeetle_tpu_torch import workload
from tigerbeetle_tpu_torch.state_machine.gpu import TorchStateMachine
from tigerbeetle_tpu_torch.testing import harness as hz
from tigerbeetle_tpu_torch.types import AccountFlags, Operation, TransferFlags

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TF = TransferFlags
AF = AccountFlags
NS = 1_000_000_000
ACCT_ROWS = 1 << 10  # one table shape for every test: one JAX compile per bucket


@pytest.fixture
def jax_scan(monkeypatch):
    monkeypatch.setenv("TB_WAVES", "scan")
    monkeypatch.setenv("TB_DEV_WAVES", "0")

    def make(account_capacity, transfer_capacity=1 << 16):
        return TpuStateMachine(account_capacity=account_capacity,
                               transfer_capacity=transfer_capacity, engine="host")

    return make


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX scan's run of each bench stream, shared by the stream's
    two engine cases (the reference does not depend on the port's
    engine): {config: (machine, harness, replies)}."""
    return {}


@pytest.fixture
def bench400(monkeypatch):
    """The repository's bench generators at BENCH_BATCH=400."""
    monkeypatch.setenv("BENCH_BATCH", "400")
    monkeypatch.syspath_prepend(REPO)
    import bench

    importlib.reload(bench)
    yield bench
    monkeypatch.delenv("BENCH_BATCH")
    importlib.reload(bench)


def run(sm, ops, harness=hz):
    h = harness.SingleNodeHarness(sm)
    futs = [h.submit_async(op, body) for op, body in ops]
    return h, [f.result() for f in futs]


def live_expiry(sm):
    act = sm._exp.col("active")
    pairs = sorted(zip(sm._exp.col("expires_at")[act].tolist(), sm._exp.col("row")[act].tolist()))
    return pairs, sm.pulse_next_timestamp


def assert_same_state(sm_t, sm_j, h_t, h_j, acct_ids, tids):
    assert sm_t.state_root() == sm_j.state_root()
    ids = [int(i) for i in acct_ids]
    assert h_t.submit(Operation.lookup_accounts, hz.ids_bytes(ids)) == h_j.submit(
        Operation.lookup_accounts, ref_hz.ids_bytes(ids))
    tids = [int(i) for i in tids]
    assert h_t.submit(Operation.lookup_transfers, hz.ids_bytes(tids)) == h_j.submit(
        Operation.lookup_transfers, ref_hz.ids_bytes(tids))
    n = sm_t._store.count
    assert n == sm_j._store.count
    for name in ("status", "timestamp", "dr_slot", "cr_slot", "amount_lo", "amount_hi"):
        np.testing.assert_array_equal(sm_t._store.col(name), sm_j._store.col(name)[:n])
    assert sm_t.history_count == sm_j.history_count
    for name in ("timestamp", "dr_id_lo", "cr_id_lo", "dr_bal", "cr_bal"):
        np.testing.assert_array_equal(sm_t._history.col(name), sm_j._history.col(name))
    assert live_expiry(sm_t) == live_expiry(sm_j)
    assert sm_t.commit_timestamp == sm_j.commit_timestamp
    sm_t.verify_device_mirror()


@pytest.mark.parametrize("engine", ["host", "device"])
@pytest.mark.parametrize("config", ["linked", "two_phase", "offkernel"])
def test_bench_exact_streams_match_jax_and_oracle(config, engine, bench400, jax_scan, jax_runs):
    setup, timed, sizing = getattr(bench400, "gen_" + config)(400)
    ops = setup + timed
    mine = getattr(workload, "gen_" + config)(400, batch=400)
    assert mine[0] + mine[1] == ops and mine[2] == sizing

    # 1024 rows hold every stream's accounts: the JAX scan copies its
    # table per step on the CPU, so the bench's 4096 would cost 4x.
    sm_t = TorchStateMachine(account_capacity=ACCT_ROWS, transfer_capacity=sizing[1],
                             device="cpu", engine=engine)
    h_t, replies_t = run(sm_t, ops)
    if config not in jax_runs:
        sm_j = jax_scan(ACCT_ROWS, sizing[1])
        h_c = ref_hz.SingleNodeHarness(CpuStateMachine())
        replies_c = [h_c.submit(op, body) for op, body in ops]
        jax_runs[config] = (sm_j, *run(sm_j, ops, ref_hz), replies_c)
    sm_j, h_j, replies_j, replies_c = jax_runs[config]
    assert replies_t == replies_j == replies_c
    # The path each case exercises: the host engine runs every such batch
    # through the exact scan; the device engine routes linked batches to
    # K5, post/void batches to K6 and offkernel's shapes (balancing
    # riders, pending-led chains) to the exact scan.  Routing parity with
    # a JAX device machine is test_torch_device_classes.py's.
    if engine == "host" or config == "offkernel":
        assert sm_t.stat_exact_batches > 0
    elif config == "linked":
        assert sm_t.stat_linked_batches > 0
    else:
        assert sm_t.stat_two_phase_batches > 0
    n_acct = 1000
    tids = list(range(1, 400)) + [workload.WARM0 + 5, workload.WARM0 + 1_000_003]
    assert_same_state(sm_t, sm_j, h_t, h_j, range(1, n_acct + 1), tids)


@pytest.mark.parametrize("config", ["simple", "zipf"])
def test_orderfree_streams_on_host_engine(config, jax_scan, monkeypatch):
    """The slice-1 streams on engine="host": mirror admission plus the
    write-behind lane (K4's plain version), no exact batch.  The port
    runs with its default routing (TB_WAVES=scan would send every batch
    to the exact scan, as it does the reference's)."""
    # 256-event batches: the JAX scan's smaller bucket, 8x fewer steps.
    setup, timed, sizing = getattr(workload, "gen_" + config)(1024, batch=256)
    ops = setup + timed
    sm_t = TorchStateMachine(account_capacity=ACCT_ROWS, transfer_capacity=sizing[1],
                             device="cpu", engine="host")
    monkeypatch.delenv("TB_WAVES")
    h_t, replies_t = run(sm_t, ops)
    monkeypatch.setenv("TB_WAVES", "scan")
    sm_j = jax_scan(ACCT_ROWS, sizing[1])
    h_j, replies_j = run(sm_j, ops, ref_hz)
    assert replies_t == replies_j
    assert sm_t.stat_exact_batches == 0 and sm_t.stat_device_events == 1280
    assert_same_state(sm_t, sm_j, h_t, h_j, range(1, 101), range(1, 1025))
    assert sm_t._dev.stat_flushes > 0  # the check's read flushed the queue


def _expiry_stream():
    """Pendings with timeouts of 1-3 s in two batches, a post and a void
    before expiry, then the realtime moves past every expiry (the
    harness injects pulses), a post of an already expired pending, and
    one more pending that a late post finds overdue."""
    acct = [(Operation.create_accounts, hz.pack([hz.account(i) for i in range(1, 9)]))]
    ops, times = list(acct), [None]
    t0 = 10 * NS
    for b in range(2):
        rows = [hz.transfer(100 + 20 * b + k, debit_account_id=1 + k % 8,
                            credit_account_id=1 + (k + 3) % 8, amount=10 + k,
                            timeout=1 + k % 3, flags=int(TF.pending))
                for k in range(20)]
        ops.append((Operation.create_transfers, hz.pack(rows)))
        times.append(t0 + b)
    ops.append((Operation.create_transfers, hz.pack([
        hz.transfer(200, pending_id=100, flags=int(TF.post_pending_transfer)),
        hz.transfer(201, pending_id=121, flags=int(TF.void_pending_transfer)),
    ])))
    times.append(t0 + 2)
    late = t0 + 10 * NS
    ops.append((Operation.create_transfers, hz.pack([
        hz.transfer(202, pending_id=102, flags=int(TF.post_pending_transfer)),
        hz.transfer(300, debit_account_id=2, credit_account_id=3, amount=9,
                    timeout=1, flags=int(TF.pending)),
    ])))
    times.append(late)
    ops.append((Operation.lookup_accounts, hz.ids_bytes(list(range(1, 9)))))
    times.append(late + 1)
    ops.append((Operation.create_transfers, hz.pack([
        hz.transfer(203, pending_id=300, flags=int(TF.post_pending_transfer)),
    ])))
    times.append(late + 5 * NS)
    ops.append((Operation.lookup_accounts, hz.ids_bytes(list(range(1, 9)))))
    times.append(late + 5 * NS + 1)
    return ops, times


@pytest.mark.parametrize("engine", ["host", "device"])
def test_expiry_stream_matches_jax_and_oracle(engine, jax_scan):
    ops, times = _expiry_stream()
    sm_t = TorchStateMachine(account_capacity=ACCT_ROWS, device="cpu", engine=engine)
    h_t = hz.SingleNodeHarness(sm_t)
    got = [h_t.submit(op, body, realtime=rt) for (op, body), rt in zip(ops, times)]
    sm_j = jax_scan(ACCT_ROWS)
    h_j = ref_hz.SingleNodeHarness(sm_j)
    want = [h_j.submit(op, body, realtime=rt) for (op, body), rt in zip(ops, times)]
    h_c = ref_hz.SingleNodeHarness(CpuStateMachine())
    oracle = [h_c.submit(op, body, realtime=rt) for (op, body), rt in zip(ops, times)]
    assert got == want == oracle
    # Expired pendings released every pending balance but the posted
    # one's (posted) and the voided one's.
    rows = np.frombuffer(got[-1], hz.ACCOUNT_DTYPE)
    assert (rows["debits_pending_lo"] == 0).all() and (rows["credits_pending_lo"] == 0).all()
    statuses = sm_t._store.col("status")
    assert (statuses == 4).sum() >= 30  # expired
    assert_same_state(sm_t, sm_j, h_t, h_j, range(1, 9), [100, 121, 200, 201, 202, 203, 300])


@pytest.mark.parametrize("engine", ["host", "device"])
def test_history_accounts_match_jax(engine, jax_scan):
    """Transfers touching history accounts run the scan, whose row
    snapshots become the history rows."""
    ops = [(Operation.create_accounts, hz.pack(
        [hz.account(i, flags=int(AF.history) if i % 2 else 0) for i in range(1, 7)]))]
    rng = np.random.default_rng(3)
    tid = 10
    for _ in range(3):
        rows = []
        for _k in range(30):
            dr = int(rng.integers(1, 7))
            rows.append(hz.transfer(tid, debit_account_id=dr, credit_account_id=dr % 6 + 1,
                                    amount=int(rng.integers(1, 50)),
                                    flags=int(TF.pending) if tid % 4 == 0 else 0))
            tid += 1
        ops.append((Operation.create_transfers, hz.pack(rows)))
    sm_t = TorchStateMachine(account_capacity=ACCT_ROWS, device="cpu", engine=engine)
    h_t, got = run(sm_t, ops)
    sm_j = jax_scan(ACCT_ROWS)
    h_j, want = run(sm_j, ops, ref_hz)
    assert got == want
    assert sm_t.history_count == sm_j.history_count > 0
    assert_same_state(sm_t, sm_j, h_t, h_j, range(1, 7), range(10, tid))


def test_overflow_recovery_on_host_engine(jax_scan, monkeypatch):
    """Host engine: the mirror's admission refuses the ~2^127 pair, so
    the batch runs the scan, which ranks the overflow codes (the port
    with its default wave routing and without its native library, whose
    serial exact engine would take the batch instead: the wave admission
    refuses the pair too)."""
    monkeypatch.setenv("TB_FASTPATH_DISABLE", "1")
    big = (1 << 127) + 5
    ops = [(Operation.create_accounts, hz.pack([hz.account(i) for i in (1, 2, 3)]))]
    ops.append((Operation.create_transfers, hz.pack([
        hz.transfer(10, debit_account_id=1, credit_account_id=2, amount=big),
        hz.transfer(11, debit_account_id=1, credit_account_id=3, amount=big),
    ])))
    ops.append((Operation.create_transfers, hz.pack(
        [hz.transfer(12, debit_account_id=1, credit_account_id=3, amount=7)])))
    sm_t = TorchStateMachine(account_capacity=ACCT_ROWS, device="cpu", engine="host")
    monkeypatch.delenv("TB_WAVES")
    h_t, got = run(sm_t, ops)
    monkeypatch.setenv("TB_WAVES", "scan")
    sm_j = jax_scan(ACCT_ROWS)
    h_j, want = run(sm_j, ops, ref_hz)
    assert got == want and got[1] != b""
    assert sm_t.stat_exact_batches == 1
    assert_same_state(sm_t, sm_j, h_t, h_j, (1, 2, 3), (10, 11, 12))


def test_overflow_ranked_by_native_exact_engine(monkeypatch):
    """The same stream with the native library on both sides (the
    reference's default host routing): the order-free lane refuses the
    ~2^127 pair, and the native linked resolver (which ranks the overflow
    codes in its serial walk) takes the batch; nothing reaches K3."""
    monkeypatch.delenv("TB_FASTPATH_DISABLE", raising=False)
    monkeypatch.delenv("TB_WAVES", raising=False)
    big = (1 << 127) + 5
    ops = [(Operation.create_accounts, hz.pack([hz.account(i) for i in (1, 2, 3)]))]
    ops.append((Operation.create_transfers, hz.pack([
        hz.transfer(10, debit_account_id=1, credit_account_id=2, amount=big),
        hz.transfer(11, debit_account_id=1, credit_account_id=3, amount=big),
    ])))
    ops.append((Operation.create_transfers, hz.pack(
        [hz.transfer(12, debit_account_id=1, credit_account_id=3, amount=7)])))
    sm_t = TorchStateMachine(account_capacity=ACCT_ROWS, device="cpu", engine="host")
    sm_j = TpuStateMachine(account_capacity=ACCT_ROWS, engine="host")
    assert sm_t._native is not None and sm_j._native is not None
    h_t, got = run(sm_t, ops)
    h_j, want = run(sm_j, ops, ref_hz)
    assert got == want and got[1] != b""
    assert sm_t.stat_exact_batches == 0 and sm_t.stat_linked_batches == 1
    for stat in ("stat_linked_batches", "stat_exact_events", "stat_device_events",
                 "stat_slow_tail_batches", "stat_hot_tail_batches"):
        assert getattr(sm_t, stat) == getattr(sm_j, stat), stat
    assert_same_state(sm_t, sm_j, h_t, h_j, (1, 2, 3), (10, 11, 12))
    sm_t.verify_device_mirror()


def test_engine_knob(monkeypatch):
    """TB_ENGINE picks the engine (default host) and is validated."""
    from tigerbeetle_tpu_torch import envcheck
    from tigerbeetle_tpu_torch.state_machine.device_engine import DeviceEngine
    from tigerbeetle_tpu_torch.state_machine.kernel_fast import DeviceTable

    assert isinstance(TorchStateMachine(device="cpu")._dev, DeviceTable)
    monkeypatch.setenv("TB_ENGINE", "device")
    assert isinstance(TorchStateMachine(device="cpu")._dev, DeviceEngine)
    monkeypatch.setenv("TB_ENGINE", "gpu")
    with pytest.raises(envcheck.EnvVarError, match="TB_ENGINE"):
        TorchStateMachine(device="cpu")

"""The device engine's linked-chain (K5) and two-phase (K6) classes end to
end: TorchStateMachine(device="cpu", engine="device"), here on the
kernels' plain versions, against TpuStateMachine(engine="device") (with
TB_WAVES=scan and TB_DEV_WAVES=0, so no wave dispatch and the JAX scan
on the host path) and CpuStateMachine.  The reference's device-engine
cases (tests/test_device_engine.py: the linked precondition fallback,
the multi-iteration fixpoint, the cross-batch pending-reference and
pipelined double-finalize hazards, cross-batch durable targets) and the
bench's linked and two_phase streams at 400 events per batch.  Replies
and state_root bit for bit; routing parity: the batches each kernel
took, the fixpoint iterations, the exact-path and fallback events equal
the JAX machine's (the reference counts exact events, not batches)."""

import importlib
import os

import numpy as np
import pytest

from tigerbeetle_tpu.state_machine import device_engine as ref_de
from tigerbeetle_tpu.state_machine.cpu import CpuStateMachine
from tigerbeetle_tpu.state_machine.tpu import TpuStateMachine
from tigerbeetle_tpu.testing import harness as ref_hz
from tigerbeetle_tpu_torch import workload
from tigerbeetle_tpu_torch.state_machine import device_engine as de
from tigerbeetle_tpu_torch.state_machine.gpu import TorchStateMachine
from tigerbeetle_tpu_torch.testing import harness as hz
from tigerbeetle_tpu_torch.types import (
    CREATE_RESULT_DTYPE,
    AccountFlags,
    CreateTransferResult,
    Operation,
    TransferFlags,
)
from torch_link_quiet import link_quiet  # noqa: F401  (autouse: no engine lost its link)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AF = AccountFlags
TF = TransferFlags
CTR = CreateTransferResult
ROWS = 1 << 10  # one table shape for every case: one JAX compile per kernel
ROUTING = (
    "stat_linked_batches", "stat_two_phase_batches", "stat_resolve_iters",
    "stat_exact_events", "stat_fallback_events",
)


@pytest.fixture
def jax_device(monkeypatch):
    monkeypatch.setenv("TB_WAVES", "scan")
    monkeypatch.setenv("TB_DEV_WAVES", "0")

    def make(transfer_capacity=1 << 16):
        return TpuStateMachine(account_capacity=ROWS, transfer_capacity=transfer_capacity,
                               engine="device")

    return make


def accounts(ids, flags=0, ledger=1):
    return hz.pack([hz.account(i, flags=flags, ledger=ledger) for i in ids])


def transfers(rows):
    return hz.pack([hz.transfer(**r) for r in rows])


def replay(sm, ops, harness=hz):
    h = harness.SingleNodeHarness(sm)
    futs = [h.submit_async(op, body) for op, body in ops]
    return [f.result() for f in futs]


def run_three(ops, jax_device, transfer_capacity=1 << 16):
    """Replies of the port, the JAX device machine and the oracle, all
    equal; the port's root, routing counters and device mirror checked.
    Returns (port machine, replies)."""
    sm_t = TorchStateMachine(account_capacity=ROWS, transfer_capacity=transfer_capacity,
                             device="cpu", engine="device")
    got = replay(sm_t, ops)
    sm_j = jax_device(transfer_capacity)
    want = replay(sm_j, ops, ref_hz)
    h_c = ref_hz.SingleNodeHarness(CpuStateMachine())
    assert got == want == [h_c.submit(op, body) for op, body in ops]
    assert sm_t.state_root() == sm_j.state_root()
    for stat in ROUTING:
        assert getattr(sm_t, stat) == getattr(sm_j, stat), stat
    sm_t.verify_device_mirror()
    return sm_t, got


def test_linked_precondition_fallback(jax_device):
    """A limit account with a 2^62 balance breaks K5's u64-safety
    precondition: the device flags the batch, the host decides."""
    huge = 1 << 62
    ops = [(Operation.create_accounts,
            accounts([1], flags=int(AF.debits_must_not_exceed_credits)) + accounts([2, 3]))]
    ops.append((Operation.create_transfers, transfers(
        [dict(id=5, debit_account_id=2, credit_account_id=1, amount=huge)])))
    ops.append((Operation.create_transfers, transfers([
        dict(id=10, debit_account_id=1, credit_account_id=2, amount=10, flags=int(TF.linked)),
        dict(id=11, debit_account_id=1, credit_account_id=3, amount=20),
    ])))
    ops.append((Operation.lookup_accounts, hz.ids_bytes([1, 2, 3])))
    sm, _ = run_three(ops, jax_device)
    assert sm.stat_fallback_events == 2 and sm.stat_linked_batches == 0
    assert sm._dev.stat_fallback_batches == 1


@pytest.mark.parametrize("n_chains", [40, 12])
def test_linked_fixpoint_multi_iteration(n_chains, jax_device):
    """Interleaved chains contending on limited accounts force the
    Jacobi fixpoint past one iteration; verdicts stay exact.  The
    reference's 40 chains fail more events than the summary holds, so
    K5's batch is re-executed exactly (as on the JAX engine); 12 chains
    stay on K5."""
    rng = np.random.default_rng(7)
    n_acct = 6
    ops = [(Operation.create_accounts,
            accounts(range(1, n_acct + 1), flags=int(AF.debits_must_not_exceed_credits))
            + accounts([99]))]
    ops.append((Operation.create_transfers, transfers(
        [dict(id=100 + i, debit_account_id=99, credit_account_id=i + 1, amount=30)
         for i in range(n_acct)])))
    rows = []
    tid = 200
    for _chain in range(n_chains):
        ln = int(rng.integers(1, 5))
        for j in range(ln):
            dr = int(rng.integers(1, n_acct + 1))
            cr = int(rng.integers(1, n_acct + 1))
            if cr == dr:
                cr = dr % n_acct + 1
            rows.append(dict(id=tid, debit_account_id=dr, credit_account_id=cr,
                             amount=int(rng.integers(1, 25)),
                             flags=int(TF.linked) if j < ln - 1 else 0))
            tid += 1
    ops.append((Operation.create_transfers, transfers(rows)))
    ops.append((Operation.lookup_accounts, hz.ids_bytes(list(range(1, n_acct + 1)))))
    sm, _ = run_three(ops, jax_device)
    if n_chains == 40:
        assert sm._dev.stat_fallback_batches == 1 and sm.stat_fallback_events == len(rows)
    else:
        assert sm.stat_linked_batches == 1 and sm.stat_resolve_iters > 1


def test_cross_batch_pending_reference_hazard(jax_device):
    """A post in batch k+1 referencing a pending created in batch k
    (still in flight) drains and resolves exactly."""
    ops = [(Operation.create_accounts, accounts([1, 2]))]
    ops.append((Operation.create_transfers, transfers([
        dict(id=10, debit_account_id=1, credit_account_id=2, amount=50, flags=int(TF.pending))])))
    ops.append((Operation.create_transfers, transfers([
        dict(id=11, pending_id=10, flags=int(TF.post_pending_transfer)),
        dict(id=12, pending_id=10, flags=int(TF.post_pending_transfer)),
    ])))
    ops.append((Operation.lookup_accounts, hz.ids_bytes([1, 2])))
    sm, _ = run_three(ops, jax_device)
    assert sm.stat_two_phase_batches == 1


def test_pipelined_double_finalize_same_pending(jax_device, monkeypatch):
    """Two pipelined one-event batches posting the SAME durable pending:
    the second drains on the first's recorded pending-reference key and
    fails with already_posted (window of 64 on both engines)."""
    monkeypatch.setattr(de, "_WINDOW", 64)
    monkeypatch.setattr(ref_de, "_WINDOW", 64)
    ops = [(Operation.create_accounts, accounts([1, 2]))]
    ops.append((Operation.create_transfers, transfers([
        dict(id=10, debit_account_id=1, credit_account_id=2, amount=50, flags=int(TF.pending)),
        dict(id=11, debit_account_id=1, credit_account_id=2, amount=500, flags=int(TF.pending)),
    ])))
    ops += [
        (Operation.create_transfers, transfers(
            [dict(id=30, pending_id=10, flags=int(TF.post_pending_transfer))])),
        (Operation.create_transfers, transfers(
            [dict(id=31, pending_id=10, flags=int(TF.post_pending_transfer))])),
        (Operation.lookup_accounts, hz.ids_bytes([1, 2])),
    ]
    sm, got = run_three(ops, jax_device)
    res = np.frombuffer(got[-2], dtype=CREATE_RESULT_DTYPE)
    assert len(res) == 1 and res[0]["result"] == int(CTR.pending_transfer_already_posted)
    assert sm.stat_two_phase_batches == 2


def test_two_phase_cross_batch_durable_targets(jax_device):
    """Pendings land durably, then posts/voids reference them from a
    later batch, double-finalize races and a missing target included."""
    ops = [(Operation.create_accounts, accounts([1, 2, 3]))]
    ops.append((Operation.create_transfers, transfers([
        dict(id=10 + i, debit_account_id=1, credit_account_id=2, amount=10 + i,
             flags=int(TF.pending)) for i in range(6)])))
    ops.append((Operation.create_transfers, transfers([
        dict(id=30, pending_id=10, flags=int(TF.post_pending_transfer)),
        dict(id=31, pending_id=11, flags=int(TF.void_pending_transfer)),
        dict(id=32, pending_id=10, flags=int(TF.void_pending_transfer)),
        dict(id=33, pending_id=12, flags=int(TF.post_pending_transfer), amount=5),
        dict(id=34, pending_id=99, flags=int(TF.post_pending_transfer)),
    ])))
    ops.append((Operation.lookup_accounts, hz.ids_bytes([1, 2])))
    ops.append((Operation.lookup_transfers, hz.ids_bytes([30, 31, 32, 33, 34])))
    sm, _ = run_three(ops, jax_device)
    assert sm.stat_two_phase_batches == 1 and sm.stat_exact_events == 0


def test_semantic_batches_counted_by_kind(jax_device):
    """The device engine counts the batches its router sends each kernel
    (stat_semantic_batches, by record kind): order-free batches to K1, a
    chain batch to K5, a post batch to K6.  No batch takes a host lane
    here, so the linked and two-phase counters equal K5's and K6's."""
    ops = [(Operation.create_accounts, accounts([1, 2, 3]))]
    ops.append((Operation.create_transfers, transfers([
        dict(id=10, debit_account_id=1, credit_account_id=2, amount=7),
        dict(id=11, debit_account_id=2, credit_account_id=3, amount=5)])))
    ops.append((Operation.create_transfers, transfers([
        dict(id=20, debit_account_id=1, credit_account_id=2, amount=3, flags=int(TF.linked)),
        dict(id=21, debit_account_id=2, credit_account_id=3, amount=2)])))
    ops.append((Operation.create_transfers, transfers([
        dict(id=30, debit_account_id=1, credit_account_id=3, amount=9, flags=int(TF.pending))])))
    ops.append((Operation.create_transfers, transfers([
        dict(id=31, pending_id=30, flags=int(TF.post_pending_transfer))])))
    ops.append((Operation.lookup_accounts, hz.ids_bytes([1, 2, 3])))
    sm, _ = run_three(ops, jax_device)
    kinds = sm._dev.stat_semantic_batches
    assert kinds["linked"] + kinds["linked_small"] == sm.stat_linked_batches == 1
    assert kinds["two_phase"] + kinds["two_phase_lo"] == sm.stat_two_phase_batches == 1
    assert sum(n for kind, n in kinds.items() if kind.startswith("orderfree")) == 2
    assert sm.stat_fallback_events == 0


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


@pytest.mark.parametrize("config", ["linked", "two_phase"])
def test_bench_stream_routes_as_jax(config, bench400, jax_device):
    """Bench's linked and two_phase streams at 400 events per batch: the
    port's copy of the generator gives bench's bytes, every timed batch
    rides its kernel as on the JAX device engine."""
    setup, timed, sizing = getattr(bench400, "gen_" + config)(400)
    ops = setup + timed
    mine = getattr(workload, "gen_" + config)(400, batch=400)
    assert mine[0] + mine[1] == ops and mine[2] == sizing
    sm, _ = run_three(ops, jax_device, transfer_capacity=sizing[1])
    routed = sm.stat_linked_batches if config == "linked" else sm.stat_two_phase_batches
    assert routed > 0 and sm.stat_fallback_events == 0

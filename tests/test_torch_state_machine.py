"""TorchStateMachine (the port's device-authoritative engine, here on
the CPU through the kernels' plain versions) against TpuStateMachine
and CpuStateMachine: replies and state_root bit for bit on the bench
streams, exact recovery, the tight/wide input formats, and the classes
outside K1's: linked and post/void batches (K5 and K6) and duplicate or
existing ids and a flagged batch whose re-execution must rank overflow
codes (the exact scan), against TpuStateMachine with TB_WAVES=scan and
TB_DEV_WAVES=0, so the JAX scan runs there too."""

import importlib
import os
import sys

import numpy as np
import pytest
import torch

from tigerbeetle_tpu.state_machine.cpu import CpuStateMachine
from tigerbeetle_tpu.state_machine.tpu import TpuStateMachine
from tigerbeetle_tpu.testing import harness as ref_hz
from tigerbeetle_tpu_torch import workload
from tigerbeetle_tpu_torch.state_machine import device_engine as de
from tigerbeetle_tpu_torch.state_machine import gpu
from tigerbeetle_tpu_torch.state_machine.gpu import TorchStateMachine
from tigerbeetle_tpu_torch.testing import harness as hz
from tigerbeetle_tpu_torch.types import AccountFlags, Operation, TransferFlags
from torch_link_quiet import link_quiet  # noqa: F401  (autouse: no engine lost its link)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TF = TransferFlags
AF = AccountFlags


def torch_sm(account_capacity=1 << 12, transfer_capacity=1 << 16):
    return TorchStateMachine(
        account_capacity=account_capacity, transfer_capacity=transfer_capacity,
        device="cpu", engine="device",
    )


def pin_scan(monkeypatch):
    """Scan routing for both machines: no wave dispatch in the window,
    the whole exact scan on every host-path batch."""
    monkeypatch.setenv("TB_WAVES", "scan")
    monkeypatch.setenv("TB_DEV_WAVES", "0")


def jax_scan_sm(monkeypatch, account_capacity=1 << 12):
    """The reference with its JAX exact scan on every host-path batch."""
    pin_scan(monkeypatch)
    return TpuStateMachine(account_capacity=account_capacity, engine="device")


def replay(sm, ops, harness=hz):
    h = harness.SingleNodeHarness(sm)
    futs = [h.submit_async(op, body) for op, body in ops]
    return [f.result() for f in futs]


def oracle(ops):
    h = ref_hz.SingleNodeHarness(CpuStateMachine())
    return [h.submit(op, body) for op, body in ops]


def accounts(ids, flags=0, ledger=1):
    return hz.pack([hz.account(i, flags=flags, ledger=ledger) for i in ids])


def transfers(rows):
    return hz.pack([hz.transfer(**r) for r in rows])


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


@pytest.mark.parametrize("config", ["simple", "zipf"])
def test_bench_stream_matches_jax_and_oracle(config, bench400):
    """The port's copy of the generator yields bench's exact bytes, and
    the three machines agree on every reply and on state_root."""
    setup, timed, sizing = bench400.CONFIGS[config](4000)
    ops = setup + timed
    mine = getattr(workload, "gen_" + config)(4000, batch=400)
    assert mine[0] + mine[1] == ops and mine[2] == sizing

    sm_t = torch_sm(*sizing)
    replies_t = replay(sm_t, ops)
    sm_d = TpuStateMachine(account_capacity=sizing[0], transfer_capacity=sizing[1],
                           engine="device")
    replies_d = replay(sm_d, ops, ref_hz)
    h_c = ref_hz.SingleNodeHarness(CpuStateMachine())
    replies_c = [h_c.submit(op, body) for op, body in ops]
    assert replies_t == replies_d == replies_c
    assert sm_t.state_root() == sm_d.state_root()
    assert sm_t.stat_device_semantic_events == 4400  # timed + warmup, all on K1
    assert sm_t.stat_fallback_events == 0
    sm_t.verify_device_mirror()
    # Final wire state: every account row and a transfer sample.
    acct_ids = bench400.config_account_ids(config)
    tids = np.arange(bench400.TID0, bench400.TID0 + 2000).astype(np.uint64)
    h_t = hz.SingleNodeHarness(sm_t)
    assert bench400.state_digest(h_t, acct_ids, tids) == bench400.state_digest(
        h_c, acct_ids, tids
    )


def test_fallback_cap_exceeded():
    """More failures than the summary holds: the batch is re-executed on
    the host with its full failure list, bit-identical to the oracle."""
    ops = [(Operation.create_accounts, accounts([1, 2]))]
    rows = [dict(id=100 + i, debit_account_id=1, credit_account_id=1, amount=1)
            for i in range(100)]  # accounts_must_be_different x 100 > cap 60
    ops.append((Operation.create_transfers, transfers(rows)))
    ops.append((Operation.create_transfers, transfers(
        [dict(id=300, debit_account_id=1, credit_account_id=2, amount=5)])))
    ops.append((Operation.lookup_accounts, hz.ids_bytes([1, 2])))
    sm = torch_sm()
    got = replay(sm, ops)
    assert got == oracle(ops)
    assert sm._dev.stat_fallback_batches >= 1 and sm.stat_fallback_events == 100
    sm.verify_device_mirror()


def test_fallback_recovery_redispatches_inflight(monkeypatch):
    """Batches after a flagged one in the same window are launched again
    against the table re-uploaded from the mirror."""
    monkeypatch.setattr(de, "_WINDOW", 64)
    ops = [(Operation.create_accounts, accounts([1, 2, 3]))]
    bad = [dict(id=10 + i, debit_account_id=1, credit_account_id=1, amount=1)
           for i in range(70)]
    ops.append((Operation.create_transfers, transfers(bad)))
    for k in range(4):
        ops.append((Operation.create_transfers, transfers(
            [dict(id=200 + k, debit_account_id=1, credit_account_id=3, amount=3 + k)])))
        ops.append((Operation.lookup_accounts, hz.ids_bytes([1, 3])))
    sm = torch_sm()
    assert replay(sm, ops) == oracle(ops)
    assert sm._dev.stat_fallback_batches == 1
    assert sm.stat_device_semantic_events == 4
    sm.verify_device_mirror()


def test_tight_and_wide_inputs_agree(monkeypatch):
    """The tight (B, 5) u32 input and the wide u64 input give identical
    replies and final state: the tight path is an encoding."""

    def stream():
        rng = np.random.default_rng(11)
        ops = [(Operation.create_accounts, accounts(range(1, 40)))]
        tid = 100
        for _ in range(3):
            rows = []
            for _k in range(50):
                dr = int(rng.integers(1, 40))
                rows.append(hz.transfer(tid, debit_account_id=dr,
                                        credit_account_id=dr % 39 + 1,
                                        amount=int(rng.integers(1, 90))))
                tid += 1
            ops.append((Operation.create_transfers, hz.pack(rows)))
        ops.append((Operation.lookup_accounts, hz.ids_bytes(range(1, 40))))
        return ops

    def run():
        sm = torch_sm(1 << 10)
        h = hz.SingleNodeHarness(sm)
        return [h.submit(op, body) for op, body in stream()], sm

    kinds = []
    real_submit = de.DeviceEngine.submit

    def spy(self, kind, *args, **kw):
        kinds.append(kind)
        return real_submit(self, kind, *args, **kw)

    monkeypatch.setattr(de.DeviceEngine, "submit", spy)
    replies_tight, sm_t = run()
    monkeypatch.setattr(gpu, "_TIGHT_AMOUNT_LIMIT", 0)
    replies_wide, sm_w = run()
    assert kinds == ["orderfree_tight"] * 3 + ["orderfree_lo"] * 3
    assert replies_tight == replies_wide
    assert sm_t.state_root() == sm_w.state_root()


def test_wide_amounts_match_jax():
    """u64 and u128 amounts (orderfree_lo / orderfree kinds) against the
    JAX device engine and the oracle."""
    ops = [(Operation.create_accounts, accounts(range(1, 9)))]
    ops.append((Operation.create_transfers, transfers(
        [dict(id=10 + i, debit_account_id=1 + i % 8, credit_account_id=1 + (i + 3) % 8,
              amount=(1 << 40) + i) for i in range(30)])))
    ops.append((Operation.create_transfers, transfers(
        [dict(id=100 + i, debit_account_id=1 + i % 8, credit_account_id=1 + (i + 1) % 8,
              amount=(7 << 70) + i, flags=int(TF.pending) if i % 3 else 0)
         for i in range(30)])))
    ops.append((Operation.lookup_accounts, hz.ids_bytes(range(1, 9))))
    sm_t = torch_sm()
    sm_d = TpuStateMachine(engine="device", account_capacity=1 << 12)
    got = replay(sm_t, ops)
    assert got == replay(sm_d, ops, ref_hz)
    assert got == oracle(ops)
    assert sm_t.state_root() == sm_d.state_root()


@pytest.mark.parametrize("case", ["linked", "post_void", "duplicate_ids", "exists"])
def test_residual_classes_raise(case, monkeypatch):
    """The classes slice 1 refused now raise nothing and are routed as
    the JAX device engine routes them: a linked batch to K5, a post/void
    batch to K6 (the counters equal the JAX machine's, and no exact
    batch runs), duplicate or existing ids to the exact host path
    (drain, then K3).  Replies and root equal the JAX machine's and the
    oracle's."""
    setup = [(Operation.create_accounts, accounts([1, 2, 3]))]
    t = dict(debit_account_id=1, credit_account_id=2, amount=5)
    if case == "linked":
        batch = transfers([dict(t, id=10, flags=int(TF.linked)), dict(t, id=11)])
    elif case == "post_void":
        setup.append((Operation.create_transfers,
                      transfers([dict(t, id=10, flags=int(TF.pending))])))
        batch = transfers([dict(id=11, pending_id=10, flags=int(TF.post_pending_transfer))])
    elif case == "duplicate_ids":
        batch = transfers([dict(t, id=10), dict(t, id=10)])
    else:
        setup.append((Operation.create_transfers, transfers([dict(t, id=10)])))
        batch = transfers([dict(t, id=10)])
    ops = setup + [(Operation.create_transfers, batch),
                   (Operation.lookup_accounts, hz.ids_bytes([1, 2, 3])),
                   (Operation.lookup_transfers, hz.ids_bytes([10, 11]))]
    pin_scan(monkeypatch)
    sm = torch_sm()
    got = replay(sm, ops)
    sm_j = jax_scan_sm(monkeypatch)
    assert got == replay(sm_j, ops, ref_hz) == oracle(ops)
    assert sm.state_root() == sm_j.state_root()
    routed = {"linked": "stat_linked_batches", "post_void": "stat_two_phase_batches"}
    for stat in ("stat_linked_batches", "stat_two_phase_batches", "stat_exact_events"):
        assert getattr(sm, stat) == getattr(sm_j, stat), stat
    if case in routed:
        assert getattr(sm, routed[case]) == 1 and sm.stat_exact_batches == 0
    else:
        assert sm.stat_exact_batches == 1
    sm.verify_device_mirror()


def test_inflight_duplicate_drains_then_raises(monkeypatch):
    """A batch reusing the id of a batch still in flight drains the
    window first (hazard probe), then sees the id as existing: the exact
    scan answers `exists`, as the JAX scan and the oracle do."""
    pin_scan(monkeypatch)
    sm = torch_sm()
    h = hz.SingleNodeHarness(sm)
    h.submit(Operation.create_accounts, accounts([1, 2]))
    t = dict(debit_account_id=1, credit_account_id=2, amount=5)
    first = h.submit_async(Operation.create_transfers, transfers([dict(t, id=10), dict(t, id=11)]))
    assert sm._dev.has_inflight()
    second = h.submit_async(Operation.create_transfers, transfers([dict(t, id=11)]))
    assert first.done() and first.result() == b""
    ops = [(Operation.create_accounts, accounts([1, 2])),
           (Operation.create_transfers, transfers([dict(t, id=10), dict(t, id=11)])),
           (Operation.create_transfers, transfers([dict(t, id=11)]))]
    assert [b"", b"", second.result()] == replay(jax_scan_sm(monkeypatch), ops, ref_hz)
    assert second.result() == oracle(ops)[2] != b""
    assert sm.stat_exact_batches == 1


def test_overflow_admission_raises_after_device_flag(monkeypatch):
    """The reference's test_fallback_overflow_orderfree: K1 flags the
    batch (two ~2^127 debits on one account), and its exact
    re-execution ranks the overflow codes through K3 while the mirror
    holds the truth; a later clean batch is exact after the recovery.
    The port runs without its native library, whose serial exact engine
    would take the re-execution instead of K3."""
    monkeypatch.setenv("TB_FASTPATH_DISABLE", "1")
    big = (1 << 127) + 5
    ops = [(Operation.create_accounts, accounts([1, 2, 3]))]
    ops.append((Operation.create_transfers, transfers([
        dict(id=10, debit_account_id=1, credit_account_id=2, amount=big),
        dict(id=11, debit_account_id=1, credit_account_id=3, amount=big),
    ])))
    ops.append((Operation.create_transfers, transfers(
        [dict(id=12, debit_account_id=1, credit_account_id=3, amount=7)])))
    ops.append((Operation.lookup_accounts, hz.ids_bytes([1, 2, 3])))
    sm = torch_sm()
    got = replay(sm, ops)
    assert got == replay(jax_scan_sm(monkeypatch), ops, ref_hz) == oracle(ops)
    assert np.frombuffer(got[1], "<u4")[1::2].tolist() == [int(gpu.CTR.overflows_debits_posted)]
    assert sm._dev.stat_fallback_batches == 1 and sm.stat_exact_batches == 1
    sm.verify_device_mirror()


def test_numpy_tables_round_trip_from_jax_layout():
    """from_numpy_tables / to_numpy_tables move the JAX package's numpy
    layout ((A, 8) u64, (A, 2) u32) bit for bit, and the device digest
    rebuilt from it equals the reference's."""
    import jax.numpy as jnp

    from tigerbeetle_tpu.state_machine import commitment as ref_cm

    rng = np.random.default_rng(4)
    sm = torch_sm(1 << 10)
    bal = rng.integers(0, 1 << 63, (1 << 10, 8), dtype=np.uint64) << np.uint64(1)
    meta = rng.integers(0, 1 << 32, (1 << 10, 2), dtype=np.uint64).astype(np.uint32)
    sm._dev.from_numpy_tables(bal, meta)
    b2, m2, rh, dg = sm._dev.to_numpy_tables()
    assert np.array_equal(b2, bal) and np.array_equal(m2, meta)
    jrh, jdg = ref_cm.device_fns()["rebuild"](
        jnp.asarray(bal), jnp.asarray(meta), jnp.arange(1 << 10, dtype=jnp.uint64)
    )
    assert np.array_equal(rh, np.asarray(jrh)) and np.array_equal(dg, np.asarray(jdg))
    sm._dev.from_numpy_tables(bal, meta, row_hash_u64=rh, digest_u64=dg)
    assert np.array_equal(sm._dev.to_numpy_tables()[3], dg)


def test_state_commit_off_matches_jax(monkeypatch):
    """TB_STATE_COMMIT=0: no digest machinery on either side; the root is
    computed from scratch and the device tables are compared whole."""
    monkeypatch.setenv("TB_STATE_COMMIT", "0")
    setup, timed, sizing = workload.gen_simple(1200, batch=400)
    ops = setup + timed
    sm_t = torch_sm(*sizing)
    sm_d = TpuStateMachine(account_capacity=sizing[0], transfer_capacity=sizing[1],
                           engine="device")
    assert replay(sm_t, ops) == replay(sm_d, ops, ref_hz)
    assert sm_t._dev.dev_digest is None
    assert sm_t.state_root() == sm_d.state_root()
    sm_t.verify_device_mirror()


def test_no_cuda_raises(monkeypatch):
    """TorchStateMachine() runs on the card; without one it raises rather
    than carrying on with the plain versions on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchStateMachine()
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchStateMachine(device="cuda")


NATIVE_ROUTING = ("stat_linked_batches", "stat_two_phase_batches", "stat_exact_events",
                  "stat_device_events", "stat_hot_tail_batches", "stat_slow_tail_batches",
                  "stat_fallback_events", "stat_host_semantic_events")


def _native_pair(monkeypatch, engine, rows):
    """The port and the reference with their native libraries and the
    default routing; the capacity does not divide by 8, so neither
    shards."""
    monkeypatch.delenv("TB_FASTPATH_DISABLE", raising=False)
    monkeypatch.delenv("TB_WAVES", raising=False)
    sm_t = TorchStateMachine(account_capacity=rows, device="cpu", engine=engine)
    sm_j = TpuStateMachine(account_capacity=rows, engine=engine)
    assert sm_t._native is not None and sm_j._native is not None
    return sm_t, sm_j


def _native_equal(sm_t, sm_j):
    assert sm_t.state_root() == sm_j.state_root()
    for stat in NATIVE_ROUTING:
        assert getattr(sm_t, stat) == getattr(sm_j, stat), stat
    sm_t.verify_device_mirror()


def test_overflow_recovery_native_lanes(monkeypatch):
    """The device-flag overflow stream with the native libraries on both
    sides: the exact re-execution of the flagged batch reaches the host
    path's native lanes (which rank the overflow codes) on both machines,
    and K3 never runs."""
    big = (1 << 127) + 5
    ops = [(Operation.create_accounts, accounts([1, 2, 3]))]
    ops.append((Operation.create_transfers, transfers([
        dict(id=10, debit_account_id=1, credit_account_id=2, amount=big),
        dict(id=11, debit_account_id=1, credit_account_id=3, amount=big),
    ])))
    ops.append((Operation.create_transfers, transfers(
        [dict(id=12, debit_account_id=1, credit_account_id=3, amount=7)])))
    ops.append((Operation.lookup_accounts, hz.ids_bytes([1, 2, 3])))
    sm_t, sm_j = _native_pair(monkeypatch, "device", (1 << 12) + 3)
    got = replay(sm_t, ops)
    assert got == replay(sm_j, ops, ref_hz) == oracle(ops)
    assert np.frombuffer(got[1], "<u4")[1::2].tolist() == [int(gpu.CTR.overflows_debits_posted)]
    assert sm_t._dev.stat_fallback_batches == 1 and sm_t.stat_exact_batches == 0
    _native_equal(sm_t, sm_j)


@pytest.mark.parametrize("engine", ["host", "device"])
@pytest.mark.parametrize("config", ["linked", "two_phase", "offkernel"])
def test_native_lanes_match_reference(config, engine, monkeypatch):
    """The port's copies of bench's linked, two_phase and offkernel
    streams at 400 events per batch, both machines with their native
    libraries and the default routing: on the host engine every batch
    takes a native lane (the offkernel batches' balancing riders the
    serial exact engine), on the device engine the window's kernels take
    their classes and the rest drains to the same native lanes.  Replies,
    lookups, roots and routing counters equal; K3 never runs on the
    host engine."""
    setup, timed, sizing = getattr(workload, "gen_" + config)(1600, batch=400)
    rows = sizing[0] + 3
    ops = setup + timed + [(Operation.lookup_accounts, hz.ids_bytes(list(range(1, 401))))]
    sm_t, sm_j = _native_pair(monkeypatch, engine, rows)
    assert replay(sm_t, ops) == replay(sm_j, ops, ref_hz) == oracle(ops)
    _native_equal(sm_t, sm_j)
    if engine == "host":
        assert sm_t.stat_exact_batches == sm_t.stat_wave_batches == 0
        lane = {"linked": sm_t.stat_linked_batches, "two_phase": sm_t.stat_two_phase_batches,
                "offkernel": sm_t.stat_exact_events}[config]
        assert lane > 0

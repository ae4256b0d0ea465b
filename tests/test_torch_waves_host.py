"""Wave execution on the host engine's exact path: TorchStateMachine
(engine="host", on the CPU, so the plain versions of K7, K8, K3
segments and finalize run) against TpuStateMachine and the CPU oracle
under TB_WAVES = exact, 1 and scan, on four streams: the bench's
offkernel shapes, the waves_host stream (plain transfers around runs
of limit-reading chains), a stream over history accounts and a random
fuzz (tests/test_waves.py's batches).  Replies, state_root, the
looked-up rows and the routing counters must be equal.

Both machines run without their native libraries (TB_FASTPATH_DISABLE=1,
and the reference's _native dropped as tests/test_waves.py does): the
native serial engine would otherwise take the exact path's batches
(TB_WAVES=exact, 1 and scan bypass it anyway)."""

import numpy as np
import pytest

from test_waves import _random_batch
from tigerbeetle_tpu.state_machine.cpu import CpuStateMachine
from tigerbeetle_tpu.state_machine.tpu import TpuStateMachine
from tigerbeetle_tpu.testing import harness as ref_hz
from tigerbeetle_tpu_torch import workload
from tigerbeetle_tpu_torch.state_machine.gpu import TorchStateMachine
from tigerbeetle_tpu_torch.testing import harness as hz
from tigerbeetle_tpu_torch.types import AccountFlags, Operation
from torch_link_quiet import link_quiet  # noqa: F401  (autouse: no engine lost its link)

AF = AccountFlags
# Odd: the reference shards a device engine whose rows divide among the
# virtual CPU devices the suite's conftest makes, and a sharded engine
# neither speculates nor runs scan segments; the port's engine is one
# card, so it is held to the reference's single-device engine.
ROWS = (1 << 12) + 3
ROUTING = (
    "stat_wave_batches", "stat_wave_steps", "stat_wave_events", "stat_wave_parallel_events",
    "stat_dev_wave_batches", "stat_dev_wave_declined", "stat_dev_wave_steps",
    "stat_dev_wave_events", "stat_exact_events", "stat_linked_batches",
    "stat_two_phase_batches", "stat_fallback_events",
)


def _fuzz_ops(seed, n_accounts, flags_of, n_batches):
    """create_accounts, then test_waves's random batches (chains,
    in-batch and durable post/voids, Zipf-hot accounts, balancing, id
    reuse, timeouts) with the realtime moving on now and then."""
    rng = np.random.default_rng(seed)
    acct = [hz.account(i, flags=flags_of(rng, i)) for i in range(1, n_accounts + 1)]
    ops = [(Operation.create_accounts, hz.pack(acct), 0)]
    ids, t, realtime = [], 0, 0
    for _ in range(n_batches):
        rows, t = _random_batch(rng, ids, list(range(1, n_accounts + 1)), t)
        if rng.random() < 0.3:
            realtime += int(rng.integers(1, 4)) * 10**9
        ops.append((Operation.create_transfers, hz.pack(rows), realtime))
    ops.append((Operation.lookup_accounts, hz.ids_bytes(list(range(1, n_accounts + 1))), realtime))
    ops.append((Operation.lookup_transfers, hz.ids_bytes(sorted(set(ids))), realtime))
    return ops


def _fuzz_flags(rng, _i):
    flags = 0
    r = rng.random()
    if r < 0.2:
        flags |= int(AF.debits_must_not_exceed_credits)
    elif r < 0.35:
        flags |= int(AF.credits_must_not_exceed_debits)
    if rng.random() < 0.25:
        flags |= int(AF.history)
    return flags


def _with_lookups(setup, timed, ids):
    ops = [(op, body, 0) for op, body in setup + timed]
    ops.append((Operation.lookup_accounts, hz.ids_bytes(ids), 0))
    return ops


def stream(name):
    """(ops as (operation, body, realtime), account capacity)."""
    if name == "offkernel":
        setup, timed, _ = workload.gen_offkernel(1200, n_accounts=1_001, batch=200)
        return _with_lookups(setup, timed, list(range(1, 1001))), ROWS
    if name == "waves_host":
        setup, timed, _ = workload.gen_waves_host(1000, n_accounts=4000, n_limited=100,
                                                  batch=200)
        return _with_lookups(setup, timed, list(range(1, 4001))), ROWS
    if name == "history":
        ops = _fuzz_ops(21, 40, lambda rng, i: int(AF.history) if i <= 10 else 0, 8)
        return ops, ROWS
    return _fuzz_ops(13, 14, _fuzz_flags, 10), ROWS


STREAMS = ("offkernel", "waves_host", "history", "fuzz")


def replay(sm, ops, harness):
    h = harness.SingleNodeHarness(sm)
    futs = [h.submit_async(op, body, realtime=rt) for op, body, rt in ops]
    return [f.result() for f in futs]


def reference(engine, rows):
    sm = TpuStateMachine(account_capacity=rows, engine=engine)
    sm._native = None
    return sm


def run_both(ops, rows, engine):
    """The port, the reference and the oracle on one stream: replies
    and state_root equal; returns (port, reference)."""
    sm_t = TorchStateMachine(account_capacity=rows, device="cpu", engine=engine)
    got = replay(sm_t, ops, hz)
    sm_j = reference(engine, rows)
    want = replay(sm_j, ops, ref_hz)
    h_c = ref_hz.SingleNodeHarness(CpuStateMachine())
    oracle = [h_c.submit(op, body, realtime=rt) for op, body, rt in ops]
    assert got == want == oracle
    assert sm_t.state_root() == sm_j.state_root()
    assert sm_t.pulse_next_timestamp == sm_j.pulse_next_timestamp
    for stat in ROUTING:
        assert getattr(sm_t, stat) == getattr(sm_j, stat), stat
    assert sm_t.stat_dev_wave_decline_reasons == sm_j.stat_dev_wave_decline_reasons
    sm_t.verify_device_mirror()
    return sm_t, sm_j


@pytest.fixture
def no_native(monkeypatch):
    monkeypatch.setenv("TB_FASTPATH_DISABLE", "1")


@pytest.mark.parametrize("name", STREAMS)
@pytest.mark.parametrize("mode", ["exact", "1", "scan"])
def test_host_exact_path_matches_reference(name, mode, no_native, monkeypatch):
    monkeypatch.setenv("TB_WAVES", mode)
    ops, rows = stream(name)
    sm_t, _ = run_both(ops, rows, "host")
    if mode == "scan":
        assert sm_t.stat_wave_batches == 0 and sm_t.stat_exact_batches > 0
    elif mode == "1":  # plans forced past profitability
        assert sm_t.stat_wave_batches > 0


def test_waves_host_plans_hold_scan_segments(no_native, monkeypatch):
    """The waves_host stream's batches are admitted and planned by the
    reference (TB_WAVES=exact keeps its profitability and admission
    gates): waves around scan segments, none falls back to the scan."""
    from tigerbeetle_tpu.state_machine import tpu as ref_tpu

    monkeypatch.setenv("TB_WAVES", "exact")
    plans = []
    orig = ref_tpu.TpuStateMachine._grade_plan

    def grade(self, *args, **kwargs):
        plan = orig(self, *args, **kwargs)
        plans.append(plan)
        return plan

    monkeypatch.setattr(ref_tpu.TpuStateMachine, "_grade_plan", grade)
    ops, rows = stream("waves_host")
    sm_t, sm_j = run_both(ops, rows, "host")
    n_batches = sum(1 for op, _, _ in ops if op == Operation.create_transfers)
    assert sm_j.stat_wave_batches == n_batches and sm_t.stat_exact_batches == 0
    timed = [p for p in plans if p is not None and len(p.segments) > 1]
    assert len(timed) == n_batches - 1  # all but the funding batch
    for plan in timed:
        kinds = [k for k, _ in plan.segments]
        assert "scan" in kinds and "wave" in kinds

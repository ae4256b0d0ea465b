"""Wave and speculative dispatch inside the device engine's window:
TorchStateMachine(engine="device", on the CPU: the plain versions of
K7, K8, K9, K3 segments and finalize) against TpuStateMachine and the
CPU oracle under TB_DEV_WAVES = auto, 1 and 0 crossed with
TB_WAVES_SPECULATE = auto, 0 and force, on the streams of
test_torch_waves_host.py.  Replies, state_root, the routing counters,
the decline reasons and the speculative counters (the reference's
dev_wave.spec.*, timings aside) must be equal.  Then a window whose
wave records straddle an exact recovery.

A batch the wave router declines drains to the host path.  Both
machines run it with TB_WAVES=exact and without their native libraries,
so the declined batches reach the exact path with its wave plans, gates
kept, rather than the host lanes (the native and the numpy linked /
two-phase resolvers, held to the reference in test_torch_resolve.py)."""

import numpy as np
import pytest

import tigerbeetle_tpu.state_machine.device_engine as ref_de
import tigerbeetle_tpu_torch.state_machine.device_engine as de
from test_torch_waves_host import ROWS, STREAMS, replay, run_both, stream
from tigerbeetle_tpu.state_machine.cpu import CpuStateMachine
from tigerbeetle_tpu.testing import harness as ref_hz
from tigerbeetle_tpu_torch.state_machine.gpu import TorchStateMachine
from tigerbeetle_tpu_torch.testing import harness as hz
from tigerbeetle_tpu_torch.types import Operation, TransferFlags

TF = TransferFlags
SPEC = ("attempts", "hits", "plan_skipped", "residue_events", "steps")


def spec_counters(sm_t, sm_j):
    got = {k: sm_t._dev.spec_stats[k] for k in SPEC}
    ref = sm_j._dev.spec_stats or {}
    want = {k: (ref[k].value if k in ref else 0) for k in SPEC}
    return got, want


@pytest.fixture
def knobs(monkeypatch):
    monkeypatch.setenv("TB_FASTPATH_DISABLE", "1")
    monkeypatch.setenv("TB_WAVES", "exact")

    def set_(dev_waves, speculate):
        monkeypatch.setenv("TB_DEV_WAVES", dev_waves)
        monkeypatch.setenv("TB_WAVES_SPECULATE", speculate)

    return set_


@pytest.mark.parametrize("name", STREAMS)
@pytest.mark.parametrize("speculate", ["auto", "0", "force"])
@pytest.mark.parametrize("dev_waves", ["auto", "1", "0"])
def test_device_window_matches_reference(name, dev_waves, speculate, knobs):
    knobs(dev_waves, speculate)
    ops, rows = stream(name)
    sm_t, sm_j = run_both(ops, rows, "device")
    got, want = spec_counters(sm_t, sm_j)
    assert got == want
    assert sm_t._dev.inflight_bound() == 0
    if dev_waves == "0":
        assert sm_t.stat_dev_wave_batches == 0 and got["attempts"] == 0
    elif name == "offkernel":  # the wave-dispatch class itself
        assert sm_t.stat_dev_wave_batches > 0 and sm_t.stat_dev_wave_declined == 0
        assert (got["attempts"] > 0) == (speculate != "0")


def _pv_balancing_rows(tid, rng, accs, bal_accs):
    """Pending/post pairs with balancing riders on their own accounts:
    off the semantic kernels, a speculative or wave record."""
    rows = []
    for k in range(12):
        a, b = rng.choice(accs, 2, replace=False)
        rows.append(hz.transfer(tid + 2 * k, debit_account_id=int(a), credit_account_id=int(b),
                                amount=int(rng.integers(1, 50)), flags=int(TF.pending)))
        rows.append(hz.transfer(tid + 2 * k + 1, pending_id=tid + 2 * k,
                                flags=int(TF.post_pending_transfer)))
    rows.append(hz.transfer(tid + 30, debit_account_id=int(bal_accs[0]),
                            credit_account_id=int(bal_accs[1]), amount=5,
                            flags=int(TF.balancing_debit)))
    return rows


@pytest.mark.parametrize("speculate", ["auto", "0"])
def test_wave_records_across_exact_recovery(speculate, knobs, monkeypatch):
    """A window of [wave record, a batch K1 flags (more failures than
    its summary holds), wave record]: recovery resolves the first record
    from its fetched outputs, re-executes the flagged batch on the host
    and runs the second record again on the rebuilt table — replies and
    root equal to the reference's and the oracle's, no bound left in
    flight (the reference's test_wave_records_across_exact_recovery)."""
    knobs("auto", speculate)
    monkeypatch.setattr(de, "_WINDOW", 8)
    monkeypatch.setattr(ref_de, "_WINDOW", 8)
    rng = np.random.default_rng(9)
    accs = np.arange(1, 41)
    ops = [(Operation.create_accounts, hz.pack([hz.account(i) for i in range(1, 47)]), 0)]
    ops.append((Operation.create_transfers, hz.pack(_pv_balancing_rows(100, rng, accs, [41, 42])), 0))
    ops.append((Operation.create_transfers, hz.pack([
        hz.transfer(500 + i, debit_account_id=1, credit_account_id=1, amount=1)
        for i in range(100)]), 0))
    ops.append((Operation.create_transfers, hz.pack(_pv_balancing_rows(700, rng, accs, [43, 44])), 0))
    ops.append((Operation.lookup_accounts, hz.ids_bytes(list(range(1, 47))), 0))
    sm_t = TorchStateMachine(account_capacity=ROWS, device="cpu", engine="device")
    got = replay(sm_t, ops, hz)
    from tigerbeetle_tpu.state_machine.tpu import TpuStateMachine

    sm_j = TpuStateMachine(account_capacity=ROWS, engine="device")
    sm_j._native = None
    want = replay(sm_j, ops, ref_hz)
    h_c = ref_hz.SingleNodeHarness(CpuStateMachine())
    assert got == want == [h_c.submit(op, body) for op, body, _ in ops]
    assert sm_t.state_root() == sm_j.state_root()
    assert sm_t._dev.stat_fallback_batches >= 1, "recovery never ran"
    assert sm_t.stat_dev_wave_batches == sm_j.stat_dev_wave_batches == 2
    assert sm_t._dev.inflight_bound() == 0
    assert spec_counters(sm_t, sm_j)[0] == spec_counters(sm_t, sm_j)[1]
    sm_t.verify_device_mirror()

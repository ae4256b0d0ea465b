"""Hot/cold account tiering end to end: TorchStateMachine under
TB_HOT_CAPACITY (on the CPU: the plain versions of K1, K2, K4-K6, K10,
K11) against TpuStateMachine under the same setting and against the
port's own all-resident machine, in both engines.

- The reference's differential (tests/test_hot_tier.py): a 4-row hot
  set under 30 accounts, a random stream then the device-eligible
  batches, seeds 7 and 42.  Replies, state roots, interleaved lookups,
  the tier counters, the punts and the wave declines ("tier") equal the
  reference's; verify_device_mirror passes on both.
- Bench's tiering stream (run_tiering_compare's shape), warm-up then
  timed batches: the same, plus the hit rate gate.
- The growth differential, an exact recovery of a tiered window, the
  tripwire without the commitment, and a corrupted hot row named by its
  logical id.

Both sides run without their native libraries (TB_FASTPATH_DISABLE=1,
the reference's _native dropped), and the random-stream differential
also with both libraries on: the host engine then routes every batch
as the reference does (the native lanes send their deltas through the
tier), so its tier counters and maps are compared over the whole
stream.  Hot budgets do not divide by 8: the suite's conftest makes 8
virtual CPU devices, and the reference shards a table whose rows
divide among them."""

import numpy as np
import pytest

from test_hot_tier import _device_eligible_phase, _random_transfer
from tigerbeetle_tpu.state_machine.tpu import TpuStateMachine
from tigerbeetle_tpu.testing import harness as ref_hz
from tigerbeetle_tpu_torch import workload
from tigerbeetle_tpu_torch.state_machine.gpu import TorchStateMachine
from tigerbeetle_tpu_torch.testing import harness as hz
from tigerbeetle_tpu_torch.types import AccountFlags, Operation, TransferFlags

AF = AccountFlags
TF = TransferFlags
ROWS = 1 << 12
COUNTERS = ("hits", "misses", "evicts", "prefetches")


@pytest.fixture
def make(monkeypatch):
    """make(engine, hot, native=False) -> (port harness, reference
    harness, port all-resident harness); the port machines on the CPU,
    every machine with its native library when `native`, else none."""
    monkeypatch.setenv("TB_FASTPATH_DISABLE", "1")

    def build(engine, hot, rows=ROWS, native=False):
        if native:
            monkeypatch.delenv("TB_FASTPATH_DISABLE")
        monkeypatch.delenv("TB_HOT_CAPACITY", raising=False)
        flat = TorchStateMachine(account_capacity=rows, device="cpu", engine=engine)
        monkeypatch.setenv("TB_HOT_CAPACITY", str(hot))
        port = TorchStateMachine(account_capacity=rows, device="cpu", engine=engine)
        ref = TpuStateMachine(account_capacity=rows, engine=engine)
        if not native:
            ref._native = None
        assert (port._native is not None) == (ref._native is not None) == native
        assert flat._dev.hot is None
        assert port._dev.hot.hot_rows == ref._dev.hot.hot_rows == hot
        assert tuple(port._dev.balances.shape) == (hot, 8)
        return hz.SingleNodeHarness(port), ref_hz.SingleNodeHarness(ref), hz.SingleNodeHarness(flat)

    return build


def _all(harnesses, op, body, realtime=None):
    """Submit to every harness; the replies must be equal."""
    out = [h.submit(op, body, realtime=realtime) for h in harnesses]
    assert all(o == out[0] for o in out), op
    return out[0]


def _roots_equal(harnesses):
    roots = {h.sm.state_root() for h in harnesses}
    assert len(roots) == 1


def _lookups_equal(harnesses, ids):
    rows = [h.lookup_accounts(ids).tobytes() for h in harnesses]
    assert all(r == rows[0] for r in rows)


def _ref_punts(ref_sm):
    return ref_sm.metrics.snapshot().get("dev_tier.punt", 0)


def _tier_state(h):
    t = h.sm._dev.hot
    return {name: getattr(t, name) for name in COUNTERS}


def _maps_equal(port, ref):
    a, b = port.sm._dev.hot, ref.sm._dev.hot
    assert np.array_equal(a.hot_of, b.hot_of) and np.array_equal(a.logical_of, b.logical_of)
    assert np.array_equal(a._stamp, b._stamp) and a._clock == b._clock


def _verify_all(harnesses):
    for h in harnesses:
        h.sm.verify_device_mirror()


class _Group:
    """SingleNodeHarness-shaped front of machines that must agree: each
    submit and lookup goes to all of them (replies equal), and
    `sm.state_root()` checks their roots are equal."""

    def __init__(self, harnesses):
        self.hs = harnesses
        self.sm = self

    def submit(self, op, body, realtime=None):
        return _all(self.hs, op, body, realtime)

    def lookup_accounts(self, ids):
        _lookups_equal(self.hs, ids)
        return self.hs[0].lookup_accounts(ids)

    def state_root(self):
        _roots_equal(self.hs)
        return self.hs[0].sm.state_root()


@pytest.mark.parametrize("engine", ["host", "device"])
@pytest.mark.parametrize("seed", [7, 42])
def test_tiny_hot_capacity_differential(engine, seed, make):
    """A hot set of 4 rows under 30 accounts forces admission and
    eviction on nearly every device batch (the reference's
    test_tiny_hot_capacity_differential, on the port)."""
    _tiny_hot_stream(*make(engine, 4), engine, seed, native=False)


@pytest.mark.parametrize("engine", ["host", "device"])
@pytest.mark.parametrize("seed", [7, 42])
def test_tiny_hot_capacity_native(engine, seed, make):
    """The same differential with the native libraries on both sides:
    the host engine's native lanes (order-free, linked, two-phase, the
    serial exact engine) feed the tier as the reference's do, so the
    tier counters, maps and routing counters are equal at the end of
    the whole stream."""
    _tiny_hot_stream(*make(engine, 4, native=True), engine, seed, native=True)


def _tiny_hot_stream(port, ref, flat, engine, seed, native):
    hs = [port, ref, flat]
    rng = np.random.default_rng(seed)
    account_ids = list(range(1, 25))
    rows = []
    for aid in account_ids:
        flags = 0
        r = rng.random()
        if r < 0.2:
            flags |= AF.debits_must_not_exceed_credits
        elif r < 0.4:
            flags |= AF.credits_must_not_exceed_debits
        rows.append(hz.account(aid, flags=int(flags)))
    plain_ids = tuple(range(25, 31))
    rows += [hz.account(aid) for aid in plain_ids]
    _all(hs, Operation.create_accounts, hz.pack(rows))

    ids: list[int] = []
    t_index = 0
    realtime = 0
    for batch_no in range(8):
        batch = []
        for _ in range(int(rng.integers(2, 16))):
            row, new_id = _random_transfer(rng, ids, account_ids, t_index)
            batch.append(row)
            ids.append(new_id)
            t_index += 1
        if rng.random() < 0.8:
            last = batch[-1].copy()
            last["flags"] = int(last["flags"]) & ~int(TF.linked)
            batch[-1] = last
        if rng.random() < 0.3:
            realtime += int(rng.integers(1, 4)) * 10**9
        _all(hs, Operation.create_transfers, hz.pack(batch), realtime)
        if batch_no % 3 == 2:
            _lookups_equal(hs, [int(rng.choice(account_ids)) for _ in range(6)])
        _roots_equal(hs)
    if engine == "host":
        # Without the libraries only pulses' releases reached the tier so
        # far (the Python resolvers take no batch of the random stream);
        # with them every lane routes as the reference's: equal counters.
        assert _tier_state(port) == _tier_state(ref)

    # The device-eligible batches: order-free, linked and two-phase
    # classes through the tier's prefetch and translation.
    _device_eligible_phase(_Group([ref]), _Group([port, flat]), plain_ids)

    _lookups_equal(hs, account_ids)
    probe = sorted(set(ids))
    got = [h.lookup_transfers(probe).tobytes() for h in hs]
    assert got[0] == got[1] == got[2]
    tier = port.sm._dev.hot
    assert tier.misses > 0 and tier.evicts > 0
    if engine == "host" and native:
        assert _tier_state(port) == _tier_state(ref)
        _maps_equal(port, ref)
        for stat in ("stat_linked_batches", "stat_two_phase_batches", "stat_exact_events",
                     "stat_device_events", "stat_hot_tail_batches", "stat_slow_tail_batches"):
            assert getattr(port.sm, stat) == getattr(ref.sm, stat), stat
    if engine == "device":
        assert _tier_state(port) == _tier_state(ref)
        _maps_equal(port, ref)
        assert port.sm.stat_tier_punts == _ref_punts(ref.sm)
        assert port.sm.stat_dev_wave_decline_reasons == ref.sm.stat_dev_wave_decline_reasons
        assert port.sm.stat_dev_wave_decline_reasons.get("tier", 0) > 0
        assert flat.sm.stat_dev_wave_decline_reasons.get("tier", 0) == 0
        for stat in ("stat_linked_batches", "stat_two_phase_batches", "stat_exact_events",
                     "stat_fallback_events", "stat_dev_wave_declined"):
            assert getattr(port.sm, stat) == getattr(ref.sm, stat), stat
        assert port.sm.stat_device_semantic_events == ref.sm.stat_device_semantic_events > 0
    _verify_all(hs)


def _tiering_ops(n_batches, batch=256, n_acct=640, head=48):
    """run_tiering_compare's stream: warm-up batches, then timed ones."""
    warm = workload.gen_tiering(4, batch, n_acct, head, 0.008, workload.WARM0)
    timed = workload.gen_tiering(n_batches, batch, n_acct, head, 0.008, workload.TID0)
    return warm, timed


@pytest.mark.parametrize("engine", ["host", "device"])
def test_tiering_stream_matches_reference(engine, make):
    """Bench's Zipf-head stream (640 accounts, head 48, tail 0.008, 256
    events per batch) under a 62-row hot set: the counters after the
    warm-up equal the reference's, the hit rate holds bench's 0.90 gate,
    replies and roots equal the reference's and the all-resident run."""
    port, ref, flat = make(engine, 62)
    hs = [port, ref, flat]
    _all(hs, Operation.create_accounts, workload.accounts_bytes(range(1, 641)))
    warm, timed = _tiering_ops(24)
    for op, body in warm:
        _all(hs, op, body)
    for h in (port, ref):
        t = h.sm._dev.hot
        t.hits = t.misses = t.evicts = 0
        t.prefetch_stall_us = 0.0
    for op, body in timed:
        _all(hs, op, body)
    _roots_equal(hs)
    assert _tier_state(port) == _tier_state(ref)
    _maps_equal(port, ref)
    t = port.sm._dev.hot
    assert t.hits / (t.hits + t.misses) >= 0.90 and t.misses > 0
    if engine == "device":
        assert port.sm.stat_tier_punts == _ref_punts(ref.sm)
        assert port.sm.stat_device_semantic_events == ref.sm.stat_device_semantic_events
    _lookups_equal(hs, list(range(1, 641)))
    _verify_all(hs)


def test_gen_tiering_is_bench_stream(monkeypatch):
    """The port's generator gives bench's bytes at run_tiering_compare's
    arguments."""
    import importlib
    import os

    monkeypatch.syspath_prepend(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    bench = importlib.import_module("bench")
    for n, tid0 in ((4, bench.WARM0), (48, bench.TID0)):
        want = bench._gen_tiering_stream(n, 256, 640, 48, 0.008, tid0)
        got = workload.gen_tiering(n, 256, 640, 48, 0.008, tid0)
        assert [(int(op), b) for op, b in got] == [(int(op), b) for op, b in want]
    assert (workload.WARM0, workload.TID0) == (bench.WARM0, bench.TID0)


@pytest.mark.parametrize("engine", ["host", "device"])
def test_tiered_growth_differential(engine, make):
    """Growth past the initial capacity widens the logical table while
    the hot budget stays fixed (the reference's
    test_tiered_growth_differential)."""
    port, ref, flat = make(engine, 6)
    hs = [port, ref, flat]
    for h in hs:
        h.sm._dev.grow(1 << 13)
        h.sm._mirror.grow(1 << 13)
    assert port.sm._dev.hot.logical_capacity == 1 << 13 and port.sm._dev.hot.hot_rows == 6
    assert tuple(port.sm._dev.balances.shape) == (6, 8)
    assert tuple(flat.sm._dev.balances.shape) == (1 << 13, 8)
    account_ids = list(range(1, 40))
    _all(hs, Operation.create_accounts, hz.pack([hz.account(a) for a in account_ids]))
    batch = [hz.transfer(1000 + i, debit_account_id=account_ids[i % 39],
                         credit_account_id=account_ids[(i + 7) % 39], amount=3)
             for i in range(64)]
    _all(hs, Operation.create_transfers, hz.pack(batch))
    small = [hz.transfer(2000 + i, debit_account_id=1 + i, credit_account_id=2 + i, amount=2)
             for i in range(2)]
    _all(hs, Operation.create_transfers, hz.pack(small))
    _roots_equal(hs)
    assert _tier_state(port) == _tier_state(ref)
    if engine == "device":
        assert port.sm.stat_tier_punts == _ref_punts(ref.sm) == 1  # 39 accounts > 6 rows
    _lookups_equal(hs, account_ids)
    _verify_all(hs)


def test_tiered_exact_recovery(make):
    """A window of [order-free batch, a batch K1 flags (an overflow),
    order-free batch, lookup] on resident rows: recovery re-executes the
    flagged batch on the host, re-uploads the hot image of the mirror,
    and launches the later records again on hot slots."""
    port, ref, flat = make("device", 6)
    hs = [port, ref, flat]
    _all(hs, Operation.create_accounts, hz.pack([hz.account(a) for a in range(1, 9)]))
    warm = [hz.transfer(10 + i, debit_account_id=1 + i, credit_account_id=2 + i, amount=1)
            for i in range(3)]
    _all(hs, Operation.create_transfers, hz.pack(warm))  # rows 1-4 resident
    big = (1 << 127) + 5
    ops = [
        hz.pack([hz.transfer(100, debit_account_id=1, credit_account_id=2, amount=7)]),
        hz.pack([hz.transfer(200, debit_account_id=1, credit_account_id=3, amount=big),
                 hz.transfer(201, debit_account_id=1, credit_account_id=4, amount=big)]),
        hz.pack([hz.transfer(300, debit_account_id=3, credit_account_id=4, amount=9)]),
    ]
    replies = []
    for h in hs:
        futs = [h.submit_async(Operation.create_transfers, body) for body in ops]
        futs.append(h.submit_async(Operation.lookup_accounts, hz.ids_bytes([1, 2, 3, 4])))
        replies.append([f.result() for f in futs])
    assert replies[0] == replies[1] == replies[2]
    assert port.sm._dev.stat_fallback_batches >= 1, "recovery never ran"
    assert port.sm.stat_fallback_events == ref.sm.stat_fallback_events > 0
    assert _tier_state(port) == _tier_state(ref)
    _roots_equal(hs)
    _verify_all(hs)


@pytest.mark.parametrize("engine", ["host", "device"])
def test_tripwire_without_commitment(engine, make, monkeypatch):
    """TB_STATE_COMMIT=0: verify_device_mirror compares K11 digests of
    the hot device tables with the hot images (device engine: balances
    and meta), passes on an honest run and names the logical row of a
    corrupted hot row."""
    monkeypatch.setenv("TB_STATE_COMMIT", "0")
    port, ref, flat = make(engine, 6)
    hs = [port, ref, flat]
    _all(hs, Operation.create_accounts, hz.pack([hz.account(a) for a in range(1, 13)]))
    for k in range(4):
        rows = [hz.transfer(100 * k + i, debit_account_id=1 + (3 * k + i) % 12,
                            credit_account_id=1 + (3 * k + i + 1) % 12, amount=5 + i)
                for i in range(2)]
        _all(hs, Operation.create_transfers, hz.pack(rows))
    _roots_equal(hs)
    _verify_all(hs)
    dev = port.sm._dev
    slot = int(np.flatnonzero(dev.hot.logical_of >= 0)[0])
    dev.balances[slot, 3] += 1
    with pytest.raises(AssertionError, match="divergence") as err:
        port.sm.verify_device_mirror()
    if engine == "device":
        assert f"first: [{int(dev.hot.logical_of[slot])}]" in str(err.value)


def test_tripwire_names_logical_rows_with_commitment(make):
    """With the commitment live, a corrupted hot row breaks the probe
    pair and the localization names its logical row."""
    port, _ref, _flat = make("device", 6)
    h = port
    h.submit(Operation.create_accounts, hz.pack([hz.account(a) for a in range(1, 13)]))
    h.submit(Operation.create_transfers, hz.pack([
        hz.transfer(7, debit_account_id=9, credit_account_id=11, amount=3)]))
    h.sm.verify_device_mirror()
    dev = h.sm._dev
    slot = int(dev.hot.hot_of[10])  # account 11's logical row
    assert slot >= 0
    dev.balances[slot, 6] += 1
    with pytest.raises(AssertionError, match=r"1 rows diverged \(first: \[10\]\)"):
        h.sm.verify_device_mirror()


def test_engine_checksum_matches_reference(make):
    """DeviceEngine.checksum(): the logical table's digest — K11 on the
    device table all-resident, the mirror's under tiering — equals the
    reference engine's, and gather_hot cuts the hot image the mirror's
    hot table shows."""
    import torch

    from tigerbeetle_tpu_torch.ops.u128 import from_u64, to_u64
    from tigerbeetle_tpu_torch.state_machine import hot_tier

    port, ref, flat = make("device", 6)
    hs = [port, ref, flat]
    _all(hs, Operation.create_accounts, hz.pack([hz.account(a) for a in range(1, 21)]))
    rows = [hz.transfer(10 + i, debit_account_id=1 + i, credit_account_id=20 - i, amount=3 + i)
            for i in range(2)]
    _all(hs, Operation.create_transfers, hz.pack(rows))
    want = ref.sm._dev.checksum()
    assert np.array_equal(port.sm._dev.checksum(), want)
    assert np.array_equal(flat.sm._dev.checksum(), want)
    dev = port.sm._dev
    image = from_u64(port.sm._mirror.table8(ROWS))
    got = to_u64(hot_tier.gather_hot(image, dev.hot.logical_of))
    assert np.array_equal(got, hot_tier.mirror_hot_table8(port.sm._mirror, dev.hot.logical_of))
    assert torch.equal(hot_tier.gather_hot(image, dev.hot.logical_of), dev.balances)

"""The row-sharded engines: TorchStateMachine over devices=["cpu"] * 8
(the plain versions of every kernel, K14 gathers and scatters around
them, K2 and K11 per shard) against the reference's TpuStateMachine,
which the suite's conftest shards over 8 virtual CPU devices at the same
capacity, and the CPU oracle.

Replies (lookups included), state_root, the routing counters, the
decline reasons, stat_wave_sharded and the speculation counters must be
equal, bit for bit.  The cases are the reference's sharded ones
(tests/test_device_waves.py: two-phase stream, chain batch, chain
rollback, shard-plan decline, sharded differential;
tests/test_sharded.py: the host engine's sharded flush), then growth
that keeps and that drops the sharding, and tiered tables whose hot rows
divide by 8.

A batch the wave router declines takes the host path.  Most cases run
it with TB_WAVES=exact (as tests/test_torch_waves_device.py does) and
both machines without their native libraries; test_sharded_native_lanes
runs both engines with the libraries on both sides and the default
routing, where the host path is the native lanes."""

import numpy as np
import pytest

import tigerbeetle_tpu.state_machine.device_engine as ref_de
import tigerbeetle_tpu_torch.state_machine.device_engine as de
from test_device_waves import _fuzz_stream, _pv_balancing_batch
from tigerbeetle_tpu.state_machine.cpu import CpuStateMachine
from tigerbeetle_tpu.state_machine.tpu import TpuStateMachine
from tigerbeetle_tpu.testing import harness as ref_hz
from tigerbeetle_tpu_torch import workload
from tigerbeetle_tpu_torch.parallel import sharded
from tigerbeetle_tpu_torch.state_machine.gpu import TorchStateMachine
from tigerbeetle_tpu_torch.testing import harness as hz
from tigerbeetle_tpu_torch.testing import shard_cases
from tigerbeetle_tpu_torch.types import AccountFlags, Operation, TransferFlags

AF, TF = AccountFlags, TransferFlags
SHARDS = ["cpu"] * 8
ROWS = 1 << 12  # divides by 8: both machines shard
ROUTING = (
    "stat_wave_batches", "stat_wave_steps", "stat_wave_events", "stat_wave_parallel_events",
    "stat_dev_wave_batches", "stat_dev_wave_declined", "stat_dev_wave_steps",
    "stat_dev_wave_events", "stat_exact_events",
    "stat_linked_batches", "stat_two_phase_batches", "stat_fallback_events",
    "stat_host_semantic_events",
)
SPEC = ("attempts", "hits", "plan_skipped", "residue_events", "steps")


@pytest.fixture
def knobs(monkeypatch):
    monkeypatch.setenv("TB_FASTPATH_DISABLE", "1")
    monkeypatch.setenv("TB_WAVES", "exact")
    monkeypatch.setattr(de, "_WINDOW", 4)
    monkeypatch.setattr(ref_de, "_WINDOW", 4)
    return monkeypatch


def accounts(ids, flags=0):
    return hz.pack([hz.account(i, flags=flags) for i in ids])


def machines(engine, rows=ROWS, native=False):
    sm_t = TorchStateMachine(account_capacity=rows, device="cpu", devices=SHARDS, engine=engine)
    sm_j = TpuStateMachine(account_capacity=rows, engine=engine)
    if not native:
        sm_j._native = None
    assert (sm_t._native is not None) == (sm_j._native is not None) == native
    return sm_t, sm_j


def replay(sm, ops, harness, between=None):
    h = harness.SingleNodeHarness(sm)
    futs = []
    for k, (op, body) in enumerate(ops):
        if between is not None:
            between(sm, k)
        futs.append(h.submit_async(op, body))
    return [f.result() for f in futs]


def spec_counters(sm_t, sm_j):
    ref = sm_j._dev.spec_stats or {}
    return ({k: sm_t._dev.spec_stats[k] for k in SPEC},
            {k: (ref[k].value if k in ref else 0) for k in SPEC})


def run_both(ops, engine="device", rows=ROWS, between=None, native=False):
    """The sharded port, the sharded reference and the oracle on one
    stream; returns (port, reference, replies)."""
    sm_t, sm_j = machines(engine, rows, native)
    got = replay(sm_t, ops, hz, between)
    want = replay(sm_j, ops, ref_hz, between)
    h_c = ref_hz.SingleNodeHarness(CpuStateMachine())
    oracle = [h_c.submit(op, body) for op, body in ops]
    for i, (a, b, c) in enumerate(zip(got, want, oracle)):
        assert a == b == c, f"reply {i} differs ({ops[i][0]!r})"
    assert sm_t.state_root() == sm_j.state_root()
    for stat in ROUTING:
        assert getattr(sm_t, stat) == getattr(sm_j, stat), stat
    assert sm_t.stat_dev_wave_decline_reasons == sm_j.stat_dev_wave_decline_reasons
    if engine == "device":
        assert sm_t._dev.stat_wave_sharded == sm_j._dev.stat_wave_sharded
        got_spec, want_spec = spec_counters(sm_t, sm_j)
        assert got_spec == want_spec == dict.fromkeys(SPEC, 0)
    assert (sm_t._dev.sharding is None) == (sm_j._dev.sharding is None)
    sm_t.verify_device_mirror()
    return sm_t, sm_j, got


def is_sharded(sm) -> bool:
    return sm._dev.sharding is not None and isinstance(sm._dev.balances, sharded.ShardedTable)


def test_sharded_two_phase_stream_waves_in_window(knobs):
    rng = np.random.default_rng(7)
    ops = [(Operation.create_accounts, accounts(range(1, 47)))]
    tid = 100
    for _ in range(6):
        rows, tid = _pv_balancing_batch(tid, np.arange(1, 41), rng, bal_accs=list(range(41, 47)))
        ops.append((Operation.create_transfers, hz.pack(rows)))
    ops.append((Operation.lookup_accounts, hz.ids_bytes(list(range(1, 47)))))
    sm_t, _, _ = run_both(ops)
    assert is_sharded(sm_t) and sm_t._dev.wave_mesh() is not None
    assert sm_t.stat_dev_wave_batches == 6 and sm_t.stat_dev_wave_declined == 0
    assert sm_t.stat_host_semantic_events == 0
    assert sm_t._dev.stat_wave_sharded >= 6
    assert sm_t.stat_dev_wave_steps <= 2 * sm_t.stat_dev_wave_batches


def _chain_rows(tid, n_chains, fail_chain=None):
    rows = []
    for c in range(n_chains):
        for j in range(3):
            f = int(TF.linked) if j < 2 else 0
            if j == 0:
                f |= int(TF.pending)
            dr, cr = 1 + 2 * c, 2 + 2 * c
            if c == fail_chain and j == 1:
                cr = dr  # accounts_must_be_different: the chain rolls back
            rows.append(hz.transfer(tid, debit_account_id=dr, credit_account_id=cr,
                                    amount=3 + j, flags=f))
            tid += 1
    return rows, tid


def test_sharded_chain_batch_waves_in_window(knobs):
    ops = [(Operation.create_accounts, accounts(range(1, 101)))]
    tid = 100
    for _ in range(3):
        rows, tid = _chain_rows(tid, 16)
        ops.append((Operation.create_transfers, hz.pack(rows)))
    ops.append((Operation.lookup_accounts, hz.ids_bytes(list(range(1, 101)))))
    sm_t, _, _ = run_both(ops)
    assert sm_t.stat_dev_wave_batches == 3 and sm_t.stat_dev_wave_declined == 0
    assert sm_t._dev.stat_wave_sharded >= 3
    assert sm_t.stat_dev_wave_steps == 3 * 8


def test_sharded_chain_rollback_in_window(knobs):
    rows, _ = _chain_rows(100, 8, fail_chain=3)
    ops = [(Operation.create_accounts, accounts(range(1, 41))),
           (Operation.create_transfers, hz.pack(rows)),
           (Operation.lookup_accounts, hz.ids_bytes(list(range(1, 41))))]
    sm_t, _, _ = run_both(ops)
    assert sm_t.stat_dev_wave_batches == 1 and sm_t._dev.stat_wave_sharded >= 1


def test_sharded_plan_with_scan_segment_declines(knobs):
    knobs.setenv("TB_DEV_WAVES", "1")
    rng = np.random.default_rng(13)
    ops = [(Operation.create_accounts, hz.pack(
        [hz.account(i) for i in range(1, 41)]
        + [hz.account(41, flags=int(AF.history)), hz.account(42, flags=int(AF.history))]))]
    rows = []
    for tid in range(100, 120):
        a, b = rng.choice(np.arange(1, 41), 2, replace=False)
        rows.append(hz.transfer(tid, debit_account_id=int(a), credit_account_id=int(b),
                                amount=int(rng.integers(1, 40)), flags=int(TF.pending)))
    rows.append(hz.transfer(120, debit_account_id=41, credit_account_id=42, amount=5,
                            flags=int(TF.pending)))
    ops.append((Operation.create_transfers, hz.pack(rows)))
    ops.append((Operation.lookup_accounts, hz.ids_bytes(list(range(1, 43)))))
    sm_t, _, _ = run_both(ops)
    assert sm_t.stat_dev_wave_batches == 0
    assert sm_t.stat_dev_wave_decline_reasons.get("shard_plan", 0) >= 1
    assert sm_t.stat_host_semantic_events > 0


@pytest.mark.parametrize("seed", [31, 32])
def test_sharded_waves_differential(seed, knobs):
    """The reference's three-arm differential on the port: sharded waves
    forced on (held to the sharded reference), sharded waves off and
    unsharded waves on agree on every reply, and the two sharded arms on
    the table digest."""
    replies, digests = {}, {}
    for name, rows, mode in (("sharded_on", 1 << 10, "1"), ("sharded_off", 1 << 10, "0"),
                             ("unsharded_on", (1 << 10) + 1, "1")):
        knobs.setenv("TB_DEV_WAVES", mode)
        ops = _fuzz_stream(np.random.default_rng(seed))
        if name == "sharded_on":
            sm, _, replies[name] = run_both(ops, rows=rows)
            assert sm.stat_dev_wave_batches > 0 and sm._dev.stat_wave_sharded > 0
        else:
            sm = TorchStateMachine(account_capacity=rows, device="cpu", devices=SHARDS,
                                   engine="device")
            replies[name] = replay(sm, ops, hz)
            sm.verify_device_mirror()
            assert is_sharded(sm) == (rows % 8 == 0)
            assert (sm.stat_dev_wave_batches > 0) == (mode == "1")
        if rows % 8 == 0:
            digests[name] = sm._dev.checksum()
    assert replies["sharded_on"] == replies["sharded_off"] == replies["unsharded_on"]
    assert (digests["sharded_on"] == digests["sharded_off"]).all()


def _plain_stream(n_accounts, n_batches, rng, tid=100):
    """Order-free batches of 64 transfers: K1 on the device engine, the
    write-behind lane (K4) on the host engine under TB_WAVES=auto."""
    ops = [(Operation.create_accounts, accounts(range(1, n_accounts + 1)))]
    for _ in range(n_batches):
        rows = []
        for _ in range(64):
            a, b = rng.choice(np.arange(1, n_accounts + 1), 2, replace=False)
            rows.append(hz.transfer(tid, debit_account_id=int(a), credit_account_id=int(b),
                                    amount=int(rng.integers(1, 90))))
            tid += 1
        ops.append((Operation.create_transfers, hz.pack(rows)))
    ops.append((Operation.lookup_accounts, hz.ids_bytes(list(range(1, n_accounts + 1)))))
    return ops


def test_host_engine_table_shards_across_mesh(knobs):
    """tests/test_sharded.py::test_device_table_shards_across_mesh on the
    port: the host engine's write-behind table splits over the 8 shards
    and its K4 flushes on compact rows keep it equal to the mirror (an
    order-free stream: both machines route it alike under TB_WAVES=auto,
    the write-behind lane)."""
    knobs.delenv("TB_WAVES")
    ops = [(Operation.create_accounts, accounts(range(1, 33), flags=0))]
    ops.append((Operation.create_transfers, hz.pack([
        hz.transfer(100 + k, debit_account_id=1 + (k % 31), credit_account_id=2 + ((k + 7) % 31),
                    amount=3 + k, ledger=1, code=1) for k in range(64)])))
    ops.append((Operation.lookup_accounts, hz.ids_bytes(list(range(1, 33)))))
    sm_t, _, _ = run_both(ops, engine="host", rows=1 << 10)
    assert is_sharded(sm_t) and len(sm_t._dev.balances.shards) == 8
    assert sm_t._dev.stat_flushes > 0
    assert sm_t._dev.balances.join().any(), "the flushes never reached the shards"


@pytest.mark.parametrize("engine", ["device", "host"])
def test_sharded_mixed_stream(engine, knobs):
    """Order-free (K1 / K4), linked (K5 / K3) and two-phase (K6 / K3)
    batches with lookups between them, and a wave-routed stream."""
    knobs.setenv("TB_DEV_WAVES", "auto")
    ops = _fuzz_stream(np.random.default_rng(5))
    ops += _plain_stream(60, 3, np.random.default_rng(6), tid=50_000)[1:]
    sm_t, _, _ = run_both(ops, engine=engine)
    assert is_sharded(sm_t)
    if engine == "device":
        assert sm_t._dev.stat_semantic_events > 0


@pytest.mark.parametrize("engine", ["device", "host"])
def test_grow_keeps_sharding(engine, knobs):
    """1,100 accounts on a 2^10-row machine: the tables double to 2^11
    rows, which still divide by 8, and stay sharded."""
    knobs.delenv("TB_WAVES")
    ops = _plain_stream(1100, 3, np.random.default_rng(3))
    sm_t, _, _ = run_both(ops, engine=engine, rows=1 << 10)
    assert sm_t._dev.capacity == 1 << 11 and is_sharded(sm_t)


def _grow_at(k_grow, capacity):
    def grow(sm, k):
        if k == k_grow:
            sm._dev.grow(capacity)
            sm._mirror.grow(capacity)
    return grow


def test_grow_drops_sharding_device_engine(knobs):
    """Grown to a capacity 8 does not divide, the device engine's tables
    come back through the host as one dense table (the reference's rule,
    device_engine.py:855-857), and the stream goes on equal."""
    knobs.delenv("TB_WAVES")
    ops = _plain_stream(60, 4, np.random.default_rng(4))
    grown = (1 << 10) + 4
    sm_t, _, _ = run_both(ops, rows=1 << 10, between=_grow_at(3, grown))
    assert sm_t._dev.capacity == grown and sm_t._dev.sharding is None
    assert not isinstance(sm_t._dev.balances, sharded.ShardedTable)


def test_grow_drops_sharding_host_engine(knobs):
    """The host engine drops its sharding the same way.  The reference's
    host table re-places a grown table under its sharding, which JAX
    refuses for 1,028 rows over 8 devices; so the port is held to the
    oracle and to an unsharded port run of the same stream."""
    knobs.delenv("TB_WAVES")
    ops = _plain_stream(60, 4, np.random.default_rng(4))
    grown = (1 << 10) + 4
    sm_t = TorchStateMachine(account_capacity=1 << 10, device="cpu", devices=SHARDS, engine="host")
    got = replay(sm_t, ops, hz, _grow_at(3, grown))
    dense = TorchStateMachine(account_capacity=1 << 10, device="cpu", engine="host")
    h_c = ref_hz.SingleNodeHarness(CpuStateMachine())
    assert got == replay(dense, ops, hz, _grow_at(3, grown)) == [
        h_c.submit(op, body) for op, body in ops]
    assert sm_t.state_root() == dense.state_root()
    assert sm_t._dev.capacity == grown and sm_t._dev.sharding is None
    sm_t.verify_device_mirror()
    _, sm_j = machines("host", 1 << 10)
    with pytest.raises(ValueError, match="divisible"):
        sm_j._dev.grow(grown)


@pytest.mark.parametrize("engine", ["device", "host"])
@pytest.mark.parametrize("hot", [64, 16])
def test_tiered_hot_rows_shard(engine, hot, knobs):
    """A hot set whose rows divide by 8: both machines shard the hot
    table, admission runs K10 (and K2 admit) per shard, and replies,
    roots and tier counters stay equal."""
    knobs.delenv("TB_WAVES")
    knobs.setenv("TB_HOT_CAPACITY", str(hot))
    ops = _plain_stream(200, 6, np.random.default_rng(8))
    sm_t, sm_j, _ = run_both(ops, engine=engine, rows=(1 << 10) + 1)
    assert is_sharded(sm_t) and sm_t._dev.balances.rows == hot
    for name in ("hits", "misses", "evicts"):
        assert getattr(sm_t._dev.hot, name) == getattr(sm_j._dev.hot, name), name
    assert sm_t.stat_tier_punts == sm_j.metrics.snapshot().get("dev_tier.punt", 0)


def test_construction_rules():
    """A named device alone keeps one table; a list whose count does not
    divide the rows keeps one table; the device must be the list's first;
    without devices or a device and without a card, construction raises."""
    one = TorchStateMachine(account_capacity=ROWS, device="cpu", engine="device")
    assert one._dev.sharding is None and one._dev.wave_mesh() is None
    odd = TorchStateMachine(account_capacity=ROWS + 1, device="cpu", devices=SHARDS,
                            engine="device")
    assert odd._dev.sharding is None
    four = TorchStateMachine(account_capacity=ROWS, devices=["cpu"] * 4, engine="host")
    assert four._dev.sharding.shape == {"shard": 4} and four.device.type == "cpu"
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            TorchStateMachine(account_capacity=ROWS, engine="device")


@pytest.mark.parametrize("config", ["simple", "linked", "two_phase"])
def test_sharded_semantic_kernel_streams(config, knobs):
    """The port's copies of bench's simple, linked and two_phase streams
    at 400 events per batch: every timed batch rides K1, K5 or K6 on the
    compact rows of its window unit, routed as on the sharded reference."""
    knobs.setenv("TB_WAVES", "scan")
    knobs.setenv("TB_DEV_WAVES", "0")
    setup, timed, sizing = getattr(workload, "gen_" + config)(1200, batch=400)
    ops = setup + timed + [(Operation.lookup_accounts, hz.ids_bytes(list(range(1, 401))))]
    sm_t, _, _ = run_both(ops, rows=sizing[0])
    assert is_sharded(sm_t) and sm_t.stat_fallback_events == 0
    routed = {"simple": sm_t._dev.stat_semantic_events, "linked": sm_t.stat_linked_batches,
              "two_phase": sm_t.stat_two_phase_batches}[config]
    assert routed > 0


def test_pv_balancing_stream_declines_exactly_its_scan_batches(knobs):
    """chip_smoke's sharded_engine stream at 400 events per batch:
    every batch wave-dispatches over the mesh but those with a pending
    between history accounts, which decline "shard_plan" (their plans
    need a scan segment; TB_DEV_WAVES=1 admits them past the
    profitability grade, as the reference's decline test does)."""
    knobs.setenv("TB_DEV_WAVES", "1")
    setup, timed = shard_cases.pv_balancing_stream(3, 5, 400, 3000, history_batches=(1, 3))
    ops = setup + timed + [(Operation.lookup_accounts, hz.ids_bytes(list(range(2800, 3005))))]
    sm_t, _, _ = run_both(ops)
    assert sm_t.stat_dev_wave_decline_reasons == {"shard_plan": 2}
    assert sm_t.stat_dev_wave_batches == 3 and sm_t._dev.stat_wave_sharded == 3


NATIVE_ROUTING = ("stat_device_events", "stat_hot_tail_batches", "stat_slow_tail_batches",
                  "stat_resolve_iters")


@pytest.mark.parametrize("stream", ["mixed", "grow"])
@pytest.mark.parametrize("engine", ["device", "host"])
def test_sharded_native_lanes(engine, stream, knobs):
    """Both engines with the native libraries on both sides and the
    default routing (TB_WAVES unset): the host path's batches take the
    native lanes (order-free, linked, two-phase, the serial exact engine)
    on either machine, their deltas flush to the shards, and replies,
    roots and every routing counter stay equal.  "grow" widens the
    tables mid-stream (2^10 to 2^11 rows, still sharded): the native
    object is rebuilt and the mirror re-pointed on both machines."""
    knobs.delenv("TB_FASTPATH_DISABLE")
    knobs.delenv("TB_WAVES")
    if stream == "mixed":
        ops = _fuzz_stream(np.random.default_rng(5))
        ops += _plain_stream(60, 3, np.random.default_rng(6), tid=50_000)[1:]
        sm_t, sm_j, _ = run_both(ops, engine=engine, native=True)
    else:
        ops = _plain_stream(1100, 3, np.random.default_rng(3))
        sm_t, sm_j, _ = run_both(ops, engine=engine, rows=1 << 10, native=True)
        assert sm_t._dev.capacity == sm_t._native.capacity == 1 << 11
    assert is_sharded(sm_t)
    for stat in NATIVE_ROUTING:
        assert getattr(sm_t, stat) == getattr(sm_j, stat), stat
    if engine == "host":
        assert sm_t.stat_device_events > 0 and sm_t.stat_wave_batches == 0

"""Device-loss chaos on the port's device engine, on the CPU: demote ->
serve degraded -> re-promote, against TpuStateMachine and the oracle.

tests/test_chaos.py's cases re-pointed at TorchStateMachine(device="cpu",
engine="device", device_link=<the port's ChaosLink>), with the same
fixtures (window 4, no backoff, probe every 2).  Each case drives the
reference's TpuStateMachine behind the reference's ChaosLink and
CpuStateMachine through the same operations and the same scripted
faults (fail_next, kill / heal): every reply and the final state_root
must agree, and no future may be left unresolved.  The two engines
cross their links a different number of times, so a probabilistic
schedule differs between them; the lifecycle counters asserted are the
port's own.  Plus the link-error taxonomy and the scrub jitter
(tests/test_device_engine.py:764-858), the retry rule for in-place
kernels, and the sharded chaos smoke (tests/test_device_waves.py:765) on
devices=["cpu"] * 8.
"""

import numpy as np
import pytest
import torch

import tigerbeetle_tpu.state_machine.device_engine as ref_de
from tigerbeetle_tpu.state_machine.cpu import CpuStateMachine
from tigerbeetle_tpu.state_machine.tpu import TpuStateMachine
from tigerbeetle_tpu.testing import harness as ref_hz
from tigerbeetle_tpu.testing.chaos import ChaosLink as RefChaosLink
from tigerbeetle_tpu.testing.vopr import Workload
from tigerbeetle_tpu_torch import envcheck
from tigerbeetle_tpu_torch.state_machine import device_engine as de
from tigerbeetle_tpu_torch.state_machine.gpu import TorchStateMachine
from tigerbeetle_tpu_torch.state_machine.mirror import BalanceMirror
from tigerbeetle_tpu_torch.testing import harness as hz
from tigerbeetle_tpu_torch.testing.chaos import ChaosLink
from tigerbeetle_tpu_torch.types import EngineState, Operation


@pytest.fixture(autouse=True)
def _fast_lifecycle(monkeypatch):
    """Small window + no backoff sleeps + tight probe cadence, on both
    engines: the lifecycle spins fast enough for a `not slow` run."""
    for mod in (de, ref_de):
        monkeypatch.setattr(mod, "_WINDOW", 4)
        monkeypatch.setattr(mod, "_BACKOFF_MS", 0.0)
        monkeypatch.setattr(mod, "_PROBE_EVERY", 2)


class Trio:
    """The port, the reference and the oracle behind one fault script."""

    def __init__(self, seed=0, account_capacity=1 << 12, **chaos_kw):
        self.link = ChaosLink(seed=seed, **chaos_kw)
        self.ref_link = RefChaosLink(seed=seed, **chaos_kw)
        self.sm = TorchStateMachine(
            account_capacity=account_capacity, device="cpu", engine="device",
            device_link=self.link,
        )
        self.ref = TpuStateMachine(
            engine="device", account_capacity=account_capacity, device_link=self.ref_link
        )
        self.h = hz.SingleNodeHarness(self.sm)
        self.h_ref = ref_hz.SingleNodeHarness(self.ref)
        self.h_cpu = ref_hz.SingleNodeHarness(CpuStateMachine())

    @property
    def dev(self):
        return self.sm._dev

    def both_links(self, method, *args, **kw):
        getattr(self.link, method)(*args, **kw)
        getattr(self.ref_link, method)(*args, **kw)

    def submit(self, op, body):
        reply = self.h.submit(op, body)
        assert reply == self.h_ref.submit(op, body) == self.h_cpu.submit(op, body)
        return reply

    def replay(self, ops):
        """Pipelined on both engines; every future must terminate and
        every reply equal the reference's and the oracle's."""
        futs = [self.h.submit_async(op, body) for op, body in ops]
        ref_futs = [self.h_ref.submit_async(op, body) for op, body in ops]
        replies = [f.result() for f in futs]
        assert all(f.done() for f in futs)
        ref_replies = [f.result() for f in ref_futs]
        cpu_replies = [self.h_cpu.submit(op, body) for op, body in ops]
        for i, (a, b, c) in enumerate(zip(replies, ref_replies, cpu_replies)):
            assert a == b == c, f"reply {i} differs under chaos: {ops[i][0]!r}"
        return replies

    def check_roots(self):
        assert self.sm.state_root() == self.ref.state_root() == self.h_cpu.sm.state_root()


def accounts(ids, flags=0):
    return hz.pack([hz.account(i, flags=flags) for i in ids])


def transfers(rows):
    return hz.pack([hz.transfer(**r) for r in rows])


def simple_ops(n_batches=6, tid0=100):
    ops = [(Operation.create_accounts, accounts([1, 2, 3]))]
    tid = tid0
    for k in range(n_batches):
        rows = [
            dict(id=tid + j, debit_account_id=1 + (k + j) % 3,
                 credit_account_id=1 + (k + j + 1) % 3, amount=1 + j)
            for j in range(3)
        ]
        tid += 3
        ops.append((Operation.create_transfers, transfers(rows)))
    ops.append((Operation.lookup_accounts, hz.ids_bytes([1, 2, 3])))
    return ops


@pytest.mark.parametrize("stage", ["h2d", "dispatch", "fetch"])
def test_demote_at_every_stage_resolves_inflight(stage):
    """A fatal loss at each pipeline stage (upload, launch, ring fetch):
    every in-flight future resolves bit-identically by host replay, and
    the engine lands in a legal state."""
    t = Trio()
    ops = simple_ops()
    t.submit(*ops[0])
    t.both_links("fail_next", stage=stage, kind="fatal")
    t.replay(ops[1:])
    t.check_roots()
    dev = t.dev
    assert dev.stat_demotions >= 1
    assert not dev.has_inflight()
    if dev.state is EngineState.healthy:
        assert dev.stat_repromotions >= 1
    else:
        assert dev.state is EngineState.degraded


def test_transient_faults_retry_without_demotion():
    """Transient errors below the retry budget cost backoff only."""
    t = Trio()
    ops = simple_ops()
    t.submit(*ops[0])
    t.both_links("fail_next", kind="transient", count=2)
    t.replay(ops[1:])
    t.check_roots()
    dev = t.dev
    assert dev.state is EngineState.healthy
    assert dev.stat_retries >= 2
    assert dev.stat_demotions == 0


def test_retry_budget_exhaustion_demotes(monkeypatch):
    for mod in (de, ref_de):
        monkeypatch.setattr(mod, "_RETRIES", 2)
    t = Trio()
    ops = simple_ops()
    t.submit(*ops[0])
    # More consecutive transients than the budget: a device loss.
    t.both_links("fail_next", kind="transient", count=10)
    t.replay(ops[1:])
    t.check_roots()
    assert t.dev.stat_demotions >= 1
    assert t.dev.stat_retries >= 2


def test_degraded_serves_then_repromotes_with_handshake():
    """Kill -> exact degraded service with no crossing but the probes ->
    heal -> the probe cadence re-promotes through the handshake -> the
    device computes the codes again."""
    t = Trio()
    t.replay(simple_ops(n_batches=4))
    dev = t.dev
    sem_before = dev.stat_semantic_events
    assert sem_before > 0

    t.both_links("kill")
    t.replay(simple_ops(n_batches=6, tid0=500)[1:])
    assert dev.state is EngineState.degraded
    assert dev.stat_degraded_events > 0
    assert dev.read().device.type == "cpu"
    # Degraded: the link is crossed by the probes and nothing else.
    crossings, probes = t.link.crossings, dev.stat_probe_failures
    t.replay(simple_ops(n_batches=3, tid0=700)[1:])
    assert dev.stat_probe_failures > probes
    assert t.link.crossings - crossings == dev.stat_probe_failures - probes

    t.both_links("heal")
    t.replay(simple_ops(n_batches=8, tid0=900)[1:])
    t.check_roots()
    assert dev.state is EngineState.healthy
    assert dev.stat_demotions == 1
    assert dev.stat_repromotions == 1
    assert set(dev.last_repromotion) == {"probe_s", "upload_s", "rebuild_s", "handshake_s"}
    assert dev.stat_semantic_events > sem_before
    t.sm.verify_device_mirror()


def test_failed_probe_stays_degraded():
    """While the link is down, probes fail and the engine keeps serving
    degraded — never half-promoted."""
    t = Trio()
    t.both_links("kill")
    t.replay(simple_ops(n_batches=8))
    t.check_roots()
    dev = t.dev
    assert dev.state is EngineState.degraded
    assert dev.stat_probe_failures >= 1
    assert dev.stat_repromotions == 0


def test_scrub_heals_seeded_divergence(monkeypatch):
    """The scrub (K2 probe against the host twin) finds a corrupted
    balance word, names it with the full-table fetch and heals it by
    re-uploading from the mirror."""
    monkeypatch.setattr(de, "_SCRUB_EVERY", 1)
    monkeypatch.setattr(ref_de, "_SCRUB_EVERY", 1)
    t = Trio()
    t.replay(simple_ops(n_batches=2))
    dev = t.dev
    root = t.sm.state_root()
    dev.balances[0, 1] += 1  # a flipped word behind the engine's back
    with pytest.raises(AssertionError, match="divergence"):
        t.sm.verify_device_mirror()
    assert list(dev._localize_divergence()) == [0]
    heals = dev.stat_scrub_heals
    assert dev.scrub() is False
    assert dev.stat_scrub_heals == heals + 1 == 1
    assert t.sm.state_root() == root
    t.replay(simple_ops(n_batches=2, tid0=700)[1:])
    assert dev.stat_scrubs >= 1 and dev.stat_scrub_cheap >= 1
    t.sm.verify_device_mirror()
    t.check_roots()
    assert dev.state is EngineState.healthy


def test_scrub_heals_on_its_cadence(monkeypatch):
    """The same corruption left to the tick's own scrub."""
    monkeypatch.setattr(de, "_SCRUB_EVERY", 1)
    monkeypatch.setattr(ref_de, "_SCRUB_EVERY", 1)
    t = Trio()
    t.replay(simple_ops(n_batches=2))
    t.dev.balances[2, 2] += 5
    t.replay(simple_ops(n_batches=2, tid0=700)[1:])
    assert t.dev.stat_scrub_heals == 1
    t.sm.verify_device_mirror()
    t.check_roots()


def test_scrub_heals_meta_divergence(monkeypatch):
    """The scrub covers the account-meta table too: a flipped word heals
    by re-upload from the host copy."""
    monkeypatch.setattr(de, "_SCRUB_EVERY", 1)
    monkeypatch.setattr(ref_de, "_SCRUB_EVERY", 1)
    t = Trio()
    t.replay(simple_ops(n_batches=2))
    dev = t.dev
    dev.meta[1, 1] += 7
    t.replay(simple_ops(n_batches=2, tid0=800)[1:])
    t.check_roots()
    assert dev.stat_scrub_heals == 1
    assert (dev.meta.numpy().view(np.uint32) == dev._meta_host).all()
    assert dev.state is EngineState.healthy


@pytest.mark.parametrize("commit", ["0", "1"])
def test_scrub_without_commitment_uses_k11(monkeypatch, commit):
    """TB_STATE_COMMIT=0: the scrub compares the K11 digests of both
    tables against the host's (no K2 probe), and still heals."""
    monkeypatch.setenv("TB_STATE_COMMIT", commit)
    monkeypatch.setattr(de, "_SCRUB_EVERY", 1)
    sm = TorchStateMachine(account_capacity=1 << 12, device="cpu", engine="device")
    # Without the commitment the cadence stays the legacy 256 unless the
    # operator set it.
    assert sm._dev._scrub_every == (1 if commit == "1" else 256)
    monkeypatch.setattr(de, "_SCRUB_EVERY_SET", True)
    sm = TorchStateMachine(account_capacity=1 << 12, device="cpu", engine="device")
    assert sm._dev._scrub_every == 1
    h = hz.SingleNodeHarness(sm)
    [h.submit(op, body) for op, body in simple_ops(n_batches=2)]
    dev = sm._dev
    cheap = dev.stat_scrub_cheap
    assert dev.stat_scrubs > 0 and cheap == (dev.stat_scrubs if commit == "1" else 0)
    dev.balances[1, 3] += 9
    assert dev.scrub() is False
    assert dev.stat_scrub_heals == 1
    assert dev.stat_scrub_cheap - cheap == (1 if commit == "1" else 0)
    assert dev.scrub() is True
    sm.verify_device_mirror()


def test_deep_scrub_cadence_confirms_clean(monkeypatch):
    """TB_DEV_SCRUB_FALLBACK=1: every scrub also pays the full-table
    localization, which finds nothing to heal on clean tables."""
    monkeypatch.setenv("TB_DEV_SCRUB_FALLBACK", "1")
    sm = TorchStateMachine(account_capacity=1 << 12, device="cpu", engine="device")
    h = hz.SingleNodeHarness(sm)
    [h.submit(op, body) for op, body in simple_ops(n_batches=2)]
    dev = sm._dev
    assert dev.scrub() is True
    assert dev.stat_scrub_fallback == 1 and dev.stat_full_fetches == 1
    assert dev.stat_scrub_heals == 0 and dev.stat_commit_repairs == 0


def test_lookup_and_meta_resolve_under_loss():
    """Lookups and account-meta records in flight when the link dies
    resolve from the mirror, in stream order."""
    t = Trio()
    t.submit(Operation.create_accounts, accounts([1, 2]))
    t.both_links("fail_next", stage="fetch", kind="fatal")
    mixed = [
        (Operation.create_transfers, transfers(
            [dict(id=10, debit_account_id=1, credit_account_id=2, amount=5)])),
        (Operation.lookup_accounts, hz.ids_bytes([1, 2])),
        (Operation.create_accounts, accounts([7])),
        (Operation.create_transfers, transfers(
            [dict(id=11, debit_account_id=7, credit_account_id=2, amount=9)])),
        (Operation.lookup_accounts, hz.ids_bytes([1, 2, 7])),
    ]
    t.replay(mixed)
    t.check_roots()
    assert t.dev.stat_demotions >= 1


def test_grow_while_degraded_then_repromote():
    """Growth during an outage defers the device widen; the
    re-promotion upload rebuilds both tables at the grown capacity and
    passes the handshake."""
    t = Trio(account_capacity=64)
    t.submit(Operation.create_accounts, accounts(range(1, 33)))
    t.both_links("kill")
    t.submit(Operation.create_accounts, accounts(range(33, 161)))
    dev = t.dev
    tx = [
        (Operation.create_transfers, transfers(
            [dict(id=100 + k, debit_account_id=1 + k, credit_account_id=150 - k,
                  amount=2 + k)]))
        for k in range(4)
    ]
    t.replay(tx)
    assert dev.state is EngineState.degraded
    grown = dev.capacity
    assert grown >= 160
    assert int(dev.balances.shape[0]) < grown  # the widen waits
    t.both_links("heal")
    tail = [
        (Operation.create_transfers, transfers(
            [dict(id=200 + k, debit_account_id=10 + k, credit_account_id=120 + k,
                  amount=3 + k)]))
        for k in range(6)
    ]
    tail.append((Operation.lookup_accounts, hz.ids_bytes(list(range(1, 161)))))
    t.replay(tail)
    t.check_roots()
    assert dev.state is EngineState.healthy
    assert int(dev.balances.shape[0]) == grown
    t.sm.verify_device_mirror()


def test_close_terminates_every_future():
    """close() resolves (host replay) or fails (typed error) every
    outstanding future."""
    t = Trio()
    t.h.submit(Operation.create_accounts, accounts([1, 2]))
    body = transfers([dict(id=10, debit_account_id=1, credit_account_id=2, amount=5)])
    fut = t.h.submit_async(Operation.create_transfers, body)
    assert not fut.done()
    t.link.kill()
    t.dev.close()
    assert fut.done()
    assert fut.result() == b""  # resolved exactly by host replay
    assert t.dev.stat_demotions == 1


def test_close_fails_futures_when_replay_fails():
    """When even the host replay cannot run, close() fails the stranded
    futures with a typed DeviceLostError."""
    t = Trio()
    t.h.submit(Operation.create_accounts, accounts([1, 2]))
    body = transfers([dict(id=10, debit_account_id=1, credit_account_id=2, amount=5)])
    fut = t.h.submit_async(Operation.create_transfers, body)
    dev = t.dev

    def broken():
        raise RuntimeError("host replay unavailable")

    dev.drain = broken
    dev.close()
    assert fut.done()
    with pytest.raises(de.DeviceLostError, match="close"):
        fut.result()


def test_remove_accounts_queues_while_healthy_only():
    """remove_accounts (the reference's rollback hook) zeroes the host
    meta copy and, healthy, rides the stream as a meta record; degraded
    it touches only the host copy, which re-promotion uploads."""
    t = Trio()
    t.submit(Operation.create_accounts, accounts([1, 2, 3]))
    dev = t.dev
    dev.drain()
    dev.remove_accounts([2])
    assert (dev._meta_host[2] == 0).all()
    assert [(r.kind, list(r.meta_args[0])) for r in dev._pending] == [("meta", [2])]
    dev.drain()
    assert (dev.meta.numpy().view(np.uint32) == dev._meta_host).all()
    t.link.kill()
    assert dev.checksum() is not None  # the fetch fails: demoted
    assert dev.state is EngineState.degraded
    dev.remove_accounts([1])
    assert not dev._pending and (dev._meta_host[1] == 0).all()


def test_device_chaos_factory_seeds_each_machine():
    from tigerbeetle_tpu_torch.testing.chaos import device_chaos_factory

    factory, links = device_chaos_factory(7, account_capacity=64, device="cpu", p_fatal=0.5)
    a, b = factory(), factory()
    assert len(links) == 2 and a._dev.link is links[0] and b._dev.link is links[1]
    draws = [link.rng.random() for link in links]
    assert draws[0] != draws[1]


def test_reply_future_fail_is_typed():
    fut = de.ReplyFuture(None)
    with pytest.raises(de.DeviceLostError):
        fut.result()
    fut2 = de.ReplyFuture(None)
    fut2.fail(de.DeviceLostError("close", "boom"))
    assert fut2.done()
    with pytest.raises(de.DeviceLostError, match="close"):
        fut2.result()


def test_born_degraded_serves_then_repromotes():
    """A link already dead at construction: the engine is born degraded
    with CPU placeholder tables (counted as a demotion), serves
    exactly, and re-promotes once the link heals."""
    link = ChaosLink()
    link.kill()
    sm = TorchStateMachine(account_capacity=1 << 12, device="cpu", engine="device",
                           device_link=link)
    assert sm._dev.state is EngineState.degraded
    assert sm._dev.stat_demotions == 1 and sm._dev.last_demotion
    h = hz.SingleNodeHarness(sm)
    h_cpu = ref_hz.SingleNodeHarness(CpuStateMachine())
    ops = simple_ops(n_batches=3)
    assert [h.submit(*o) for o in ops] == [h_cpu.submit(*o) for o in ops]
    link.heal()
    ops = simple_ops(n_batches=4, tid0=400)[1:]
    assert [h.submit(*o) for o in ops] == [h_cpu.submit(*o) for o in ops]
    assert sm._dev.state is EngineState.healthy
    assert sm.state_root() == h_cpu.sm.state_root()
    sm.verify_device_mirror()


class LateErrorLink(de.DeviceLink):
    """Raises a transient-looking CUDA error AFTER the call ran, once:
    what a card's error reported at a later synchronisation looks
    like."""

    def __init__(self):
        self.armed = False

    def dispatch(self, fn, *args):
        out = fn(*args)
        if self.armed:
            self.armed = False
            raise RuntimeError("CUDA error: UNAVAILABLE: reported after the launch")
        return out


def test_error_after_a_launch_is_never_reissued():
    """The port's kernels write the tables in place: an error raised
    after a call ran must not reissue it (that would apply a batch
    twice); it demotes, and the replay from the mirror stays exact."""
    link = LateErrorLink()
    sm = TorchStateMachine(account_capacity=1 << 12, device="cpu", engine="device",
                           device_link=link)
    h = hz.SingleNodeHarness(sm)
    h_cpu = ref_hz.SingleNodeHarness(CpuStateMachine())
    ops = simple_ops(n_batches=6)
    h.submit(*ops[0])
    h_cpu.submit(*ops[0])
    link.armed = True
    futs = [h.submit_async(*o) for o in ops[1:]]
    assert [f.result() for f in futs] == [h_cpu.submit(*o) for o in ops[1:]]
    assert sm._dev.stat_retries == 0
    assert sm._dev.stat_demotions == 1
    assert sm.state_root() == h_cpu.sm.state_root()


def test_chaos_smoke_differential():
    """~1k seeded workload events through the device engine under
    probabilistic chaos at every stage — kills, fatal and transient
    faults — against the reference under its own schedule and the
    oracle; ends by healing and proving re-promotion passes the
    handshake."""
    wl = Workload(1234)
    t = Trio(seed=99, p_transient=0.02, p_fatal=0.004, p_kill=0.002, down_for=6)
    sent_events = 0
    ops = []
    while sent_events < 1000:
        operation, body, _must = wl.next_request()
        sent_events += 1 if not body else len(body) // 128
        ops.append((operation, body))
    t.replay(ops)
    t.check_roots()
    dev = t.dev
    assert dev.stat_demotions >= 1, "chaos never demoted: weak smoke"
    assert dev.stat_retries >= 1
    t.link.heal()
    t.link.p_transient = t.link.p_fatal = t.link.p_kill = 0.0
    assert dev.try_repromote()
    assert dev.state is EngineState.healthy
    t.sm.verify_device_mirror()
    t.ref_link.heal()
    t.ref_link.p_transient = t.ref_link.p_fatal = t.ref_link.p_kill = 0.0
    t.replay(simple_ops(n_batches=4, tid0=10_000_000))
    t.check_roots()


def test_demote_during_speculation_releases_whole_batch_bound(monkeypatch):
    """A speculative record's admission charge is the whole-batch bound:
    a loss with speculative batches in flight replays them through the
    host fallback, the bound releases exactly once, and later batches
    admit against the true mirror headroom."""
    monkeypatch.setenv("TB_WAVES_SPECULATE", "force")
    t = Trio()
    t.submit(Operation.create_accounts, accounts(range(1, 21)))
    t.both_links("fail_next", stage="dispatch", kind="fatal")
    mixed = []
    tid = 100
    for k in range(6):
        rows = [
            dict(id=tid + j, debit_account_id=1 + (k + j) % 20,
                 credit_account_id=1 + (k + j + 1) % 20, amount=(1 << 40) + j)
            for j in range(4)
        ]
        tid += 4
        mixed.append((Operation.create_transfers, transfers(rows)))
    mixed.append((Operation.lookup_accounts, hz.ids_bytes(list(range(1, 21)))))
    t.replay(mixed)
    dev = t.dev
    assert dev.stat_demotions >= 1, "fault never hit a record in flight"
    assert dev.inflight_bound() == 0
    t.both_links("heal")
    tail = [
        (Operation.create_transfers, transfers(
            [dict(id=900 + k, debit_account_id=1 + k, credit_account_id=2 + k, amount=7)]))
        for k in range(4)
    ]
    t.replay(tail)
    t.check_roots()
    assert dev.inflight_bound() == 0
    t.sm.verify_device_mirror()


# ---------------------------------------------------------------------------
# The link-error taxonomy.


def _status_message(marker: str) -> str:
    return f"RuntimeError: {marker}: failure while copying a buffer device to host"


N_REF_ROWS = len(ref_de.LINK_ERROR_MARKERS)


def test_reference_rows_come_first_in_order():
    assert de.LINK_ERROR_MARKERS[:N_REF_ROWS] == ref_de.LINK_ERROR_MARKERS


@pytest.mark.parametrize("marker,expected", list(de.LINK_ERROR_MARKERS))
def test_link_error_marker_classification(marker, expected):
    assert de.classify_link_error(RuntimeError(_status_message(marker))) == expected


@pytest.mark.parametrize("message", [
    # kernels._launch's text for a launch that failed to allocate
    "tb_orderfree: CUDA error 2 (out of memory)",
    # torch.cuda.OutOfMemoryError's text
    "CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a total capacity of 79.19 GiB",
])
def test_appended_row_out_of_memory_is_transient(message):
    assert ("out of memory", "transient") in de.LINK_ERROR_MARKERS[N_REF_ROWS:]
    assert de.classify_link_error(RuntimeError(message)) == "transient"


def test_sticky_cuda_errors_are_fatal():
    for message in ("tb_linked: CUDA error 700 (an illegal memory access was encountered)",
                    "CUDA error: unspecified launch failure"):
        assert de.classify_link_error(RuntimeError(message)) == "fatal"


def test_link_error_first_match_wins_and_default_fatal():
    assert de.classify_link_error(de.TransientLinkError("x")) == "transient"
    assert de.classify_link_error(de.FatalLinkError("x")) == "fatal"
    assert de.classify_link_error(de.DeviceLostError("fetch")) == "fatal"
    assert de.classify_link_error(RuntimeError("segfault in plugin")) == "fatal"
    both = RuntimeError(_status_message("UNAVAILABLE") + " INTERNAL")
    assert de.classify_link_error(both) == "transient"


def test_link_error_taxonomy_is_declarative():
    kinds = {kind for _m, kind in de.LINK_ERROR_MARKERS}
    assert kinds == {"transient", "fatal"}
    markers = [m for m, _k in de.LINK_ERROR_MARKERS]
    assert len(markers) == len(set(markers)), "duplicate marker rows"


def test_allocation_failure_retries_on_the_link():
    """A transient text raised by the link before the call (an upload
    that could not allocate) is reissued, not demoted."""

    class OomOnce(de.DeviceLink):
        def __init__(self):
            self.left = 1

        def device_put(self, array, device):
            if self.left:
                self.left -= 1
                raise RuntimeError("CUDA out of memory. Tried to allocate 64.00 MiB")
            return super().device_put(array, device)

    link = OomOnce()
    sm = TorchStateMachine(account_capacity=1 << 12, device="cpu", engine="device",
                           device_link=link)
    assert sm._dev.state is EngineState.healthy
    assert sm._dev.stat_retries == 1 and sm._dev.stat_link_errors == 1


@pytest.mark.parametrize("exc, fault", [
    (de.TransientLinkError("injected"), True),
    (de.FatalLinkError("link down"), True),
    (RuntimeError("tb_orderfree: CUDA error 700 (an illegal memory access was encountered)"),
     True),
    (RuntimeError("CUDA error: an illegal memory access was encountered"), True),
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 64.00 MiB"), True),
    (RuntimeError("UNAVAILABLE: a status text alone"), False),
    (ValueError("index out of range"), False),
    (IndexError("slot past the table"), False),
    (OSError("libtb_orderfree.so: cannot open shared object file"), False),
])
def test_only_link_faults_are_the_links(exc, fault):
    """A LinkError or a CUDA runtime error is the link's; a build or
    load failure, a wrong argument or a plain bug is not."""
    from tigerbeetle_tpu_torch.kernels.build import KernelBuildError

    assert de.is_link_fault(exc) is fault
    assert not de.is_link_fault(KernelBuildError("nvcc orderfree.cu (rc 1)"))


class BuggyLink(de.DeviceLink):
    """Its launches raise what a bug in a wrapper or a plain version
    raises, once armed."""

    def __init__(self):
        self.armed = False

    def dispatch(self, fn, *args):
        if self.armed:
            self.armed = False
            raise IndexError("a bug inside a wrapper")
        return fn(*args)


def test_error_that_is_not_the_links_raises_and_never_demotes():
    """An error that is not a link fault reaches the caller as it was
    raised: no retry, no demotion, no host replay hiding it."""
    link = BuggyLink()
    sm = TorchStateMachine(account_capacity=1 << 12, device="cpu", engine="device",
                           device_link=link)
    h = hz.SingleNodeHarness(sm)
    ops = simple_ops(n_batches=3)
    h.submit(*ops[0])
    link.armed = True
    with pytest.raises(IndexError, match="a bug inside a wrapper"):
        for o in ops[1:]:
            h.submit(*o)
    assert sm._dev.state is EngineState.healthy
    assert sm._dev.stat_demotions == 0
    assert sm._dev.stat_link_errors == 0 and sm._dev.stat_retries == 0


def test_kernel_build_failure_raises_before_any_crossing(monkeypatch):
    """A card engine builds and loads every kernel library before its
    first crossing: a failed build raises there and is never taken for a
    lost link (no engine is born degraded for it)."""
    from tigerbeetle_tpu_torch import kernels
    from tigerbeetle_tpu_torch.kernels.build import KernelBuildError

    class Counting(de.DeviceLink):
        crossings = 0

        def device_put(self, array, device):
            Counting.crossings += 1
            return super().device_put(array, device)

        def dispatch(self, fn, *args):
            Counting.crossings += 1
            return fn(*args)

    def refuse():
        raise KernelBuildError("nvcc orderfree.cu (rc 1): error")

    monkeypatch.setattr(kernels, "load_all", refuse)
    with pytest.raises(KernelBuildError, match="orderfree"):
        de.DeviceEngine(64, BalanceMirror(64), torch.device("cuda"), link=Counting())
    assert Counting.crossings == 0


# ---------------------------------------------------------------------------
# Healthy-mode scrub jitter.


def test_scrub_offset_deterministic_and_bounded(monkeypatch):
    monkeypatch.setattr(de, "_SCRUB_EVERY", 256)
    monkeypatch.setattr(de, "_SCRUB_JITTER", -1)  # auto: every // 8

    def offset(seed):
        return de.DeviceEngine(64, BalanceMirror(64), torch.device("cpu"), seed=seed)._scrub_offset

    assert offset(7) == offset(7)
    cap = envcheck.scrub_jitter_cap(256, -1)
    assert cap == 32
    offsets = {offset(s) for s in range(40)}
    assert all(0 <= o <= cap for o in offsets)
    assert len(offsets) > 1, "offsets never vary: jitter is vacuous"
    defaults = {
        de.DeviceEngine(64, BalanceMirror(64), torch.device("cpu"))._scrub_offset
        for _ in range(8)
    }
    assert len(defaults) > 1, "same-capacity engines share one offset"
    # The same offsets as the reference's engine for the same seeds.
    monkeypatch.setattr(ref_de, "_SCRUB_EVERY", 256)
    monkeypatch.setattr(ref_de, "_SCRUB_JITTER", -1)
    from tigerbeetle_tpu.state_machine.mirror import BalanceMirror as RefMirror

    for s in (0, 7, 12345):
        assert offset(s) == ref_de.DeviceEngine(64, RefMirror(64), seed=s)._scrub_offset


def test_scrub_jitter_shifts_first_scrub(monkeypatch):
    """The first scrub fires TB_DEV_SCRUB_EVERY - offset fetches in; the
    next ones keep the full cadence."""
    monkeypatch.setattr(de, "_SCRUB_EVERY", 16)
    monkeypatch.setattr(de, "_SCRUB_JITTER", 5)
    eng = de.DeviceEngine(64, BalanceMirror(64), torch.device("cpu"), seed=3)
    off = eng._scrub_offset
    assert 0 <= off <= 5
    scrubbed = []
    real_scrub = eng.scrub

    def counting_scrub():
        scrubbed.append(eng.stat_fetches)
        return real_scrub()

    eng.scrub = counting_scrub
    for fetch in range(1, 64):
        eng.stat_fetches = fetch
        eng.tick()
    assert scrubbed, "scrub never fired"
    assert scrubbed[0] == 16 - off
    if len(scrubbed) > 1:
        assert scrubbed[1] - scrubbed[0] == 16


def test_scrub_jitter_disabled_when_zero(monkeypatch):
    monkeypatch.setattr(de, "_SCRUB_EVERY", 256)
    monkeypatch.setattr(de, "_SCRUB_JITTER", 0)
    eng = de.DeviceEngine(64, BalanceMirror(64), torch.device("cpu"), seed=12345)
    assert eng._scrub_offset == 0


def test_link_knobs_validate(monkeypatch):
    monkeypatch.setenv("TB_DEV_SCRUB_EVERY", "4")
    monkeypatch.setenv("TB_DEV_SCRUB_JITTER", "4")
    with pytest.raises(envcheck.EnvVarError, match="TB_DEV_SCRUB_JITTER"):
        envcheck.validate_scrub_jitter(envcheck.dev_scrub_every(), envcheck.dev_scrub_jitter())
    monkeypatch.setenv("TB_DEV_RETRIES", "-1")
    with pytest.raises(envcheck.EnvVarError, match="TB_DEV_RETRIES"):
        envcheck.dev_retries()
    monkeypatch.delenv("TB_DEV_SCRUB_EVERY")
    monkeypatch.setenv("TB_DEV_PROBE_EVERY", "5")
    assert envcheck.dev_scrub_every() == 5  # the cadence follows the probe's
    assert envcheck.scrub_fallback_every() == 0


# ---------------------------------------------------------------------------
# The row-sharded engine under chaos.


def test_sharded_chaos_smoke_with_waves_on(monkeypatch):
    """Link chaos on the row-sharded engine (devices=["cpu"] * 8) with
    wave dispatch forced on: demote / serve degraded / re-promote keep
    every reply oracle-identical, and equal to the reference's sharded
    engine under the same scripted faults."""
    from test_device_waves import _fuzz_stream

    monkeypatch.setenv("TB_DEV_WAVES", "1")
    link = ChaosLink(seed=23, p_transient=0.05)
    ref_link = RefChaosLink(seed=23, p_transient=0.05)
    sm = TorchStateMachine(account_capacity=1 << 10, device="cpu", engine="device",
                           devices=["cpu"] * 8, device_link=link)
    ref = TpuStateMachine(engine="device", account_capacity=1 << 10, device_link=ref_link)
    assert sm._dev.sharding is not None and ref._dev.sharding is not None
    h, h_ref = hz.SingleNodeHarness(sm), ref_hz.SingleNodeHarness(ref)
    h_cpu = ref_hz.SingleNodeHarness(CpuStateMachine())
    ops = _fuzz_stream(np.random.default_rng(5), n_accts=40)
    futs, ref_futs = [], []
    for k, (op, body) in enumerate(ops):
        if k in (len(ops) // 3, 2 * len(ops) // 3):
            link.fail_next(kind="fatal")
            ref_link.fail_next(kind="fatal")
        futs.append(h.submit_async(op, body))
        ref_futs.append(h_ref.submit_async(op, body))
    replies = [f.result() for f in futs]
    assert all(f.done() for f in futs)
    ref_replies = [f.result() for f in ref_futs]
    cpu_replies = [h_cpu.submit(op, body) for op, body in ops]
    mismatches = [i for i, (a, b, c) in enumerate(zip(replies, ref_replies, cpu_replies))
                  if not a == b == c]
    assert not mismatches, f"replies diverge at {mismatches[:5]}"
    assert sm.state_root() == ref.state_root() == h_cpu.sm.state_root()
    dev = sm._dev
    assert dev.stat_demotions >= 1, "chaos never demoted: weak smoke"
    link.heal()
    link.p_transient = 0.0
    assert dev.try_repromote()
    assert dev.state is EngineState.healthy
    assert dev.sharding is not None
    sm.verify_device_mirror()

"""The port's observability: flight recorder, stats scrape, tracer knob,
registry, and TorchStateMachine's metrics registry.

- tests/test_obs.py's cases that need no router, follower, VOPR
  workload or wall-clock bound, re-pointed at the port
  (tests/torch_repoint.py): tracer and histogram exactness, registry
  composition, the stats scrape under concurrent load and its reply
  codec, the stats op never entering consensus, the flight dump's
  embedded snapshot, the TB_TRACE and TB_METRICS knobs.  Each runs on
  the port and on the reference.
- TorchStateMachine.metrics against TpuStateMachine.metrics on the same
  stream, each engine: the same counter names (device_events ...
  dev_wave.plan_s, the dev_wave.plan_us histogram, the decline and punt
  counters) with the same values, and the device engine's counters
  under "dev." that the port lists (the reference's engine registry
  also holds link and scrub latency histograms the port does not keep).
- A ReplicaServer grafts the machine's registry in under "sm.": the
  stats scrape of a port server lists them.
"""

import numpy as np
import pytest

import torch_repoint as rp
from tigerbeetle_tpu.state_machine.tpu import TpuStateMachine
from tigerbeetle_tpu.testing import harness as ref_hz
from tigerbeetle_tpu_torch.state_machine.gpu import TorchStateMachine
from tigerbeetle_tpu_torch.testing import harness as hz
from tigerbeetle_tpu_torch.types import Operation, TransferFlags
from torch_link_quiet import link_quiet  # noqa: F401  (autouse: no engine lost its link)

OBS_CASES = [
    ("test_tracer_double_start_asserts", {}),
    ("test_tracer_unbalanced_end_asserts", {}),
    ("test_tracer_dump_refuses_open_spans", {}),
    ("test_tracer_buffer_drop_accounting", {}),
    *[("test_histogram_percentiles_match_sorted_oracle", {"seed": s}) for s in (1, 2, 3, 4)],
    ("test_histogram_bucket_arithmetic_is_consistent", {}),
    ("test_histogram_empty_and_single", {}),
    *[("test_histogram_unit_scale_resolves_sub_unit_floor", {"seed": s}) for s in (5, 6)],
    ("test_histogram_unit_scale_must_agree_across_registrations", {}),
    ("test_registry_scope_and_attach_compose_one_snapshot", {}),
    ("test_registry_rejects_kind_confusion", {}),
    ("test_stat_property_compat_reads_and_resets", {}),
    ("test_snapshot_version_changes_with_any_counter", {}),
    ("test_disabled_tracer_span_is_shared_noop", {}),
    ("test_disabled_histogram_is_shared_noop", {}),
    ("test_stats_scrape_monotonic_under_concurrent_load", {}),
    ("test_stats_reply_roundtrips_snapshot", {}),
    ("test_server_stats_op_never_enters_consensus", {}),
    ("test_tb_metrics_env_plumbs_to_state_machine", {}),
    ("test_flight_dump_embeds_stats_snapshot", {}),
    ("test_tb_trace_env_selects_backend", {}),
]


@pytest.mark.parametrize(
    "case,params", OBS_CASES,
    ids=[c[5:] + "".join(f"-{k}{v}" for k, v in p.items()) for c, p in OBS_CASES],
)
def test_repointed_case_matches_reference(case, params, tmp_path):
    rp.run_both("test_obs.py", case, "oracle", tmp_path, dict(params))


CAPACITY = (1 << 10) + 3


def _stream(h, m):
    """Order-free batches, a linked chain, pendings and their posts."""
    L, P, POST = (int(TransferFlags.linked), int(TransferFlags.pending),
                  int(TransferFlags.post_pending_transfer))
    h.submit(Operation.create_accounts, m.pack([m.account(i) for i in range(1, 41)]))
    rng = np.random.default_rng(9)
    tid = 1000
    for _ in range(5):
        rows = []
        for _ in range(60):
            dr, cr = (int(x) for x in rng.choice(np.arange(1, 43), 2, replace=False))
            rows.append(m.transfer(tid, debit_account_id=dr, credit_account_id=cr,
                                   amount=int(rng.integers(1, 100))))
            tid += 1
        h.submit(Operation.create_transfers, m.pack(rows))
    chain = [m.transfer(tid + j, debit_account_id=1 + j, credit_account_id=2 + j, amount=5,
                        flags=L if j < 3 else 0) for j in range(4)]
    h.submit(Operation.create_transfers, m.pack(chain))
    tid += 10
    pend = [m.transfer(tid + j, debit_account_id=5 + j, credit_account_id=6 + j, amount=7,
                       flags=P) for j in range(8)]
    h.submit(Operation.create_transfers, m.pack(pend))
    posts = [m.transfer(tid + 100 + j, pending_id=tid + j, amount=7, flags=POST)
             for j in range(8)]
    h.submit(Operation.create_transfers, m.pack(posts))


def _comparable(snap, dev_names):
    """The counters (timing-derived values, the version and the port's
    own gauges of kernel launches and card memory aside; of the "dev."
    names, those in `dev_names`)."""
    out = {}
    for key, value in snap.items():
        if key == "version" or key.endswith("_s") or key.startswith(("launches.", "card.")):
            continue
        if key.startswith("dev.") and key not in dev_names:
            continue
        if key.endswith(("_us.p50", "_us.p99", "_us.p999", "_us.max", "_us.sum")):
            continue
        out[key] = value
    return out


@pytest.mark.parametrize("engine", ["host", "device"])
def test_machine_metrics_equal_reference(engine, monkeypatch):
    for package in (rp.PORT, rp.REF):
        rp.first_engine_ordinal(package, monkeypatch)
    sm = TorchStateMachine(account_capacity=CAPACITY, device="cpu", engine=engine)
    ref = TpuStateMachine(account_capacity=CAPACITY, engine=engine)
    _stream(hz.SingleNodeHarness(sm), hz)
    _stream(ref_hz.SingleNodeHarness(ref), ref_hz)
    ref.sync()
    sm._engine_drain()
    snap = sm.metrics.snapshot()
    dev_names = {key for key in snap if key.startswith("dev.")}
    assert bool(dev_names) == (engine == "device")
    got, want = _comparable(snap, dev_names), _comparable(ref.metrics.snapshot(), dev_names)
    assert got == want
    assert got["linked_batches"] >= 1 and got["two_phase_batches"] >= 1
    assert "dev_wave.plan_us.count" in got
    # The stat_* compatibility properties read and reset the registry.
    assert sm.stat_linked_batches == got["linked_batches"]
    sm.stat_linked_batches = 0
    assert sm.metrics.snapshot()["linked_batches"] == 0


def test_server_scrape_lists_machine_metrics(tmp_path):
    """The port's server grafts TorchStateMachine.metrics under "sm."."""
    import threading

    from tigerbeetle_tpu_torch import constants as cfg
    from tigerbeetle_tpu_torch.client import Client
    from tigerbeetle_tpu_torch.obs.scrape import scrape_stats
    from tigerbeetle_tpu_torch.runtime.server import ReplicaServer, format_data_file

    path = str(tmp_path / "r0.tb")
    format_data_file(path, cluster=17, config=cfg.TEST_MIN)
    server = ReplicaServer(
        path, cluster=17, addresses=["127.0.0.1:0"], replica_index=0,
        state_machine_factory=lambda: TorchStateMachine(
            cfg.TEST_MIN, account_capacity=CAPACITY, transfer_capacity=CAPACITY, device="cpu",
            engine="host"),
        config=cfg.TEST_MIN,
    )
    stop = threading.Event()
    loop = threading.Thread(target=lambda: [server.poll_once(1) for _ in iter(
        lambda: not stop.is_set(), False)], daemon=True)
    loop.start()
    try:
        address = f"127.0.0.1:{server.port}"
        client = Client(address, 17, client_id=91, timeout_ms=30_000)
        assert client.create_accounts([{"id": 1, "ledger": 1, "code": 1},
                                       {"id": 2, "ledger": 1, "code": 1}]) == []
        assert client.create_transfers([{"id": 9, "debit_account_id": 1,
                                         "credit_account_id": 2, "amount": 1,
                                         "ledger": 1, "code": 1}]) == []
        client.close()
        snap = scrape_stats(address, 17, timeout_ms=10_000)
    finally:
        stop.set()
        loop.join(timeout=5)
        server.close()
    assert snap["sm.device_events"] + snap["sm.exact_events"] == 1
    assert "sm.dev_wave.plan_us.count" in snap

"""Benchmark driver + load generator (reference:
src/tigerbeetle/benchmark_driver.zig, benchmark_load.zig).

With no --addresses, formats a temp single-replica data file and runs
the server in-process on a background thread (the reference spawns a
temp cluster the same way), then streams `create_transfers` batches
through the real client/wire/VSR/state-machine stack and reports
throughput and batch-latency percentiles.

This package's own copy of ``tigerbeetle_tpu/benchmark.py``.  The
in-process replica is the CLI's: ``TorchStateMachine`` on the first CUDA
card, or the port's oracle under ``--cpu``; without a card and without
``--cpu`` the CLI exits non-zero and says so.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time

import numpy as np

from tigerbeetle_tpu_torch import constants as cfg


def run_benchmark(*, addresses: str | None, cluster: int, n_transfers: int,
                  n_accounts: int, batch: int, use_cpu: bool,
                  seed: int = 42, statsd_port: int | None = None) -> dict:
    from tigerbeetle_tpu_torch.client import Client

    server = None
    thread = None
    tmp = None
    if addresses is None:
        from tigerbeetle_tpu_torch.cli import _sm_factory
        from tigerbeetle_tpu_torch.runtime.server import (
            ReplicaServer,
            format_data_file,
        )

        tmp = tempfile.TemporaryDirectory(prefix="tb_bench_")
        path = os.path.join(tmp.name, "bench.tigerbeetle")
        format_data_file(path, cluster=cluster)
        server = ReplicaServer(
            path, cluster=cluster, addresses=["127.0.0.1:0"], replica_index=0,
            state_machine_factory=_sm_factory(use_cpu),
        )
        address = f"127.0.0.1:{server.port}"
        server._stop = False

        def loop():
            while not server._stop:
                server.poll_once(timeout_ms=1)

        thread = threading.Thread(target=loop, daemon=True)
        thread.start()
    else:
        address = addresses.split(",")[0]

    try:
        client = Client(address, cluster, timeout_ms=120_000)
        rng = np.random.default_rng(seed)

        # Accounts.
        for at in range(0, n_accounts, batch):
            n = min(batch, n_accounts - at)
            client.create_accounts(
                [{"id": at + i + 1, "ledger": 1, "code": 1} for i in range(n)]
            )

        # Transfer batches, pre-generated (generation isn't timed).
        from tigerbeetle_tpu_torch.types import TRANSFER_DTYPE

        batches = []
        next_id = 1_000_000
        remaining = n_transfers
        while remaining > 0:
            n = min(batch, remaining)
            arr = np.zeros(n, TRANSFER_DTYPE)
            arr["id_lo"] = np.arange(next_id, next_id + n, dtype=np.uint64)
            dr = rng.integers(1, n_accounts + 1, n, np.uint64)
            arr["debit_account_id_lo"] = dr
            arr["credit_account_id_lo"] = dr % np.uint64(n_accounts) + np.uint64(1)
            arr["amount_lo"] = rng.integers(1, 100, n, np.uint64)
            arr["ledger"] = 1
            arr["code"] = 1
            batches.append(arr)
            next_id += n
            remaining -= n

        latencies = []
        t0 = time.perf_counter()
        for arr in batches:
            b0 = time.perf_counter()
            results = client.create_transfers(arr)
            assert not results, results[:3]
            latencies.append(time.perf_counter() - b0)
        elapsed = time.perf_counter() - t0

        # Query latency (devhub tracks query p100 alongside load tx/s —
        # reference: src/scripts/devhub.zig:36-41).
        query_lat = []
        q_ids = [int(i) for i in rng.integers(1, n_accounts + 1, 100)]
        for _ in range(20):
            q0 = time.perf_counter()
            rows = client.lookup_accounts(q_ids)
            assert len(rows) == len(q_ids)  # one row per requested id
            query_lat.append(time.perf_counter() - q0)
        client.close()

        lat = np.sort(np.array(latencies))
        pct = lambda p: float(lat[min(len(lat) - 1, int(p / 100 * len(lat)))])
        result = {
            "transfers": n_transfers,
            "transfers_per_second": round(n_transfers / elapsed, 1),
            "batch": batch,
            "batch_latency_p50_ms": round(pct(50) * 1e3, 3),
            "batch_latency_p99_ms": round(pct(99) * 1e3, 3),
            "batch_latency_p100_ms": round(float(lat[-1]) * 1e3, 3),
            "query_latency_p100_ms": round(max(query_lat) * 1e3, 3),
        }
        if statsd_port is not None:
            # reference: src/tigerbeetle/benchmark_load.zig:360-380
            # optional StatsD emit of the same metrics.
            from tigerbeetle_tpu_torch.utils.statsd import StatsD

            s = StatsD(port=statsd_port, prefix="benchmark")
            s.gauge("load_accepted_tx_per_s", result["transfers_per_second"])
            s.timing("batch_p100_ms", result["batch_latency_p100_ms"])
            s.timing("batch_p99_ms", result["batch_latency_p99_ms"])
            s.timing("query_p100_ms", result["query_latency_p100_ms"])
            s.close()
        return result
    finally:
        if server is not None:
            server._stop = True
            thread.join(timeout=5)
            server.close()
        if tmp is not None:
            tmp.cleanup()

"""The port's benchmark, bindings, REPL and trace-demo commands against
the reference's, beyond the re-pointed cases (tests/test_torch_tools.py).

- `bindings.generate` of the port writes files byte-equal to the
  reference's, and the port's C header compiles together with the port's
  own runtime library source (csrc/host/tb_runtime.cpp).
- `run_benchmark(addresses=...)` against a single-replica ReplicaServer
  of each package, the clock pinned, over TorchStateMachine(device="cpu")
  and TpuStateMachine on each engine (and the two oracles): every
  account's row afterwards is byte-equal between the packages, and its
  posted balances equal numpy sums of the benchmark's generator rebuilt
  from its seed.  The StatsD metrics of both runs carry the same names.
- The CLI: `benchmark` without a card and without `--cpu` exits non-zero
  and names the card; `repl --command` against a port server prints the
  account; `bindings --out` and `trace-demo --out` write their files.
"""

import filecmp
import json
import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_repoint as rp
from test_torch_server import _serve, pinned_time  # noqa: F401  (pinned_time: a fixture)

REPO = Path(__file__).resolve().parent.parent
CLUSTER = 5
CAPACITY = (1 << 12) + 3
N_ACCOUNTS, N_TRANSFERS, BATCH, SEED = 50, 3000, 500, 42


def test_bindings_generate_byte_equal_to_reference(tmp_path):
    from tigerbeetle_tpu import bindings as ref_bindings
    from tigerbeetle_tpu_torch import bindings

    got = bindings.generate(str(tmp_path / "port"))
    want = ref_bindings.generate(str(tmp_path / "ref"))
    assert [Path(p).name for p in got] == [Path(p).name for p in want]
    for a, b in zip(got, want):
        assert filecmp.cmp(a, b, shallow=False), Path(a).name


def test_port_header_compiles_with_port_runtime(tmp_path):
    from tigerbeetle_tpu_torch import bindings

    if shutil.which("g++") is None:
        pytest.skip("no C++ compiler on this host")
    header = next(p for p in bindings.generate(str(tmp_path)) if p.endswith("tb_types.h"))
    runtime = REPO / "tigerbeetle_tpu_torch" / "csrc" / "host" / "tb_runtime.cpp"
    both = tmp_path / "abi_check.cpp"
    both.write_text(f'#include "{header}"\n#include "{runtime}"\n')
    subprocess.run(["g++", "-std=c++17", "-fsyntax-only", str(both)],
                   check=True, capture_output=True)


def _machine(package, kind):
    if package == rp.PORT:
        from tigerbeetle_tpu_torch import constants as cfg
        from tigerbeetle_tpu_torch.state_machine import CpuStateMachine
        from tigerbeetle_tpu_torch.state_machine.gpu import TorchStateMachine

        if kind == "oracle":
            return lambda: CpuStateMachine(cfg.PRODUCTION)
        return lambda: TorchStateMachine(cfg.PRODUCTION, account_capacity=CAPACITY,
                                         transfer_capacity=CAPACITY, device="cpu", engine=kind)
    from tigerbeetle_tpu import constants as cfg
    from tigerbeetle_tpu.state_machine import CpuStateMachine
    from tigerbeetle_tpu.state_machine.tpu import TpuStateMachine

    if kind == "oracle":
        return lambda: CpuStateMachine(cfg.PRODUCTION)
    return lambda: TpuStateMachine(cfg.PRODUCTION, account_capacity=CAPACITY,
                                   transfer_capacity=CAPACITY, engine=kind)


def _benchmark_run(package, kind, tmp_path):
    """The package's run_benchmark against its own server; -> (account
    rows, StatsD metric names)."""
    import importlib

    server_mod = importlib.import_module(f"{package}.runtime.server")
    bench = importlib.import_module(f"{package}.benchmark")
    client_mod = importlib.import_module(f"{package}.client")
    path = str(tmp_path / f"{package}-{kind}.tb")
    server_mod.format_data_file(path, cluster=CLUSTER)
    server = server_mod.ReplicaServer(
        path, cluster=CLUSTER, addresses=["127.0.0.1:0"], replica_index=0,
        state_machine_factory=_machine(package, kind),
    )
    close = _serve(server)
    statsd = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    statsd.bind(("127.0.0.1", 0))
    statsd.settimeout(5)
    try:
        result = bench.run_benchmark(
            addresses=f"127.0.0.1:{server.port}", cluster=CLUSTER, n_transfers=N_TRANSFERS,
            n_accounts=N_ACCOUNTS, batch=BATCH, use_cpu=True, seed=SEED,
            statsd_port=statsd.getsockname()[1],
        )
        assert result["transfers"] == N_TRANSFERS
        names = sorted(statsd.recv(512).decode().split(":")[0] for _ in range(4))
        c = client_mod.Client(f"127.0.0.1:{server.port}", CLUSTER, client_id=77)
        rows = [bytes(r) for r in c.lookup_accounts(list(range(1, N_ACCOUNTS + 1)))]
        c.close()
    finally:
        statsd.close()
        close()
    return rows, names


def _expected_posted():
    """Posted debits and credits per account, from benchmark.py's
    generator rebuilt from its seed (accounts are created first and
    draw nothing from the generator)."""
    rng = np.random.default_rng(SEED)
    debits = np.zeros(N_ACCOUNTS + 1, np.int64)
    credits = np.zeros(N_ACCOUNTS + 1, np.int64)
    remaining = N_TRANSFERS
    while remaining > 0:
        n = min(BATCH, remaining)
        dr = rng.integers(1, N_ACCOUNTS + 1, n, np.uint64)
        cr = dr % np.uint64(N_ACCOUNTS) + np.uint64(1)
        amount = rng.integers(1, 100, n, np.uint64)
        np.add.at(debits, dr.astype(np.int64), amount.astype(np.int64))
        np.add.at(credits, cr.astype(np.int64), amount.astype(np.int64))
        remaining -= n
    return debits[1:], credits[1:]


@pytest.mark.parametrize("kind", ["oracle", "host", "device"])
def test_benchmark_rows_match_reference(kind, tmp_path, pinned_time):
    from tigerbeetle_tpu_torch import types

    rp.reference_native_loaded()
    got, got_names = _benchmark_run(rp.PORT, kind, tmp_path)
    want, want_names = _benchmark_run(rp.REF, kind, tmp_path)
    assert got == want
    assert got_names == want_names == [
        "benchmark.batch_p100_ms", "benchmark.batch_p99_ms",
        "benchmark.load_accepted_tx_per_s", "benchmark.query_p100_ms",
    ]
    rows = np.frombuffer(b"".join(got), types.ACCOUNT_DTYPE)
    debits, credits = _expected_posted()
    assert [types.u128_get(r, "debits_posted") for r in rows] == debits.tolist()
    assert [types.u128_get(r, "credits_posted") for r in rows] == credits.tolist()
    assert debits.sum() == credits.sum() > 0


def _env(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env["TB_FLIGHT_PATH"] = str(tmp_path / "flight.json")
    return env


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the card-less refusal")
def test_cli_benchmark_without_card_names_it(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "tigerbeetle_tpu_torch", "benchmark", "--transfers=10",
         "--accounts=4"],
        cwd=REPO, env=_env(tmp_path), capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert "no CUDA card" in out.stderr and "--cpu" in out.stderr
    assert "transfers_per_second" not in out.stdout


def test_cli_repl_bindings_and_trace_demo(tmp_path):
    from tigerbeetle_tpu_torch import constants as cfg
    from tigerbeetle_tpu_torch.client import Client
    from tigerbeetle_tpu_torch.runtime.server import ReplicaServer, format_data_file
    from tigerbeetle_tpu_torch.state_machine import CpuStateMachine

    path = str(tmp_path / "repl.tb")
    format_data_file(path, cluster=CLUSTER, config=cfg.TEST_MIN)
    server = ReplicaServer(
        path, cluster=CLUSTER, addresses=["127.0.0.1:0"], replica_index=0,
        state_machine_factory=lambda: CpuStateMachine(cfg.TEST_MIN), config=cfg.TEST_MIN,
    )
    close = _serve(server)
    try:
        c = Client(f"127.0.0.1:{server.port}", CLUSTER, client_id=9)
        assert c.create_accounts([{"id": 1, "ledger": 1, "code": 1},
                                  {"id": 2, "ledger": 1, "code": 1}]) == []
        assert c.create_transfers([{"id": 5, "debit_account_id": 1, "credit_account_id": 2,
                                    "amount": 7, "ledger": 1, "code": 1}]) == []
        c.close()
        out = subprocess.run(
            [sys.executable, "-m", "tigerbeetle_tpu_torch", "repl",
             f"--addresses=127.0.0.1:{server.port}", f"--cluster={CLUSTER}",
             "--command=lookup_accounts id=1"],
            cwd=REPO, env=_env(tmp_path), capture_output=True, text=True, timeout=120,
        )
    finally:
        close()
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "ok", out.stdout
    row = json.loads(lines[-2])
    assert (row["id"], row["debits_posted"], row["credits_posted"]) == (1, 7, 0)

    out = subprocess.run(
        [sys.executable, "-m", "tigerbeetle_tpu_torch", "bindings", f"--out={tmp_path / 'b'}"],
        cwd=REPO, env=_env(tmp_path), capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert sorted(p.name for p in (tmp_path / "b").iterdir()) == [
        "README.md", "Types.cs", "Types.java", "tb_types.h", "types.go", "types.ts"]
    trace = tmp_path / "merged.json"
    out = subprocess.run(
        [sys.executable, "-m", "tigerbeetle_tpu_torch", "trace-demo", f"--out={trace}",
         "--batches=2"],
        cwd=REPO, env=_env(tmp_path), capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    info = json.loads(out.stdout.strip().splitlines()[-1])
    assert info["trace_path"] == str(trace) and info["ops_committed"] > 0
    assert {e["pid"] for e in json.loads(trace.read_text())["traceEvents"]} == {0, 1}

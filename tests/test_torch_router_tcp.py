"""The port's TCP router against the reference's, and its CLI command.

- tests/test_sharded_cluster.py's two cases re-pointed
  (tests/torch_repoint.py): 2 shards x 2 replicas of in-process
  ReplicaServers behind the TCP RouterServer, a mixed shard-local /
  cross-shard stream whose replies equal a single-shard oracle
  cluster's, the router killed and restarted with recovery mid-stream,
  conservation over both shards, the folded cluster root over the wire,
  and the 2PC legs' trace context merged into one timeline.  Each case
  runs on the port's router, server, client and bus, and again on the
  reference's.
- The CLI: two `python -m tigerbeetle_tpu_torch start --cpu` shards and
  one `router` in subprocesses; the port's Client sends a cross-shard
  transfer through the router, the router is killed with SIGKILL and
  restarted (recovering), and a second one commits; the balances and the
  router's scrape agree, and SIGTERM ends every process with code 0.
"""

import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

import torch_repoint as rp

REPO = Path(__file__).resolve().parent.parent
CASES = rp.case_names("test_sharded_cluster.py")


@pytest.fixture(autouse=True)
def _reference_native():
    """The reference's native libraries loaded (tests/torch_repoint.py)."""
    rp.reference_native_loaded()


@pytest.mark.parametrize("case", CASES, ids=[c[5:] for c in CASES])
def test_repointed_case_matches_reference(case, tmp_path):
    rp.run_both("test_sharded_cluster.py", case, "oracle", tmp_path)


def _env(tmp_path, name):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env["TB_FLIGHT_PATH"] = str(tmp_path / f"flight_{name}.json")
    env.pop("TB_FASTPATH_DISABLE", None)
    return env


def _launch(tmp_path, name, args, ready):
    """Start `python -m tigerbeetle_tpu_torch <args>` and wait for the
    line containing `ready`; returns (process, port)."""
    log_path = tmp_path / f"{name}.log"
    log = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tigerbeetle_tpu_torch", *args],
        cwd=REPO, env=_env(tmp_path, name), stdout=log, stderr=subprocess.STDOUT,
    )
    log.close()
    deadline = time.monotonic() + 90
    while True:
        text = log_path.read_text()
        line = next((ln for ln in text.splitlines() if ready in ln), None)
        if line is not None:
            return proc, int(line.split(ready)[1].split()[0])
        assert proc.poll() is None, text
        assert time.monotonic() < deadline, f"{name} did not start: {text}"
        time.sleep(0.1)


def test_cli_router_over_two_cpu_shards_survives_kill(tmp_path):
    from tigerbeetle_tpu_torch import types
    from tigerbeetle_tpu_torch.client import Client
    from tigerbeetle_tpu_torch.obs.scrape import scrape_stats

    cluster = 7
    procs = []
    try:
        shard_addrs = []
        for s in range(2):
            path = str(tmp_path / f"s{s}.tb")
            subprocess.run(
                [sys.executable, "-m", "tigerbeetle_tpu_torch", "format",
                 f"--cluster={cluster}", "--replica=0", "--replica-count=1", path],
                cwd=REPO, env=_env(tmp_path, "format"), check=True, capture_output=True,
                timeout=120,
            )
            # Port 0: the server binds a free port and names it.
            proc, port = _launch(tmp_path, f"shard{s}", [
                "start", "--addresses=127.0.0.1:0", "--replica=0", "--cpu", path,
            ], "listening on port ")
            procs.append(proc)
            shard_addrs.append(f"127.0.0.1:{port}")
        router_args = ["router", "--listen=127.0.0.1:0", "--shards=" + ";".join(shard_addrs),
                       f"--cluster={cluster}", "--no-recover"]
        router, rport = _launch(tmp_path, "router", router_args, "router listening on port ")
        procs.append(router)
        addr = f"127.0.0.1:{rport}"
        # Accounts 2, 3 land on shard 0 and 1, 4 on shard 1 (shard_of_account).
        assert [types.shard_of_account(a, 2) for a in (2, 3, 1, 4)] == [0, 0, 1, 1]
        c = Client(addr, cluster, client_id=11, timeout_ms=60_000)
        assert c.create_accounts([{"id": a, "ledger": 1, "code": 1} for a in (1, 2, 3, 4)]) == []
        assert c.create_transfers([{"id": 100, "debit_account_id": 2, "credit_account_id": 1,
                                    "amount": 5, "ledger": 1, "code": 1}]) == []
        c.close()
        router.send_signal(signal.SIGKILL)
        router.wait(timeout=30)
        # The restarted router binds the same port and recovers first.
        router_args[1] = f"--listen={addr}"
        router, _ = _launch(tmp_path, "router2", router_args[:-1], "router listening on port ")
        procs.append(router)
        c = Client(addr, cluster, client_id=12, timeout_ms=60_000)
        assert c.create_transfers([{"id": 101, "debit_account_id": 4, "credit_account_id": 3,
                                    "amount": 7, "ledger": 1, "code": 1}]) == []
        rows = {types.u128_get(r, "id"): r for r in c.lookup_accounts([1, 2, 3, 4])}
        c.close()
        assert [types.u128_get(rows[a], "debits_posted") for a in (1, 2, 3, 4)] == [0, 5, 0, 7]
        assert [types.u128_get(rows[a], "credits_posted") for a in (1, 2, 3, 4)] == [5, 0, 7, 0]
        snap = scrape_stats(addr, cluster, timeout_ms=20_000)
        assert snap["router.2pc_commits"] >= 1 and snap["router.2pc_compensations"] == 0
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        for proc in procs:
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    # SIGTERM ends the router and the shards with code 0.
    assert [p.returncode for p in procs] == [0, 0, -signal.SIGKILL, 0], [
        (tmp_path / f"{n}.log").read_text() for n in ("shard0", "shard1", "router2")
    ]

"""The port's TCP server, client, native bus and CLI against the reference's.

- tests/test_runtime.py's cases whose modules the port has (not the
  repl or benchmark ones) and tests/test_replicated_smoke.py's, re-pointed
  (tests/torch_repoint.py): each runs on the port and on the reference.
- tests/test_async_client.py's C program, built against the port's own
  runtime library (csrc/host/tb_client.h, build/native/).
- The wire contract: clients/fixtures/conversation.json replayed against
  the port's ReplicaServer with the clock pinned as
  tests/test_client_conversations.py pins it, on the port's oracle and
  on TorchStateMachine(device="cpu") on each engine, TB_TENANT_QOS 0 and
  1: the reply bytes must equal the recorded ones.
- One serial single-session stream, under a pinned clock, through a
  reference and a port single-replica server ends in byte-equal data
  files.
- The CLI: `python -m tigerbeetle_tpu_torch format` then `start --cpu`
  in subprocesses, serving the port's Client; `start` without `--cpu`
  and without a card exits non-zero and names the missing card.
"""

import importlib
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_repoint as rp
from torch_link_quiet import link_quiet  # noqa: F401  (autouse: no engine lost its link)

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "clients" / "fixtures" / "conversation.json"
HEADER_SIZE = 256
PINNED_NS = 1_000_000_000
CLUSTER = 3
# Not a multiple of 8 (the reference's device table then stays whole on
# the suite's eight virtual devices).
CAPACITY = (1 << 12) + 3

RUNTIME_CASES = [
    "test_native_checksum_matches_python", "test_client_end_to_end",
    "test_two_clients_isolated_sessions", "test_tcp_restart_recovers",
    "test_cli_version_and_format", "test_three_replica_tcp_cluster",
]
CASES = [("test_runtime.py", c) for c in RUNTIME_CASES] + [
    ("test_replicated_smoke.py", c) for c in rp.case_names("test_replicated_smoke.py")
]



@pytest.fixture(autouse=True)
def _reference_native():
    """The reference's native libraries loaded (tests/torch_repoint.py)."""
    rp.reference_native_loaded()

def _await_flips(servers) -> None:
    """Wait until every server's async checkpoint flip has landed."""
    for server in servers:
        job = server.replica._ckpt_job
        if job is not None:
            job._done.wait(30)


def _flips_land_before_the_scrape(test_file, monkeypatch):
    """The replicated smoke cases read each replica's fsync, prepare and
    flush counters twice, through the stats scrape and then live, while
    the replicas' serve threads keep polling.  TEST_MIN checkpoints at
    op 24, and the checkpoint's flip (three fsyncs) runs on the replica's
    `ckpt` worker (TB_CKPT_ASYNC=1, the default): a flip slowed by a busy
    disk can land between the two reads.  In both packages' runs each
    stats scrape first waits until every replica's flip has landed; the
    stream is committed by then, so no counter moves after it."""
    if test_file != "test_replicated_smoke.py":
        return
    for package in (rp.PORT, rp.REF):
        server_mod = importlib.import_module(f"{package}.runtime.server")
        scrape_mod = importlib.import_module(f"{package}.obs.scrape")
        servers = []

        def recording_init(self, *args, _init=server_mod.ReplicaServer.__init__,
                           _servers=servers, **kwargs):
            _init(self, *args, **kwargs)
            _servers.append(self)

        def landed_scrape(*args, _scrape=scrape_mod.scrape_stats, _servers=servers, **kwargs):
            _await_flips(_servers)
            return _scrape(*args, **kwargs)

        monkeypatch.setattr(server_mod.ReplicaServer, "__init__", recording_init)
        monkeypatch.setattr(scrape_mod, "scrape_stats", landed_scrape)


@pytest.mark.parametrize("test_file,case", CASES, ids=[f"{f[5:-3]}-{c[5:]}" for f, c in CASES])
def test_repointed_case_matches_reference(test_file, case, tmp_path, capsys, monkeypatch):
    _flips_land_before_the_scrape(test_file, monkeypatch)
    rp.run_both(test_file, case, "oracle", tmp_path, {"capsys": capsys})


@pytest.mark.parametrize("package", [rp.PORT, rp.REF])
def test_repointed_smoke_holds_with_a_late_checkpoint_flip(package, tmp_path, monkeypatch):
    """The race the smoke cases' harness removes, made deterministic:
    each async checkpoint flip is held until the case's first stats
    scrape, then lets go.  Without `_flips_land_before_the_scrape` the
    scrape returns first and the flip lands before the case's live reads,
    which fails `snap["storage.fsyncs"] == ...stat_fsyncs` on either
    package; with it the scrape waits for the flip and the case passes,
    its checkpoints still flipped on the `ckpt` worker."""
    replica_mod = importlib.import_module(f"{package}.vsr.replica")
    scrape_mod = importlib.import_module(f"{package}.obs.scrape")
    released = threading.Event()
    flips = []
    finalize = replica_mod.Replica._checkpoint_finalize

    def held_finalize(self, *args, **kwargs):
        if threading.current_thread().name == "ckpt":
            released.wait(10)
        flips.append(threading.current_thread().name)
        return finalize(self, *args, **kwargs)

    monkeypatch.setattr(replica_mod.Replica, "_checkpoint_finalize", held_finalize)
    _flips_land_before_the_scrape("test_replicated_smoke.py", monkeypatch)
    await_flips = _await_flips
    scrape_stats = scrape_mod.scrape_stats

    def releasing_await(servers):
        released.set()
        await_flips(servers)

    def releasing_scrape(*args, **kwargs):
        snap = scrape_stats(*args, **kwargs)
        if not released.is_set():
            released.set()
            time.sleep(0.5)  # a held flip lands now
        return snap

    monkeypatch.setattr(sys.modules[__name__], "_await_flips", releasing_await)
    monkeypatch.setattr(scrape_mod, "scrape_stats", releasing_scrape)
    rp.run_case("test_replicated_smoke.py", "test_two_replica_group_commit_smoke", package,
                "oracle", tmp_path, {"capsys": None})
    assert "ckpt" in flips, flips


def _serve(server):
    stop = threading.Event()

    def loop():
        while not stop.is_set():
            server.poll_once(10)

    thread = threading.Thread(target=loop, daemon=True)
    thread.start()

    def close():
        stop.set()
        thread.join(timeout=5)
        server.close()

    return close


def test_async_c_client_against_port_runtime(tmp_path):
    """The reference's C test program of the async client ABI, compiled
    against the port's tb_client.h and runtime library, drives a port
    server."""
    from tigerbeetle_tpu_torch import constants as cfg
    from tigerbeetle_tpu_torch.kernels import host_build
    from tigerbeetle_tpu_torch.runtime.server import ReplicaServer, format_data_file
    from tigerbeetle_tpu_torch.state_machine import CpuStateMachine

    cc = shutil.which("gcc") or shutil.which("cc")
    if cc is None:
        pytest.skip("no C compiler")
    lib, _ = host_build.build(name="runtime")
    exe = tmp_path / "test_async_client"
    subprocess.run(
        [cc, "-O2", "-o", str(exe), str(REPO / "native" / "test_async_client.c"),
         "-I", str(host_build.HOST_SRC), str(lib), f"-Wl,-rpath,{lib.parent}", "-pthread"],
        check=True, capture_output=True,
    )
    path = str(tmp_path / "data.tigerbeetle")
    format_data_file(path, cluster=CLUSTER, config=cfg.TEST_MIN)
    server = ReplicaServer(
        path, cluster=CLUSTER, addresses=["127.0.0.1:0"], replica_index=0,
        state_machine_factory=lambda: CpuStateMachine(cfg.TEST_MIN), config=cfg.TEST_MIN,
    )
    close = _serve(server)
    try:
        proc = subprocess.run([str(exe), str(server.port)], capture_output=True, text=True,
                              timeout=60)
    finally:
        close()
    assert proc.returncode == 0, f"stdout: {proc.stdout}\nstderr: {proc.stderr}"
    assert "out-of-order completion verified" in proc.stdout


@pytest.fixture()
def pinned_time(monkeypatch):
    # As tests/test_client_conversations.py: the wall clock pinned
    # (timestamps derive from event counts) and the monotonic clock
    # (the tick cadence never fires, so no pulse lands at a
    # scheduling-dependent position).
    monkeypatch.setattr(time, "time_ns", lambda: PINNED_NS)
    monkeypatch.setattr(time, "monotonic_ns", lambda: 0)


def _recv_frame(sock, buf):
    while True:
        if len(buf) >= HEADER_SIZE:
            size = int.from_bytes(buf[144:148], "little")
            if len(buf) >= size:
                return buf[:size], buf[size:]
        chunk = sock.recv(1 << 20)
        assert chunk, "server closed mid-conversation"
        buf += chunk


def _port_machine(kind, config):
    from tigerbeetle_tpu_torch.state_machine import CpuStateMachine
    from tigerbeetle_tpu_torch.state_machine.gpu import TorchStateMachine

    if kind == "oracle":
        return CpuStateMachine(config)
    return TorchStateMachine(config, account_capacity=CAPACITY, transfer_capacity=CAPACITY,
                             device="cpu", engine=kind)


@pytest.mark.parametrize("tenant_qos", ["0", "1"])
@pytest.mark.parametrize("kind", ["oracle", "host", "device"])
def test_conversation_replay_byte_exact(tmp_path, pinned_time, monkeypatch, kind, tenant_qos):
    """The recorded session (register, creates with a failure, a
    retransmit, lookups, queries, balances) through the port's server:
    every reply byte-equal to the fixture's."""
    from tigerbeetle_tpu_torch import constants as cfg
    from tigerbeetle_tpu_torch.runtime.server import ReplicaServer, format_data_file

    monkeypatch.setenv("TB_TENANT_QOS", tenant_qos)
    steps = json.loads(FIXTURE.read_text())
    assert len(steps) >= 7 and any(s["retransmit_of"] for s in steps)
    path = str(tmp_path / "0_0.tigerbeetle")
    format_data_file(path, cluster=CLUSTER, replica_index=0, replica_count=1)
    server = ReplicaServer(
        path, addresses=["127.0.0.1:0"], replica_index=0,
        state_machine_factory=lambda: _port_machine(kind, cfg.PRODUCTION),
    )
    close = _serve(server)
    try:
        sock = socket.create_connection(("127.0.0.1", server.port), timeout=30)
        sock.settimeout(30)
        buf = b""
        for step in steps:
            sock.sendall(bytes.fromhex(step["request_hex"]))
            reply, buf = _recv_frame(sock, buf)
            assert reply == bytes.fromhex(step["reply_hex"]), (
                f"step {step['name']}: reply bytes diverge from the recorded contract"
            )
        sock.close()
    finally:
        close()


def _stream(m, kind, path, tmp_flight):
    """A serial single-session stream through package `m`'s server and
    client; returns the replies."""
    cfg = importlib.import_module(f"{m}.constants")
    server_mod = importlib.import_module(f"{m}.runtime.server")
    client_mod = importlib.import_module(f"{m}.client")
    server_mod.format_data_file(path, cluster=CLUSTER, config=cfg.TEST_MIN)
    if m == rp.PORT:
        factory = lambda: _port_machine(kind, cfg.TEST_MIN)  # noqa: E731
    elif kind == "oracle":
        from tigerbeetle_tpu.state_machine import CpuStateMachine

        factory = lambda: CpuStateMachine(cfg.TEST_MIN)  # noqa: E731
    else:
        from tigerbeetle_tpu.state_machine.tpu import TpuStateMachine

        factory = lambda: TpuStateMachine(  # noqa: E731
            cfg.TEST_MIN, account_capacity=CAPACITY, transfer_capacity=CAPACITY, engine=kind
        )
    server = server_mod.ReplicaServer(
        path, cluster=CLUSTER, addresses=["127.0.0.1:0"], replica_index=0,
        state_machine_factory=factory, config=cfg.TEST_MIN,
    )
    close = _serve(server)
    replies = []
    try:
        c = client_mod.Client(f"127.0.0.1:{server.port}", CLUSTER, client_id=77)
        replies.append(c.create_accounts(
            [{"id": i, "ledger": 1, "code": 1} for i in range(1, 25)]
        ))
        rng = np.random.default_rng(5)
        tid = 1000
        # 24 events a batch fit TEST_MIN's 4 KiB messages; 48 batches
        # cross several checkpoints; ids 25-26 do not exist (failures).
        for _ in range(48):
            batch = []
            for _ in range(24):
                dr, cr = (int(x) for x in rng.choice(np.arange(1, 27), 2, replace=False))
                batch.append({"id": tid, "debit_account_id": dr, "credit_account_id": cr,
                              "amount": int(rng.integers(1, 1000)), "ledger": 1, "code": 1})
                tid += 1
            replies.append(c.create_transfers(batch))
        replies.append([bytes(r) for r in c.lookup_accounts(list(range(1, 25)))])
        c.close()
    finally:
        close()
    return replies


@pytest.mark.parametrize("kind", ["oracle", "host"])
def test_serial_stream_byte_equal_data_files(tmp_path, pinned_time, kind):
    """The same stream through a reference and a port single-replica
    server (TEST_MIN config): equal replies and byte-equal data files."""
    port_path, ref_path = str(tmp_path / "port.tb"), str(tmp_path / "ref.tb")
    got = _stream(rp.PORT, kind, port_path, tmp_path)
    want = _stream(rp.REF, kind, ref_path, tmp_path)
    assert repr(got) == repr(want)
    a, b = Path(port_path).read_bytes(), Path(ref_path).read_bytes()
    assert len(a) == len(b) and a == b


def _env(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env["TB_FLIGHT_PATH"] = str(tmp_path / "flight.json")
    env.pop("TB_FASTPATH_DISABLE", None)
    return env


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_format_and_start_cpu_serve_a_client(tmp_path):
    """`format` then `start --cpu` in subprocesses; the port's Client
    creates and looks up accounts; SIGTERM ends the server with code 0."""
    from tigerbeetle_tpu_torch import types
    from tigerbeetle_tpu_torch.client import Client

    path = str(tmp_path / "0_0.tigerbeetle")
    out = subprocess.run(
        [sys.executable, "-m", "tigerbeetle_tpu_torch", "format", "--cluster=11",
         "--replica=0", "--replica-count=1", path],
        cwd=REPO, env=_env(tmp_path), capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0 and "formatted" in out.stdout, out.stderr
    port = _free_port()
    log = open(tmp_path / "server.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tigerbeetle_tpu_torch", "start",
         f"--addresses=127.0.0.1:{port}", "--replica=0", "--cpu", path],
        cwd=REPO, env=_env(tmp_path), stdout=log, stderr=subprocess.STDOUT,
    )
    try:
        deadline = time.monotonic() + 90
        while "listening on port" not in (tmp_path / "server.log").read_text():
            assert proc.poll() is None, (tmp_path / "server.log").read_text()
            assert time.monotonic() < deadline, "server did not start"
            time.sleep(0.1)
        c = Client(f"127.0.0.1:{port}", 11, client_id=5)
        assert c.create_accounts(
            [{"id": 1, "ledger": 1, "code": 1}, {"id": 2, "ledger": 1, "code": 1}]
        ) == []
        assert c.create_transfers([{"id": 9, "debit_account_id": 1, "credit_account_id": 2,
                                    "amount": 3, "ledger": 1, "code": 1}]) == []
        rows = c.lookup_accounts([2])
        assert types.u128_get(rows[0], "credits_posted") == 3
        c.close()
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        log.close()
    assert rc == 0, (tmp_path / "server.log").read_text()
    assert json.loads((tmp_path / "flight.json").read_text())["otherData"]["reason"] == "sigterm"


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the card-less refusal")
def test_cli_start_without_card_names_it(tmp_path):
    path = str(tmp_path / "0_0.tigerbeetle")
    subprocess.run(
        [sys.executable, "-m", "tigerbeetle_tpu_torch", "format", "--cluster=11", path],
        cwd=REPO, env=_env(tmp_path), check=True, capture_output=True, timeout=120,
    )
    out = subprocess.run(
        [sys.executable, "-m", "tigerbeetle_tpu_torch", "start",
         f"--addresses=127.0.0.1:{_free_port()}", "--replica=0", path],
        cwd=REPO, env=_env(tmp_path), capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert "no CUDA card" in out.stderr and "--cpu" in out.stderr

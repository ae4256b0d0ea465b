"""CLI: version | format | start | router | follower | repl | benchmark | bindings |
trace-demo | lint.

The port's copy of ``tigerbeetle_tpu/cli.py``, with the commands whose
modules the port has (reference: src/tigerbeetle/cli.zig:106-128).
``start`` and ``benchmark`` (its in-process replica) serve
``TorchStateMachine`` on the first CUDA card, or the port's CPU oracle
under ``--cpu``; without a card and without ``--cpu`` they exit non-zero
and say so.  ``router`` runs no state machine and needs no card: the
shards it fronts are ``start`` processes.  ``follower`` replays on the
port's CPU oracle, as the reference's does, and needs no card either.
``lint`` runs tbcheck over the port's package.
"""
# tbcheck: allow-file(no-print): the CLI's stdout IS its interface
# (command results, usage, listen-port handshake).

from __future__ import annotations

import json
import sys
import time

from tigerbeetle_tpu_torch import flags
from tigerbeetle_tpu_torch import constants as cfg

VERSION = "0.1.0"

# Reference Start.cache_accounts/cache_transfers default analog: one
# value, used by the flag spec, the factory defaults, and the --cpu
# warning alike.
CACHE_DEFAULT = 1 << 16

USAGE = """usage: python -m tigerbeetle_tpu_torch <command> [flags]

commands:
  format     --cluster=<int> --replica=<i> --replica-count=<n> <path>
  start      --addresses=<host:port,...> --replica=<i> [--cpu]
             [--cluster=<int>] [--aof=<path>] [--trace=<path>]
             [--standby-count=<n>] [--cache-accounts=<n>]
             [--cache-transfers=<n>]
             <path>
  router     --listen=<host:port> --shards=<addrs;addrs;...>
             [--cluster=<int>] [--no-recover]
             [--followers=<shard:host:port;...>]
             (account-sharded multi-cluster front-end: each ';'-
              separated entry is one shard's comma-joined replica
              address list; on start the router recovers in-doubt
              cross-shard transfers from shard state; --followers
              names read-only followers reads steer to under
              TB_READ_POLICY)
  follower   --listen=<host:port> --aof=<path> --upstream=<host:port>
             --cluster=<int> [--id=<n>]
             (read-only follower: tails the upstream replica's AOF,
              replays it, serves lookup/filter reads at a stated
              commit_min with every reply carrying the state root,
              attested against the upstream's root ring — refuses
              typed rather than serve unverifiable state)
  version
  repl       --addresses=<host:port> [--cluster=<int>] [--command=<stmts>]
  benchmark  [--transfers=N] [--accounts=N] [--batch=N] [--addresses=...]
             [--statsd-port=N] [--cpu]
  bindings   [--out=<dir>]   (generate C / TypeScript / Go type bindings)
  trace-demo [--out=<path>] [--replicas=N] [--batches=N]
             (drive a replicated drain with tracing on and write one
              merged Perfetto-loadable timeline)
  lint       [--json] [paths...]
             (tbcheck: AST invariant lint over the package — exits
              nonzero on any unsuppressed finding)
  trace-demo [--out=<path>] [--replicas=N] [--batches=N]
             (drive a replicated drain with tracing on and write one
              merged Perfetto-loadable timeline)
"""

NO_CARD = (
    "no CUDA card is visible (torch.cuda.is_available() is false); the "
    "server runs TorchStateMachine on the card, or the CPU oracle under "
    "--cpu"
)


def _sm_factory(use_cpu: bool, cache_accounts: int = CACHE_DEFAULT,
                cache_transfers: int = CACHE_DEFAULT):
    """Capacities follow the reference's static-allocation design:
    operator-configured cache sizes pre-size every large buffer
    (reference: src/tigerbeetle/cli.zig Start.cache_accounts /
    cache_transfers)."""
    if use_cpu:
        from tigerbeetle_tpu_torch.state_machine import CpuStateMachine

        if (cache_accounts, cache_transfers) != (CACHE_DEFAULT, CACHE_DEFAULT):
            print(
                "warning: --cache-accounts/--cache-transfers have no "
                "effect with --cpu (the CPU engine is dict-backed and "
                "unbounded)",
                file=sys.stderr,
            )
        return lambda: CpuStateMachine(cfg.PRODUCTION)
    import torch

    if not torch.cuda.is_available():
        flags.fatal(NO_CARD)
    from tigerbeetle_tpu_torch.state_machine.gpu import TorchStateMachine

    return lambda: TorchStateMachine(
        cfg.PRODUCTION,
        account_capacity=cache_accounts,
        transfer_capacity=cache_transfers,
        device="cuda:0",
    )


def cmd_format(args: list[str]) -> None:
    opts, paths = flags.parse(
        args, {"cluster": None, "replica": 0, "replica_count": 1}
    )
    if len(paths) != 1:
        flags.fatal("format requires exactly one data-file path")
    from tigerbeetle_tpu_torch.runtime.server import format_data_file

    format_data_file(
        paths[0], cluster=int(opts["cluster"], 0)
        if isinstance(opts["cluster"], str) else opts["cluster"],
        replica_index=opts["replica"], replica_count=opts["replica_count"],
    )
    print(f"formatted {paths[0]}")


def cmd_start(args: list[str]) -> None:
    opts, paths = flags.parse(
        args,
        {"addresses": None, "replica": 0, "cluster": "", "cpu": False,
         "aof": "", "trace": "", "standby_count": 0,
         "cache_accounts": CACHE_DEFAULT, "cache_transfers": CACHE_DEFAULT},
    )
    if len(paths) != 1:
        flags.fatal("start requires exactly one data-file path")
    from tigerbeetle_tpu_torch.runtime.server import ReplicaServer

    # --cluster is optional: the data file records it at format time
    # (reference: src/tigerbeetle/main.zig start reads the superblock);
    # passing it explicitly just adds a consistency check.
    cluster = None
    if opts["cluster"]:
        try:
            cluster = int(opts["cluster"], 0)
        except ValueError:
            flags.fatal(f"--cluster: invalid integer {opts['cluster']!r}")
    # Core pinning (TB_CPU_AFFINITY): slot = replica index, so a
    # cluster's replicas spread across cores under "auto".
    from tigerbeetle_tpu_torch.runtime import affinity

    pinned = affinity.apply(slot=opts["replica"])
    if pinned is not None:
        print(f"pinned to cores {list(pinned)}", flush=True)
    server = ReplicaServer(
        paths[0], cluster=cluster,
        addresses=opts["addresses"].split(","), replica_index=opts["replica"],
        state_machine_factory=_sm_factory(
            opts["cpu"], cache_accounts=opts["cache_accounts"],
            cache_transfers=opts["cache_transfers"],
        ),
        aof_path=opts["aof"] or None,
        trace_path=opts["trace"] or None,
        standby_count=opts["standby_count"],
    )
    sm = server.replica.sm
    print(
        f"state machine {type(sm).__name__}, engine "
        f"{getattr(sm, 'engine', 'oracle')}, device {getattr(sm, 'device', 'cpu')}",
        flush=True,
    )
    print(f"listening on port {server.port}", flush=True)
    # Graceful shutdown on SIGTERM/SIGINT: flush the AOF and write the
    # trace file (close() is the only writer of --trace output).  The
    # handler only asks the loop to stop: the reference raises
    # KeyboardInterrupt from it, which can land inside the replica's
    # code, holding its locks, and leave close() waiting on them.
    import signal

    def _stop(signum, frame):
        server.request_stop()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    try:
        server.serve_forever()
    finally:
        # Crashes flush the trace/AOF too, not just clean shutdowns.
        server.close()
        print("server closed", flush=True)


def cmd_router(args: list[str]) -> None:
    opts, paths = flags.parse(
        args,
        {"listen": "127.0.0.1:3000", "shards": None, "cluster": 0,
         "no_recover": False, "followers": ""},
    )
    if paths:
        flags.fatal("router takes no positional arguments")
    if not opts["shards"]:
        flags.fatal("router requires --shards=<addrs;addrs;...>")
    from tigerbeetle_tpu_torch.runtime import affinity
    from tigerbeetle_tpu_torch.runtime.router import RouterServer

    pinned = affinity.apply(slot=0)
    if pinned is not None:
        print(f"pinned to cores {list(pinned)}", flush=True)
    server = RouterServer(
        opts["listen"], opts["shards"].split(";"),
        cluster=opts["cluster"], recover=not opts["no_recover"],
        follower_addresses=(
            opts["followers"].split(";") if opts["followers"] else None
        ),
    )
    print(
        f"router listening on port {server.port} "
        f"({server.n_shards} shards)", flush=True,
    )
    import signal

    def _stop(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _stop)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()


def cmd_follower(args: list[str]) -> None:
    opts, paths = flags.parse(
        args,
        {"listen": "127.0.0.1:0", "aof": None, "upstream": None,
         "cluster": 0, "id": 0},
    )
    if paths:
        flags.fatal("follower takes no positional arguments")
    if not opts["aof"] or not opts["upstream"]:
        flags.fatal("follower requires --aof=<path> and "
                    "--upstream=<host:port>")
    from tigerbeetle_tpu_torch.runtime import affinity
    from tigerbeetle_tpu_torch.runtime.follower import FollowerServer
    from tigerbeetle_tpu_torch.state_machine import CpuStateMachine

    pinned = affinity.apply(slot=opts["id"])
    if pinned is not None:
        print(f"pinned to cores {list(pinned)}", flush=True)

    # Followers replay on the CPU state machine (deterministic host
    # replay, no device needed; its state_root equals the card
    # engine's for the same commit stream) — a device-engine follower
    # is a deliberate scope cut for now.
    server = FollowerServer(
        opts["listen"], aof_path=opts["aof"],
        upstream_address=opts["upstream"], cluster=opts["cluster"],
        state_machine=CpuStateMachine(cfg.PRODUCTION),
        clock_ns=time.monotonic_ns, follower_id=opts["id"],
    )
    print(f"follower listening on port {server.port}", flush=True)
    import signal

    def _stop(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _stop)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()


def cmd_repl(args: list[str]) -> None:
    opts, _ = flags.parse(
        args, {"addresses": None, "cluster": 0, "command": ""}
    )
    from tigerbeetle_tpu_torch.client import Client
    from tigerbeetle_tpu_torch import repl

    client = Client(opts["addresses"].split(",")[0], opts["cluster"])
    try:
        repl.run(client, command=opts["command"] or None)
    finally:
        client.close()


def cmd_benchmark(args: list[str]) -> None:
    opts, _ = flags.parse(
        args,
        {
            "addresses": "", "cluster": 0, "transfers": 100_000,
            "accounts": 10_000, "batch": 8190, "cpu": False,
            "statsd_port": 0,
        },
    )
    from tigerbeetle_tpu_torch.benchmark import run_benchmark

    result = run_benchmark(
        addresses=opts["addresses"] or None, cluster=opts["cluster"],
        n_transfers=opts["transfers"], n_accounts=opts["accounts"],
        batch=opts["batch"], use_cpu=opts["cpu"],
        statsd_port=opts["statsd_port"] or None,
    )
    print(json.dumps(result))


def cmd_trace_demo(args: list[str]) -> None:
    opts, _ = flags.parse(
        args, {"out": "tb_trace_merged.json", "replicas": 2, "batches": 8}
    )
    from tigerbeetle_tpu_torch.testing.cluster import trace_demo

    result = trace_demo(
        opts["out"], n_replicas=opts["replicas"], batches=opts["batches"]
    )
    print(json.dumps(result))
    print(
        f"load {opts['out']} at https://ui.perfetto.dev "
        "(or chrome://tracing)",
        file=sys.stderr,
    )


def cmd_bindings(args: list[str]) -> None:
    opts, _ = flags.parse(args, {"out": "bindings"})
    from tigerbeetle_tpu_torch import bindings

    for path in bindings.generate(opts["out"]):
        print(f"wrote {path}")


def cmd_lint(args: list[str]) -> None:
    from tigerbeetle_tpu_torch import analysis

    raise SystemExit(analysis.main(args))


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(USAGE)
        raise SystemExit(1)
    command, *rest = argv
    if command == "version":
        print(VERSION)
    elif command == "format":
        cmd_format(rest)
    elif command == "start":
        cmd_start(rest)
    elif command == "router":
        cmd_router(rest)
    elif command == "follower":
        cmd_follower(rest)
    elif command == "repl":
        cmd_repl(rest)
    elif command == "benchmark":
        cmd_benchmark(rest)
    elif command == "bindings":
        cmd_bindings(rest)
    elif command == "lint":
        cmd_lint(rest)
    elif command == "trace-demo":
        cmd_trace_demo(rest)
    else:
        print(USAGE)
        flags.fatal(f"unknown command {command!r}")


if __name__ == "__main__":
    main()

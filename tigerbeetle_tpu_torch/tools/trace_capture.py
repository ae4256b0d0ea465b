"""What torch.profiler's trace holds of a host-engine run, on the card.

    python -m tigerbeetle_tpu_torch.tools.trace_capture [--out FILE]

A host-engine stream on the native lanes launches few kernels: the
write-behind flushes (an upload of the queued entries and kernel K4)
are its only device work, and in a chain or two-phase stream they come
in one to three flushes, the last one at the stream's final flush
barrier just before the profiler stops.  This script drives the
workload's linked and two-phase streams on the host engine (1,000,000
accounts, 250,000 transfers, as chip_smoke's linked_host and
two_phase_host phases) under the profiler in several arms:

- ``as_smoke``: the profiler around the timed batches, the final flush
  and a synchronize (chip_smoke's profiled run);
- ``settle``: the same, then one synchronize more and a 100 ms sleep
  inside the profiler;
- ``tail_op``: the same, then a one-element add on the card and a
  synchronize inside the profiler;

and two bare arms: one K4 launch on a small table, with and without a
torch operation on the card before it.  Then (``--age N``) it ages the
process with N profiler sessions of 1,000 one-element adds each and
takes the ``as_smoke`` arms and the bare K4 arm again (with 0, 2,000
and 20,000 spin kernels after it), to see whether
the process's earlier sessions decide what a later trace holds (a long
``chip_smoke.py`` run profiles many times before its host-engine
phases).  For each arm it prints the K4
launches and flushes inside the profiler, the device events of
``prof.events()`` (count, busy ms by name, first start and last end
against the window), and the raw kineto events by device type.  Needs a
CUDA card.
"""
# tbcheck: allow-file(no-print): a command-line tool — the lines it
# prints on stdout are its output.

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from tigerbeetle_tpu_torch import kernels, workload
from tigerbeetle_tpu_torch.kernels import build
from tigerbeetle_tpu_torch.ops.u128 import from_u64
from tigerbeetle_tpu_torch.runtime import fastpath
from tigerbeetle_tpu_torch.state_machine import device_kernels as dk
from tigerbeetle_tpu_torch.state_machine.gpu import TorchStateMachine
from tigerbeetle_tpu_torch.testing.harness import SingleNodeHarness
from tigerbeetle_tpu_torch.types import TRANSFER_DTYPE, Operation

N_ACCOUNTS = 1_000_000
N_EXACT = 250_000


def _profile():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _summary(prof, t_enter: float, t_exit: float) -> dict:
    """The trace's device events: count, busy ms by name, first start
    and last end in ms after the profiler's start; the raw kineto
    events by device type."""
    from torch.autograd import DeviceType

    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict[str, float] = {}
    for e in events:
        by_name[e.name[:40]] = by_name.get(e.name[:40], 0.0) + e.time_range.elapsed_us() / 1e3
    raw: dict[str, int] = {}
    for e in prof.profiler.kineto_results.events():
        key = str(e.device_type())
        raw[key] = raw.get(key, 0) + 1
    out = {"device_events": len(events), "ms_by_name": by_name, "raw_by_device": raw,
           "window_ms": (t_exit - t_enter) * 1e3}
    if events:
        out["first_start_ms"] = min(e.time_range.start for e in events) / 1e3
        out["last_end_ms"] = max(e.time_range.end for e in events) / 1e3
    return out


def stream_arm(gen: str, arm: str) -> dict:
    """One host-engine run of `gen`'s stream with its timed batches,
    final flush and synchronize inside the profiler (`arm` adds what
    follows them there)."""
    if gen == "linked":
        setup, timed, sizing = workload.gen_linked(N_EXACT)
    else:
        setup, timed, sizing = workload.gen_two_phase(N_EXACT, n_accounts=N_ACCOUNTS)
    n = sum(len(b) // TRANSFER_DTYPE.itemsize for op, b in setup + timed
            if op == Operation.create_transfers)
    sm = TorchStateMachine(account_capacity=sizing[0], transfer_capacity=n + 1024,
                           engine="host")
    h = SingleNodeHarness(sm)
    for op, body in setup:
        h.submit(op, body)
    torch.cuda.synchronize()
    flushes0 = sm._dev.stat_flushes
    kernels.reset_launches()
    with _profile() as prof:
        t_enter = time.perf_counter()
        futs = [h.submit_async(op, body) for op, body in timed]
        for f in futs:
            f.result()
        sm._dev.read()
        torch.cuda.synchronize()
        if arm == "settle":
            torch.cuda.synchronize()
            time.sleep(0.1)
        elif arm == "tail_op":
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        t_exit = time.perf_counter()
    out = {"stream": gen, "arm": arm, "native": sm._native is not None,
           "k4_launches": kernels.launches["apply_deltas"],
           "flushes": sm._dev.stat_flushes - flushes0}
    out.update(_summary(prof, t_enter, t_exit))
    return out


def bare_arm(torch_op_first: bool, filler: int = 0) -> dict:
    """One K4 launch (1,000 entries on a 2^16-row table) inside the
    profiler, after a torch operation on the card when
    `torch_op_first`; then, inside the profiler, `filler` launches of
    PyTorch's one-cycle spin kernel (``torch.cuda._sleep(1)``), so that
    the activity records before them are followed by others."""
    rng = np.random.default_rng(7)
    table = torch.zeros((1 << 16, 8), dtype=torch.int64, device="cuda")
    slots = rng.choice(1 << 16, 1000, replace=False).astype(np.uint64)
    packed = np.stack([slots, np.zeros(1000, np.uint64),
                       rng.integers(1, 100, 1000).astype(np.uint64), np.zeros(1000, np.uint64)])
    entries = from_u64(packed, table.device)
    torch.cuda.synchronize()
    kernels.reset_launches()
    with _profile() as prof:
        t_enter = time.perf_counter()
        if torch_op_first:
            torch.ones(1, device="cuda").add_(1)
        dk.apply_deltas(table, entries)
        torch.cuda.synchronize()
        for _ in range(filler):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        t_exit = time.perf_counter()
    out = {"stream": "bare_k4", "arm": "torch_op_first" if torch_op_first else "k4_only",
           "filler": filler, "k4_launches": kernels.launches["apply_deltas"]}
    out.update(_summary(prof, t_enter, t_exit))
    return out


def age(sessions: int) -> dict:
    """`sessions` profiler sessions of 1,000 one-element adds each;
    returns the device events the last one held."""
    x = torch.zeros(1, device="cuda")
    held = 0
    for _ in range(sessions):
        with _profile() as prof:
            for _ in range(1000):
                x.add_(1)
            torch.cuda.synchronize()
        held = _summary(prof, 0.0, 0.0)["device_events"]
    return {"stream": "age", "sessions": sessions, "last_session_device_events": held}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the JSON list here")
    parser.add_argument("--age", type=int, default=0,
                        help="profiler sessions to age the process with, then the arms again")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("trace_capture: no CUDA device")
        return 1
    build.build_all()
    fastpath.load()
    rows = [bare_arm(False), bare_arm(True)]
    for gen in ("linked", "two_phase"):
        for arm in ("as_smoke", "settle", "tail_op"):
            rows.append(stream_arm(gen, arm))
    if args.age:
        rows.append(age(args.age))
        for filler in (0, 0, 2_000, 20_000, 0):
            rows.append(bare_arm(False, filler))
        for gen in ("linked", "two_phase"):
            rows.append(stream_arm(gen, "as_smoke"))
    for row in rows:
        print(json.dumps(row))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

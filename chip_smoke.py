#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the hand-written kernels (csrc/*.cu, one nvcc per source, in
parallel), holds every kernel against its plain PyTorch version at the
main path's shapes (bit-exact: the semantics are integer), then drives
the port's create_transfers loop through SingleNodeHarness on
TorchStateMachine() in three phases:

  simple    a 2^20-row device table, 1,000,000 accounts, 1,000,000
            transfers in 8190-event batches (uniform debit, credit =
            debit % n + 1, amounts 1..99)
  zipf      the hot-account shape: 100 accounts, p ~ 1/rank,
            1,000,000 transfers
  failures  more than 60 invalid events per batch, so every batch is
            flagged and exact recovery runs on the card

Each phase's main-path run starts with every launch count at 0 (set
just before the state machine is built) and its counts are read as soon
as the stream has drained, before any check launches anything.  After
each phase: every transfer event's code came from kernel K1, no batch
fell back (except in the failure phase), the device tables equal the
host mirror, the device digest equals its from-scratch recompute (K2
probe, a check-only kernel: the main path never launches it) and the
host root, and replies, root and tables equal a second run of the same
stream with the engine on the plain versions, on the card.  A third run
of the stream, under torch.profiler, gives the device's busy time: the
union of its kernel and copy intervals over the timed batches.

Prints the card's name and power limit, one line per phase with its
events/s, launches and device busy share, a JSON line listing every
kernel (main-path launches in total and per phase, check launches,
error against the plain version, times, bound), and as its last line
{"ok": true, "device": {...}}.  Exits non-zero without a CUDA device or
on any failed check.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

from tigerbeetle_tpu_torch import kernels
from tigerbeetle_tpu_torch import workload
from tigerbeetle_tpu_torch.kernels import build
from tigerbeetle_tpu_torch.state_machine import commitment as cm
from tigerbeetle_tpu_torch.state_machine import device_kernels as dk
from tigerbeetle_tpu_torch.state_machine.gpu import TorchStateMachine
from tigerbeetle_tpu_torch.testing.harness import SingleNodeHarness
from tigerbeetle_tpu_torch.types import TRANSFER_DTYPE, Operation

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak (NVIDIA data sheet)
# The data sheet gives no integer rate outside the tensor cores; the
# kernels' 64-bit integer operations are counted against its float32
# CUDA-core rate, 67 TFLOP/s.
OPS_PER_S = 67e12
# 64-bit integer operations per unit of work, counted from the sources:
# K1 per event (decode + ladder + timeout check + accumulate) and per
# touched row (limb recombination, u128 adds, overflow checks, write);
# K2 per hashed row (11 splitmix64 finalizers, the xors and the fold).
K1_OPS_PER_EVENT = 80
K1_OPS_PER_ROW = 120
K2_OPS_PER_ROW = 140
A_ROWS = 1 << 20
N_TRANSFERS = 1_000_000
N_ACCOUNTS = 1_000_000
RING_ROWS = 256
# Kernels the main path launches; K2 probe only serves the checks
# (verify_device_mirror and the engine's commit_probe).
MAIN_PATH = ("orderfree", "commit_update", "commit_rebuild")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi unavailable"


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_ms(fn, reps: int = 30, warm: int = 3) -> float:
    """Median milliseconds per call, CUDA events around each call."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, reps: int = 20) -> float | None:
    """Device time per call: the card's own kernel time (torch.profiler,
    CUDA activity) summed over `reps` calls, divided by `reps`.  Unlike
    time_ms it excludes the host's launch work.  None when the profiler
    saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            total_us += getattr(e, "self_device_time_total", None) or getattr(
                e, "self_cuda_time_total", 0.0
            )
    return total_us / reps / 1e3 if total_us > 0 else None


def kernel_ms(fn) -> tuple[float, float | None]:
    """(CUDA-event time per call, host launch work included; device
    time per call from the profiler)."""
    return time_ms(fn), device_ms(fn)


def _dev(ms: float | None) -> str:
    return "device time not measured" if ms is None else f"{ms * 1e3:.1f} us on the device"


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """Least milliseconds the card could take: the larger of the bytes
    over the memory rate and the operations over the peak rate."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _vs(plain_ms: float, bound_ms: float) -> str:
    return f"(plain {plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.3f} us)"


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |a - b| over int64 lanes (exact as Python ints)."""
    if torch.equal(a, b):
        return 0
    d = (a.cpu().numpy().astype(object) - b.cpu().numpy().astype(object))
    return int(np.abs(d).max())


# ---------------------------------------------------------------------------
# Kernel vs plain version, at the main path's shapes.


def _tables(rng, A, dev):
    lo = rng.integers(-(1 << 63), (1 << 63) - 1, (A, 4), dtype=np.int64)
    hi = rng.integers(0, 1 << 40, (A, 4), dtype=np.int64)
    table = np.stack([lo, hi], axis=-1).reshape(A, 8)
    meta = np.zeros((A, 2), np.int32)
    meta[:, 1] = 1  # ledger 1
    return torch.from_numpy(table).to(dev), torch.from_numpy(meta).to(dev)


def _slots(rng, n, n_acct):
    dr = rng.integers(0, n_acct, n)
    return dr, (dr + 1) % n_acct


def orderfree_cases(rng, dev):
    """(name, mode, pk, n, ts_base, table, meta) cases at B = dk.B: a
    simple-like tight batch with not-found slots, same-account and
    ledger-mismatch failures (> FAIL_CAP of them); a lo batch of
    63-bit amounts; the same with an overflow-admission row; a full
    batch with high amount limbs, pending flags and overflowing
    timeouts."""
    B, n = dk.B, min(dk.B, 8190)
    cases = []
    table, meta = _tables(rng, A_ROWS, dev)

    dr, cr = _slots(rng, n, N_ACCOUNTS)
    pk = np.zeros((B, dk.N_COLS_TIGHT), np.uint32)
    pk[:n, 0] = dk.TIGHT_CODE_BIT
    pk[:n, 1] = dr + 1
    pk[:n, 2] = cr + 1
    pk[:n, 3] = rng.integers(1, 100, n)
    pk[:n, 4] = 1
    pk[:40, 1] = 0                       # debit account not found
    pk[40:70, 0] |= dk.BIT_SAME_ACCT     # accounts must be different
    odd = pk[70:100, 1].astype(np.int64) - 1
    meta_np = meta.cpu().numpy().copy()
    meta_np[odd, 1] = 2                  # ledger mismatch
    meta_t = torch.from_numpy(meta_np).to(dev)
    cases.append(("tight", dk.MODE_TIGHT, torch.from_numpy(pk.view(np.int32)).to(dev),
                  n, 1 << 40, table, meta_t))

    def wide(amt_hi_max, pending, timeouts):
        d, c = _slots(rng, n, N_ACCOUNTS)
        w = np.zeros((B, dk.N_COLS), np.uint64)
        w[:n, dk.COL_SLOTS] = (d + 1).astype(np.uint64) | (
            (c + 1).astype(np.uint64) << np.uint64(32)
        )
        w[:n, dk.COL_AMT_LO] = rng.integers(1, 1 << 63, n, dtype=np.int64).astype(np.uint64)
        if amt_hi_max:
            w[:n, dk.COL_AMT_HI] = rng.integers(0, amt_hi_max, n).astype(np.uint64)
        flags = np.where(rng.random(n) < pending, dk.F_PENDING, 0).astype(np.uint64)
        w[:n, dk.COL_MISC] = flags | np.uint64((1 << 16) | (1 << 32))  # code 1, ledger 1
        if timeouts:
            t = rng.integers(1, 1 << 31, n)
            w[:n, dk.COL_TIMEOUT] = np.where(flags != 0, t, 0).astype(np.uint64)
        return w, d

    w, _ = wide(0, 0.3, False)
    wide_t = lambda w: torch.from_numpy(w.view(np.int64)).to(dev)  # noqa: E731
    cases.append(("lo", dk.MODE_LO, wide_t(w), n, 1 << 40, table, meta))
    w, d = wide(0, 0.0, False)
    t_ov = table.clone()
    t_ov[int(d[0]), 2:4] = -1            # debits_posted = 2^128 - 1
    cases.append(("lo_overflow", dk.MODE_LO, wide_t(w), n, 1 << 40, t_ov, meta))
    w, _ = wide(1 << 20, 0.5, True)
    cases.append(("full", dk.MODE_FULL, wide_t(w), n,
                  (1 << 64) - 2_000_000_000_000_000_000, table, meta))
    return cases


def orderfree_bytes(mode, pk, n, table) -> int:
    """Least bytes K1 must move for this batch: the packed batch, the
    meta and balance rows of the distinct referenced slots (read), the
    touched balance rows (written), one ring row.  Returns (bytes,
    distinct rows)."""
    if mode == dk.MODE_TIGHT:
        w = pk[:n].to(torch.int64) & 0xFFFFFFFF
        slots = torch.cat([w[:, 1], w[:, 2]]) - 1
    else:
        s = pk[:n, dk.COL_SLOTS]
        slots = torch.cat([s & 0xFFFFFFFF, (s >> 32) & 0xFFFFFFFF]) - 1
    distinct = int(torch.unique(slots[slots >= 0]).numel())
    return pk.numel() * pk.element_size() + distinct * (8 + 64 + 64) + 512, distinct


def check_orderfree(rng, dev, report):
    ring = torch.zeros((RING_ROWS, dk.SUMMARY_WORDS), dtype=torch.int64, device=dev)
    for name, mode, pk, n, ts_base, table, meta in orderfree_cases(rng, dev):
        t_k, r_k = table.clone(), ring.clone()
        t_p, r_p = table.clone(), ring.clone()
        dk.orderfree(t_k, meta, r_k, 7, pk, n, ts_base, mode=mode)
        dk.orderfree_plain(t_p, meta, r_p, 7, pk, n, ts_base, mode=mode)
        torch.cuda.synchronize()
        err = max(max_abs_err(t_k, t_p), max_abs_err(r_k, r_p))
        summary = dk.unpack_summary(r_k[7].cpu().numpy().view(np.uint64))
        check(err == 0, f"K1 {name}: kernel differs from the plain version")
        scratch = dk.OrderfreeScratch(A_ROWS, dk.B, dev)
        args = (meta, r_k, 7, pk, n, ts_base)
        ms, dev_ms = kernel_ms(lambda: dk.orderfree(t_k, *args, mode=mode, scratch=scratch))
        plain_ms = time_ms(
            lambda: dk.orderfree_plain(t_p, meta, r_p, 7, pk, n, ts_base, mode=mode), reps=10
        )
        n_bytes, rows = orderfree_bytes(mode, pk, n, table)
        bound_ms, bound_by = bound(n_bytes, n * K1_OPS_PER_EVENT + rows * K1_OPS_PER_ROW)
        print(
            f"K1 orderfree[{name}]: bit-exact; n_fail={summary['n_fail']} "
            f"overflow={summary['overflow']} cap={summary['cap_exceeded']}; "
            f"{ms * 1e3:.1f} us/launch, {_dev(dev_ms)} {_vs(plain_ms, bound_ms)}"
        )
        if name == "tight":  # the main path's format
            report["orderfree"] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                       bound_by=bound_by, max_abs_err=err)


def check_commitment(rng, dev, report):
    table, meta = _tables(rng, A_ROWS, dev)
    rows = torch.arange(A_ROWS, dtype=torch.int64, device=dev)
    rh_k, dg_k = cm.rebuild(table, meta, rows)
    rh_p, dg_p = cm.rebuild_plain(table, meta, rows)
    torch.cuda.synchronize()
    err = max(max_abs_err(rh_k, rh_p), max_abs_err(dg_k, dg_p))
    check(err == 0, "K2 rebuild differs from the plain version")
    ms, dev_ms = kernel_ms(lambda: cm.rebuild(table, meta, rows))
    plain_ms = time_ms(lambda: cm.rebuild_plain(table, meta, rows), reps=10)
    bound_ms, bound_by = bound(A_ROWS * (64 + 8 + 8 + 16), A_ROWS * K2_OPS_PER_ROW)
    report["commit_rebuild"] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                    bound_by=bound_by, max_abs_err=err)
    print(f"K2 rebuild: bit-exact; {ms * 1e3:.1f} us, {_dev(dev_ms)} {_vs(plain_ms, bound_ms)}")

    # A window's touched rows at the simple phase's shape: 96 batches
    # x 2 x 8190 draws over 1M accounts, deduplicated and padded.
    touched = np.unique(rng.integers(0, N_ACCOUNTS, 96 * 2 * 8190))
    padded = torch.from_numpy(cm.pad_slots(touched)).to(dev)
    t_idx = torch.from_numpy(touched).to(dev)
    table[t_idx, 3] += 12345  # the window moved these rows
    meta[t_idx[:1000], 0] = 1
    rh_p2, dg_p2 = rh_p.clone(), dg_p.clone()
    cm.update(table, meta, rh_k, dg_k, padded, padded)
    cm.update_plain(table, meta, rh_p2, dg_p2, padded, padded)
    torch.cuda.synchronize()
    err_u = max(max_abs_err(rh_k, rh_p2), max_abs_err(dg_k, dg_p2))
    check(err_u == 0, "K2 update differs from the plain version")
    scratch_digest = cm.rebuild_plain(table, meta, rows)[1]
    check(torch.equal(dg_k, scratch_digest), "K2 update digest differs from a from-scratch digest")
    ms, dev_ms = kernel_ms(lambda: cm.update(table, meta, rh_k, dg_k, padded, padded))
    plain_ms = time_ms(lambda: cm.update_plain(table, meta, rh_p2, dg_p2, padded, padded), reps=10)
    k, u = len(padded), len(touched)
    bound_ms, bound_by = bound(k * 16 + u * (64 + 8 + 16 + 16), u * K2_OPS_PER_ROW)
    report["commit_update"] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                   bound_by=bound_by, max_abs_err=err_u)
    print(f"K2 update ({u} rows, {k} padded slots): bit-exact; {ms * 1e3:.1f} us, {_dev(dev_ms)} "
          f"{_vs(plain_ms, bound_ms)}")

    p_k = cm.probe(table, meta, dg_k, rows)
    p_p = cm.probe_plain(table, meta, dg_k, rows)
    torch.cuda.synchronize()
    err_p = max_abs_err(p_k, p_p)
    check(err_p == 0, "K2 probe differs from the plain version")
    check(torch.equal(p_k[0], p_k[1]), "K2 probe: maintained digest != from-scratch digest")
    ms, dev_ms = kernel_ms(lambda: cm.probe(table, meta, dg_k, rows))
    plain_ms = time_ms(lambda: cm.probe_plain(table, meta, dg_k, rows), reps=10)
    bound_ms, bound_by = bound(A_ROWS * (64 + 8 + 8) + 32, A_ROWS * K2_OPS_PER_ROW)
    report["commit_probe"] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                  bound_by=bound_by, max_abs_err=err_p)
    print(f"K2 probe: bit-exact; {ms * 1e3:.1f} us, {_dev(dev_ms)} {_vs(plain_ms, bound_ms)}")


# ---------------------------------------------------------------------------
# The main path: TorchStateMachine driven through the harness.


def failure_stream(n_batches: int, batch: int):
    """gen_simple over 1000 accounts, but 100 events per batch debit a
    nonexistent account and 20 name the same account twice: more than
    FAIL_CAP failures in every batch."""
    setup, _, _ = workload.gen_simple(batch, batch=batch)
    rng = np.random.default_rng(47)
    timed = []
    tid = workload.TID0
    for _ in range(n_batches):
        arr = np.zeros(batch, TRANSFER_DTYPE)
        dr = rng.integers(1, 1001, batch).astype(np.uint64)
        arr["id_lo"] = np.arange(tid, tid + batch, dtype=np.uint64)
        arr["debit_account_id_lo"] = dr
        arr["credit_account_id_lo"] = dr % np.uint64(1000) + np.uint64(1)
        arr["debit_account_id_lo"][:100] = 10_000_000
        arr["credit_account_id_lo"][100:120] = arr["debit_account_id_lo"][100:120]
        arr["amount_lo"] = rng.integers(1, 100, batch)
        arr["ledger"] = 1
        arr["code"] = 1
        timed.append((Operation.create_transfers, arr.tobytes()))
        tid += batch
    return setup, timed


def run_stream(setup, timed, account_capacity, transfer_capacity, plain, profile=False):
    """Drive one stream through the harness.  The launch counts are set
    to 0 just before the state machine is built and read just after the
    stream has drained.  Returns (machine, replies, seconds of the timed
    batches, launches, device trace or None)."""
    kernels.reset_launches()
    sm = TorchStateMachine(
        account_capacity=account_capacity, transfer_capacity=transfer_capacity,
        plain=plain,
    )
    h = SingleNodeHarness(sm)
    replies = [h.submit(op, body) for op, body in setup]
    torch.cuda.synchronize()
    for timer in ENGINE_TIMERS:  # count the timed batches only
        setattr(sm._dev, timer, 0.0)
    prof = device_profiler() if profile else contextlib.nullcontext()
    with prof:
        t0 = time.perf_counter()
        futs = [h.submit_async(op, body) for op, body in timed]
        replies += [f.result() for f in futs]
        sm._dev.drain()
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    launches = dict(kernels.launches)
    return sm, replies, elapsed, launches, (device_busy(prof) if profile else None)


def device_profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def device_busy(prof) -> tuple[float, list] | None:
    """(milliseconds in which the device ran a kernel or a copy: the
    union of the trace's device intervals; the four device functions
    with the most time, as (name, ms)), or None when the trace holds no
    device activity."""
    from torch.autograd import DeviceType

    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        return None
    busy_us, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in events):
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    by_name: dict[str, float] = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return busy_us / 1e3, [(name[:48], round(us / 1e3, 3)) for name, us in top]


# Host wall-clock split of the engine (upload + launch enqueue, ring
# fetch = the one device synchronisation per window, host bookkeeping).
ENGINE_TIMERS = ("stat_t_h2d", "stat_t_dispatch", "stat_t_fetch", "stat_t_finish")


def transfer_events(ops) -> int:
    return sum(
        len(body) // TRANSFER_DTYPE.itemsize
        for op, body in ops if op == Operation.create_transfers
    )


def run_phase(name, setup, timed, account_capacity, expect_fallbacks):
    """Run one phase; returns its main-path and check launch counts."""
    transfer_capacity = transfer_events(setup + timed) + 1024
    sm, replies, elapsed, launches, _ = run_stream(
        setup, timed, account_capacity, transfer_capacity, False
    )
    check(launches["orderfree"] > 0, f"{name}: K1 was not launched")
    check(launches["commit_probe"] == 0, f"{name}: the main path launched K2 probe")
    n_transfers = transfer_events(setup + timed)
    n_timed = transfer_events(timed)
    dev = sm._dev
    if expect_fallbacks:
        check(dev.stat_fallback_batches > 0, f"{name}: no batch was flagged")
        check(launches["commit_rebuild"] > 1, f"{name}: recovery did not rebuild the digest")
        check(
            sm.stat_device_semantic_events + sm.stat_fallback_events == n_transfers,
            f"{name}: device + re-executed events != submitted events",
        )
    else:
        check(dev.stat_fallback_batches == 0 and sm.stat_fallback_events == 0,
              f"{name}: unexpected fallback")
        check(sm.stat_device_semantic_events == n_transfers,
              f"{name}: {sm.stat_device_semantic_events} device events != {n_transfers}")
    kernels.reset_launches()
    sm.verify_device_mirror()
    pair = dev.commit_probe()
    check_launches = dict(kernels.launches)
    root = sm.state_root()
    check(cm.root_bytes(pair[0]) == root and cm.root_bytes(pair[1]) == root,
          f"{name}: device digest != host root")
    split = " ".join(f"{t[7:]}={getattr(dev, t):.3f}s" for t in ENGINE_TIMERS)
    tables = dev.to_numpy_tables()
    del sm, dev
    torch.cuda.empty_cache()

    ref, ref_replies, ref_elapsed, _, _ = run_stream(
        setup, timed, account_capacity, transfer_capacity, True
    )
    check(ref_replies == replies, f"{name}: replies differ from the plain-version run")
    check(ref.state_root() == root, f"{name}: state root differs from the plain-version run")
    ref_tables = ref._dev.to_numpy_tables()
    check(all((a == b).all() for a, b in zip(tables, ref_tables)),
          f"{name}: device tables differ from the plain-version run")
    del ref
    torch.cuda.empty_cache()

    prof_sm, prof_replies, prof_elapsed, _, trace = run_stream(
        setup, timed, account_capacity, transfer_capacity, False, profile=True
    )
    check(prof_replies == replies, f"{name}: replies differ in the profiled run")
    del prof_sm
    torch.cuda.empty_cache()
    busy = "not measured (no device activity in the trace)"
    if trace is not None:
        busy_ms, top = trace
        busy = (f"{busy_ms:.3f} ms of the profiled run's {prof_elapsed:.3f} s "
                f"(busy share {busy_ms / 1e3 / prof_elapsed:.6f}; "
                f"{n_timed / prof_elapsed:.0f} events/s under the profiler); top {top}")
    print(
        f"phase {name}: {n_timed} timed events in {elapsed:.3f} s = "
        f"{n_timed / elapsed:.0f} events/s "
        f"(plain-version run {n_timed / ref_elapsed:.0f} events/s); "
        f"main-path launches {launches}; check launches {check_launches}; "
        f"device busy {busy}; engine split {split}; root {root.hex()}; checks passed"
    )
    return launches, check_launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    built = build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s: {sorted(built)}")
    for name in build.SOURCES:
        for line in build.log_path(name).read_text().splitlines() if built else []:
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(2026)

    report: dict[str, dict] = {}
    check_orderfree(rng, dev, report)
    check_commitment(rng, dev, report)

    phases = {}
    setup, timed, sizing = workload.gen_simple(N_TRANSFERS, n_accounts=N_ACCOUNTS)
    check(sizing[0] == A_ROWS, "simple phase: table is not 2^20 rows")
    phases["simple"] = run_phase("simple", setup, timed, sizing[0], False)
    setup, timed, sizing = workload.gen_zipf(N_TRANSFERS)
    phases["zipf"] = run_phase("zipf", setup, timed, sizing[0], False)
    setup, timed = failure_stream(24, workload.BATCH)
    phases["failures"] = run_phase("failures", setup, timed, A_ROWS, True)
    for name in MAIN_PATH:
        check(sum(p[0][name] for p in phases.values()) > 0,
              f"kernel {name} was not launched on the main path")

    meta = {
        "orderfree": ("tigerbeetle_tpu_torch/csrc/orderfree.cu",
                      "tigerbeetle_tpu/state_machine/device_kernels.py:436"),
        "commit_update": ("tigerbeetle_tpu_torch/csrc/commitment.cu",
                          "tigerbeetle_tpu/state_machine/commitment.py:339"),
        "commit_rebuild": ("tigerbeetle_tpu_torch/csrc/commitment.cu",
                           "tigerbeetle_tpu/state_machine/commitment.py:335"),
        "commit_probe": ("tigerbeetle_tpu_torch/csrc/commitment.cu",
                         "tigerbeetle_tpu/state_machine/commitment.py:379"),
    }
    rows = []
    for name, (source, replaces) in meta.items():
        r = report[name]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "on_main_path": name in MAIN_PATH,
            "launches": sum(p[0][name] for p in phases.values()),
            "launches_by_phase": {ph: p[0][name] for ph, p in phases.items()},
            "check_launches": sum(p[1][name] for p in phases.values()),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None, "verified": True,
        })
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

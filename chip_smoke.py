#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the hand-written kernels (csrc/*.cu, one nvcc per source, in
parallel), holds every kernel against its plain PyTorch version at the
main path's shapes (bit-exact: the semantics are integer; K1 on six
8190-event batches — tight, lo, lo with an overflowing row, full, a
gen_zipf-skewed tight batch, a tight batch on a compact 2^18-row table —
with its one launch a call and stage stamps from tools/serial_probes.py;
K3 on full
8190-event batches of every class, its plain version on CPU copies; K5
and K6 on 8192-event batches over a 2^20-row table; K7 over an
8190-lane wave with and without a commit mask, K8 over 8 positions x
4096 chains with dead chains and shared credited accounts (one cluster
of 16 blocks; its barrier floor, from tools/serial_probes.py, and four
more chain shapes), K9 over an
8190-event batch, a K3 segment resumed mid-batch from a K7 carry, K3's
init and finalize, all on a 2^20-row table, and K3 segments of 1, 8, 59
and 512 events for its fixed and per-event cost; K10 at 128 and 16,384 rows
into a 2^20-row table beside Tensor.index_copy_, K2 admit at 16,384
and 80 slots (each beside an empty kernel of its launch shape) and
with slots past the table, K2 update with slots past the table, K11
over a (2^20, 8) balance table and a (2^20, 2) meta table holding words
>= 2^31; K12 and K13 over an 8190-event slice onto 2^18
local rows of a 2^20-row table split in 4 (K13 admit also at the
sharded_apply phase's 4095-event slice of 2^19 rows), K14 gather and scatter at
row widths 8, 2 and 1 on 16,380 slots (a wave batch) and on the
~780,000 rows of a window unit of sharded_engine, K11 with row0 on the four
shards of a split table against the joined table's digest; the
launchers scan_of, for every kind at G = 4, and staged, for the five
*_staged names at g = 0, G - 1, G and -1, on full batches over a
2^20-row table, against their plain loops and one launch per batch),
measures one dependent L2 hit (K3's and K5's serial floors), then
builds the host engine's native library (g++, csrc/host/; its path,
digest and build seconds on a line of their own), then drives the
port's create_transfers loop through SingleNodeHarness on
TorchStateMachine in fourteen phases, the two row-sharded entry points
in two more, the row-sharded engines in two more, the graft entry and
the launcher probes in two more, and the device engine's lifecycle, the
queries and checkpoint snapshot / restore in three more:

  simple       device engine, a 2^20-row table, 1,000,000 accounts,
               1,000,000 transfers in 8190-event batches (K1)
  zipf         device engine, 100 accounts, p ~ 1/rank, 1,000,000
               transfers (K1)
  failures     device engine, more than 60 invalid events per batch, so
               every batch is flagged and exact recovery runs, and a
               last batch whose re-execution ranks overflow codes (K3;
               TB_FASTPATH_DISABLE=1, or the native lanes would re-execute);
               a native-on arm (the default route: recovery re-executes
               in the native lanes) flags the same batches, and its
               replies, root, tripwire and digest equal the main path's
  linked       device engine, bench's gen_linked: 1,000 accounts, half
               debit-limited and funded, chains of 1-7, 250,000 transfers
               (K5 per batch; the funding batch, on limit accounts,
               rides a window wave record)
  two_phase    device engine, gen_two_phase widened to 1,000,000
               accounts: pending -> post | void pairs, 250,000 transfers
               (K6 per batch)
  offkernel    device engine, gen_offkernel at 1,000,001 accounts: post
               pairs with balancing riders (speculated: K9, K7 with a
               commit mask, the posts' residue as one K7 wave) and
               3-member chains that start with a pending (one K8 chain
               wave), 32 batches; replies and root equal a
               TB_DEV_WAVES=0 run (every batch drained to the host path's
               wave plans) and a TB_DEV_WAVES=0 TB_WAVES=scan run (K3), both
               under TB_FASTPATH_DISABLE=1, and a TB_DEV_WAVES=0 run with
               the native library on (its serial exact engine)
  expiry       device engine, 8 batches of 8190 pendings with timeouts
               of 1-8 s on 1,000,000 accounts (K1), then the realtime
               moves past every expiry and the pulses release them all
               (write-behind lane, K4)
  simple_host  host engine, gen_simple at 1,000,000 accounts and
               1,000,000 transfers: the native order-free lane, every
               batch through its hot tail, K4 flushes; replies and root
               equal a TB_FASTPATH_DISABLE=1 run (mirror admission)
  waves_host   host engine, TB_WAVES=exact, TB_FASTPATH_DISABLE=1
               (the native and Python linked lanes would take its
               batches), gen_waves_host: per batch
               ~90 % transfers between random pairs of 1,000,000
               accounts around 8 runs of limit-reading chains over 1,000
               funded accounts, 32 batches: every batch a wave plan (K7
               waves, K3 segments for the chain runs); replies and root
               equal a TB_WAVES=scan run
  linked_host  host engine, the linked phase's stream: the native
               linked lane takes every chain batch, K4 flushes
  two_phase_host  host engine, the two_phase phase's stream: the native
               two-phase lane takes every post / void batch
  exact_host   host engine, the offkernel phase's stream: its balancing
               riders keep every timed batch off the resolvers, so the
               native serial exact engine takes them.  Each of these
               three prints its host split (the native calls, the
               flushes, the rest) and holds its replies and root to a
               TB_FASTPATH_DISABLE=1 run (the Python lanes and the exact
               path on the card) and a TB_WAVES=scan run (K3)
  tiered       device engine, TB_HOT_CAPACITY=2^20 under 10,485,760
               accounts: bench's tiering stream (head 786,432 accounts,
               tail mass 0.008), 48 warm-up batches sweeping the head,
               then 64 timed batches submitted one at a time (K1 on hot
               slots, K10 + K2 admit per admission; the slots of every
               K2 admit launch: the census); replies and root equal the
               plain-version run and an all-resident control
  tiered_host  host engine, the same stream on the native lanes (K10
               admissions, K4 flushes; its run ends with the checkpoint
               tripwire, K11), plus a TB_FASTPATH_DISABLE=1 arm
  sharded_apply  parallel.sharded.build_apply_step on a 2 x 2 (dp, shard)
               mesh of the one card over a 2^20-row table: gen_simple's
               1,000,000 transfers at 1,000,000 accounts decoded to slot
               columns, then a batch onto 64 rows seeded near 2^128 (K12,
               K13); table and admitted masks equal a numpy oracle's and
               a plain-version run's
  sharded_waves  waves._execute_plan_sharded on a 4-shard row mesh of the
               one card: 32 full 8190-event batches (one wave; a chain
               wave, then a wave; wave, chains, wave, chains), each on
               its own rows of one 2^20-row table, run one after another
               (K14, K7, K8, K3 init and finalize), timed three times;
               packed outputs and the joined table equal the dense
               executor's and a plain-version run's
  sharded_engine  device engine, devices=[cuda:0] * 4: its tables in 4
               shards of a 2^20-row table.  gen_simple's 1,000,000
               transfers (K1 window units and their K2 updates on one
               compact table: K14 gathers and scatters around it, K2 rebuild per
               shard), then 32 full batches of pending / post pairs with
               balancing riders under TB_DEV_WAVES=1 (wave records
               through the sharded executor; two batches with a pending
               between history accounts decline "shard_plan" and drain to
               the native exact engine; a TB_FASTPATH_DISABLE=1 arm takes
               them through K3 on the joined table and write_back, its
               replies, root, tables and K11 digest equal); no
               speculation.  Each stream timed three times; replies,
               lookups, root, tables and the K11 digest equal the
               unsharded engine's and a plain-version sharded run's
  sharded_host  host engine on the same mesh, TB_FASTPATH_DISABLE=1:
               gen_simple's stream (K4 flushes on compact rows) and one
               batch of chains opened by pendings (the exact path on the
               joined table, written back onto the shards),
               ending with the checkpoint tripwire (K11 per shard);
               timed three times, held as sharded_engine is
  graft_entry  graft_entry.entry() (K3 on the reference's example),
               held to its plain run on the CPU; dryrun_multichip(4)
               on four cards, or the first card four times: the
               sharded apply step (K12, K13), a linked batch through K3
               on a row-sharded table (K14), the sharded device engine
               and its wave dispatch, each against the CPU oracle
  probes       the seven experiments probes at 2^20 rows and their own
               repetitions (scan_of, staged: K1, K5, K6), each ending
               with its table and ring held to a batch-by-batch replay
  lifecycle    device engine, a 2^20-row table, the service stream
               (600,000 accounts, 146 of them with history; 24 batches of
               8190: random transfers (K1), pendings and their posts /
               voids (K6), batches naming history accounts (speculated));
               windows of 4 batches: a third healthy, then
               ChaosLink.kill() with a window in flight, a third degraded
               (the demotion replays it on the host; no launch on the
               card), heal(), the rest (tick re-promotes: probe, upload,
               K2 rebuild, handshake); replies and root equal the
               port's oracle (CpuStateMachine).
               Then one wrong word in the card's balance table: the scrub
               (K2 probe) names the row and heals it, the root unchanged
  queries      the service stream on each engine, then 154
               get_account_transfers / get_account_balances queries
               (history and plain accounts, each direction, reversed,
               limits, a timestamp window), byte-equal to the oracle
  snapshot     half the service stream, snapshot, restore into a fresh
               machine (sized from the account count as the reference
               does: 2^20 rows), the rest: replies and root equal the
               oracle's, on the device engine, the host engine and the
               device engine under TB_HOT_CAPACITY=65536

All the shards of a mesh lie on the one card: copies between shards
are device-local, and no time here is a multi-GPU one.

Each phase's main-path run starts with every launch count at 0 (set
just before the state machine is built) and its counts are read as soon
as the stream has drained, before any check launches anything.  After
each phase: no demotion and no link error outside the lifecycle phase,
K2 probe launches == the scrubs' cheap compares (one a shard), K3
launches == exact batches, K5 and K6 launches == the
batches the device engine's router sent them (the linked and two-phase
batches the host path's lanes took launch neither), K3's finalize launches == the wave and
speculative batches executed, every event was resolved (no exception),
the device table equals the host mirror, the device digest
equals its from-scratch recompute and the host root, and replies, root
and tables equal a second run of the same stream with the plain
versions on the card.  A third run, under torch.profiler, gives the
device's busy time: the union of its kernel and copy intervals, and how
many of its K4 launches the trace holds.

Each kernel is timed three ways: CUDA events around one call (`ms`, the
host's launch work included), the profiler's device time (`device_ms`)
and the host time per call of 200 back-to-back calls and one sync
(`host_ms`); K10's host time is also split into its pieces
(tools/launch_split.py).

Prints the card's name and power limit, one line per phase, a JSON line
listing every kernel (main-path launches in total and per phase, check
launches, error against the plain version, times, bound), and as its
last line {"ok": true, "device": {...}}.  Exits non-zero without a CUDA
device or on any failed check.
"""

from __future__ import annotations

import collections
import contextlib
import importlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from tigerbeetle_tpu_torch import kernels
from tigerbeetle_tpu_torch import workload
from tigerbeetle_tpu_torch.kernels import build
from tigerbeetle_tpu_torch.state_machine import commitment as cm
from tigerbeetle_tpu_torch.ops.u128 import to_u64
from tigerbeetle_tpu_torch.parallel import sharded
from tigerbeetle_tpu_torch.runtime import fastpath
from tigerbeetle_tpu_torch.state_machine import device_kernels as dk
from tigerbeetle_tpu_torch.state_machine import kernel as k3
from tigerbeetle_tpu_torch.state_machine import waves
from tigerbeetle_tpu_torch.state_machine.gpu import TorchStateMachine
from tigerbeetle_tpu_torch.state_machine.cpu import CpuStateMachine
from tigerbeetle_tpu_torch.testing.chaos import ChaosLink
from tigerbeetle_tpu_torch.testing import orderfree_cases as of_cases
from tigerbeetle_tpu_torch.testing import (flush_cases, scan_cases, semantic_cases,
                                          shard_cases, wave_cases)
from tigerbeetle_tpu_torch.testing.harness import SingleNodeHarness, ids_bytes
from tigerbeetle_tpu_torch.tools import launch_split, serial_probes
from tigerbeetle_tpu_torch.types import (ACCOUNT_FILTER_DTYPE, TRANSFER_DTYPE,
                                         AccountFilterFlags, AccountFlags, EngineState,
                                         Operation, TransferFlags)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak (NVIDIA data sheet)
# The data sheet gives no integer rate outside the tensor cores; the
# kernels' 64-bit integer operations are counted against its float32
# CUDA-core rate, 67 TFLOP/s.
OPS_PER_S = 67e12
# 64-bit integer operations per unit of work, counted from the sources:
# K1 per event (decode + ladder + timeout check + accumulate) and per
# touched row (limb recombination, u128 adds, overflow checks, write);
# K2 per hashed row (11 splitmix64 finalizers, the xors and the fold).
# K3 per event (the body's ladders, u128 adds and compares, the record
# and undo writes); K4 per entry (two adds, a compare, the drop test).
K1_OPS_PER_EVENT = 80
# K7 per lane (the scan body's ladders, u128 compares and adds, record,
# snapshot rows, atomics), K8 per active cell (the normal path and the
# chain terms), K9 per lane (the token and slot entries, their minima
# and reads).
K7_OPS_PER_LANE = 400
K8_OPS_PER_CELL = 250
K9_OPS_PER_LANE = 60
K1_OPS_PER_ROW = 120
K2_OPS_PER_ROW = 140
K3_OPS_PER_EVENT = 400
K4_OPS_PER_ENTRY = 8
# K5 per event (decode, ladder, key) and per limit entry and fixpoint
# iteration (two scans' adds, the verdict's u64 sums and compares); K6
# per event (decode, both ladders, the target's ladder, the limbs).
K5_OPS_PER_EVENT = 60
K5_OPS_PER_ENTRY_ITER = 40
K6_OPS_PER_EVENT = 120
# K5's dependent passes per fixpoint iteration, each reading what
# another thread wrote in the pass before (counted at one L2 round trip
# each, though K5 keeps them in shared memory): the failure prefix, the
# chain state, the amount lanes' prefix, the verdicts, the pass update;
# and the cluster barriers between them.
K5_PASSES_PER_ITER = 5
K5_BARRIERS_PER_ITER = 4
A_ROWS = 1 << 20
N_TRANSFERS = 1_000_000
N_ACCOUNTS = 1_000_000
N_EXACT = 250_000
OFFKERNEL_ACCOUNTS = 1_000_001
WAVE_BATCHES = 32
RING_ROWS = 256
# Kernels the main path launches (K2 probe: the device engine's scrub,
# every TB_DEV_SCRUB_EVERY ring fetches while no record is in flight).
MAIN_PATH = ("orderfree", "commit_update", "commit_rebuild", "commit_probe", "exact_scan",
             "apply_deltas",
             "linked", "two_phase", "exact_init", "exact_segment", "exact_finalize",
             "wave_step", "chain_wave", "spec_conflicts", "tier_set_rows", "commit_admit",
             "checksum", "shard_accumulate", "shard_admit", "shard_apply", "shard_gather",
             "shard_scatter", "scan_of", "staged")
# K3's classes for the kernel check, and the codes each must produce.
K3_CLASSES = {
    "linked": {1, 2},
    "post_void": {25, 26, 33, 34},
    "balancing": {54, 55},
    "limits": {54, 55},
    "overflow": {47, 48, 49, 50, 51, 52},
    "history": set(),
    "overdue": {35},
    "timeout_overflow": {53},
    "exists": {36, 37, 39, 46},
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi unavailable"


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_ms(fn, reps: int = 30, warm: int = 3, reset=None) -> float:
    """Median milliseconds per call, CUDA events around each call;
    `reset()` (outside the events) restores what a call changed."""
    for _ in range(warm):
        if reset is not None:
            reset()
        fn()
    times = []
    for _ in range(reps):
        if reset is not None:
            reset()
        times.append(_event_ms(fn))
    return float(np.median(times))


def _event_ms(fn) -> float:
    """Milliseconds of one call of `fn`, CUDA events around it."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def device_ms(fn, reps: int = 20, reset=None, names=None) -> float | None:
    """Device time per call: the card's own kernel time (torch.profiler,
    CUDA activity) summed over `reps` calls, divided by `reps`.  Unlike
    time_ms it excludes the host's launch work.  `names` keeps only the
    device functions whose name holds one of them (so a `reset`'s copies
    do not count).  None when the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if reset is not None:
                reset()
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        if names is not None and not any(k in e.key for k in names):
            continue
        total_us += getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0
        )
    return total_us / reps / 1e3 if total_us > 0 else None


HOST_REPS = 200  # back-to-back calls per host time


def host_ms(fn, reset=None, reps: int = HOST_REPS) -> float:
    """Host milliseconds per call: time.perf_counter around `reps`
    back-to-back calls with no sync inside, then one
    torch.cuda.synchronize(), over `reps`.  While the host is slower
    than the card this is the host's work per call (checks, launch
    path, cudaLaunchKernel); a kernel that takes the card longer than
    its launch fills the queue, and the figure reads the card's time.
    With `reset`, the same time of `reset` alone is subtracted."""

    def per_call(f) -> float:
        f()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            f()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    if reset is None:
        return per_call(fn)

    def both():
        reset()
        fn()

    return per_call(both) - per_call(reset)


def kernel_ms(fn, reset=None, names=None) -> tuple[float, float | None, float]:
    """(CUDA-event time per call, host launch work included; device
    time per call from the profiler; host time per call, host_ms)."""
    return (time_ms(fn, reset=reset), device_ms(fn, reset=reset, names=names),
            host_ms(fn, reset=reset))


YARDSTICK_REPS = 200  # CUDA-event calls of each side in paired_ms


def paired_ms(fn, library, names=None) -> tuple[tuple, tuple]:
    """kernel_ms of a kernel (`fn`) and of the PyTorch call that computes
    the same function (`library`), the CUDA-event times taken in turns
    (fn, library, fn, ...; YARDSTICK_REPS calls each, medians): the two
    sit within a few µs of each other near the card's launch floor, and
    the host's speed drifts within a run by more than that."""
    for _ in range(3):
        fn()
        library()
    times = ([], [])
    for _ in range(YARDSTICK_REPS):
        times[0].append(_event_ms(fn))
        times[1].append(_event_ms(library))
    ms, lib_ms = (float(np.median(t)) for t in times)
    return ((ms, device_ms(fn, names=names), host_ms(fn)),
            (lib_ms, device_ms(library), host_ms(library)))


def _dev(ms: float | None, host: float | None = None) -> str:
    out = "device time not measured" if ms is None else f"{ms * 1e3:.1f} us on the device"
    return out if host is None else f"{out}, host {host * 1e3:.1f} us/call"


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """Least milliseconds the card could take: the larger of the bytes
    over the memory rate and the operations over the peak rate."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _dev_us(us: float | None) -> str:
    return "not measured" if us is None else f"{us:.1f} us"


def _vs(plain_ms: float, bound_ms: float) -> str:
    return f"(plain {plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.3f} us)"


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |a - b| over int64 lanes (exact as Python ints)."""
    a, b = a.cpu(), b.cpu()
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
    timeouts; a skewed tight batch (gen_zipf's 100 accounts); a tight
    batch on a compact table of one 2^18-row shard of the sharded
    engine."""
    B, n = dk.B, min(dk.B, 8190)
    cases = []
    table, meta = _tables(rng, A_ROWS, dev)
    to = lambda a, dt: torch.from_numpy(a.view(dt)).to(dev)  # noqa: E731

    pk, meta_np = of_cases.tight(rng, B, n, N_ACCOUNTS, meta.cpu().numpy().view(np.uint32))
    cases.append(("tight", dk.MODE_TIGHT, to(pk, np.int32), n, 1 << 40, table,
                  to(meta_np, np.int32)))

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
    for name, (tab, met, pk, n_) in (
            ("skewed", of_cases.skewed(2061, B, n, A_ROWS)),
            ("compact", of_cases.compact(2062, B, n))):
        cases.append((name, dk.MODE_TIGHT, to(pk, np.int32), n_, 1 << 40, to(tab, np.int64),
                      to(met, np.int32)))
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
    """K1 against its plain version on every case of orderfree_cases,
    bit for bit, with µs/call, device µs and host µs beside the bound;
    "tight", the main path's format, is the kernels line's timed case.
    Then tools/serial_probes.py's k1 part: one kernel a call, device µs
    on its timed cases, and the stage stamps."""
    ring = torch.zeros((RING_ROWS, dk.SUMMARY_WORDS), dtype=torch.int64, device=dev)
    scratch = dk.OrderfreeScratch(dk.B, dev)
    by_case = {}
    for name, mode, pk, n, ts_base, table, meta in orderfree_cases(rng, dev):
        t_k, r_k = table.clone(), ring.clone()
        t_p, r_p = table.clone(), ring.clone()
        dk.orderfree(t_k, meta, r_k, 7, pk, n, ts_base, mode=mode, scratch=scratch)
        dk.orderfree_plain(t_p, meta, r_p, 7, pk, n, ts_base, mode=mode)
        torch.cuda.synchronize()
        err = max(max_abs_err(t_k, t_p), max_abs_err(r_k, r_p))
        summary = dk.unpack_summary(r_k[7].cpu().numpy().view(np.uint64))
        check(err == 0, f"K1 {name}: kernel differs from the plain version")
        args = (meta, r_k, 7, pk, n, ts_base)
        ms, dev_ms, host = kernel_ms(lambda: dk.orderfree(t_k, *args, mode=mode, scratch=scratch))
        plain_ms = time_ms(
            lambda: dk.orderfree_plain(t_p, meta, r_p, 7, pk, n, ts_base, mode=mode), reps=10
        )
        n_bytes, rows = orderfree_bytes(mode, pk, n, table)
        bound_ms, bound_by = bound(n_bytes, n * K1_OPS_PER_EVENT + rows * K1_OPS_PER_ROW)
        print(
            f"K1 orderfree[{name}] ({table.shape[0]} rows, {rows} distinct rows named): "
            f"bit-exact; n_fail={summary['n_fail']} "
            f"overflow={summary['overflow']} cap={summary['cap_exceeded']}; "
            f"{ms * 1e3:.1f} us/launch, {_dev(dev_ms, host)} {_vs(plain_ms, bound_ms)}"
        )
        by_case[name] = dict(ms=ms, device_ms=dev_ms, host_ms=host, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
                             rows=table.shape[0], distinct_rows=rows)
    report["orderfree"] = dict(by_case["tight"], cases=by_case, timed_case="tight")
    report["orderfree"]["max_abs_err"] = max(c["max_abs_err"] for c in by_case.values())
    sweep = serial_probes.k1_sweep(dev)
    for name in ("tight", "skewed", "compact"):
        row = sweep[name]
        check(row["plain_equal"], f"K1 probe {name}: kernel differs from the plain version")
        check(row["kernels_per_call"] == 1,
              f"K1 probe {name}: {row['kernels_per_call']} kernels a call, not one")
        print(f"K1 probe[{name}]: {row['kernels_per_call']:.0f} kernel a call, "
              f"{_dev_us(row['device_us'])} on the device; stamped {row['stamped_us']:.2f} us, "
              f"cycles per stage {({k: int(v) for k, v in row['stage_cycles'].items()})}")
    report["orderfree"]["sweep"] = sweep


def check_commitment(rng, dev, report):
    table, meta = _tables(rng, A_ROWS, dev)
    rows = torch.arange(A_ROWS, dtype=torch.int64, device=dev)
    rh_k, dg_k = cm.rebuild(table, meta, rows)
    rh_p, dg_p = cm.rebuild_plain(table, meta, rows)
    torch.cuda.synchronize()
    err = max(max_abs_err(rh_k, rh_p), max_abs_err(dg_k, dg_p))
    check(err == 0, "K2 rebuild differs from the plain version")
    ms, dev_ms, host = kernel_ms(lambda: cm.rebuild(table, meta, rows))
    plain_ms = time_ms(lambda: cm.rebuild_plain(table, meta, rows), reps=10)
    bound_ms, bound_by = bound(A_ROWS * (64 + 8 + 8 + 16), A_ROWS * K2_OPS_PER_ROW)
    report["commit_rebuild"] = dict(ms=ms, device_ms=dev_ms, host_ms=host,
                                    plain_ms=plain_ms, bound_ms=bound_ms,
                                    bound_by=bound_by, max_abs_err=err)
    print(f"K2 rebuild: bit-exact; {ms * 1e3:.1f} us, {_dev(dev_ms, host)} "
          f"{_vs(plain_ms, bound_ms)}")

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
    ms, dev_ms, host = kernel_ms(lambda: cm.update(table, meta, rh_k, dg_k, padded, padded))
    plain_ms = time_ms(lambda: cm.update_plain(table, meta, rh_p2, dg_p2, padded, padded), reps=10)
    k, u = len(padded), len(touched)
    bound_ms, bound_by = bound(k * 16 + u * (64 + 8 + 16 + 16), u * K2_OPS_PER_ROW)
    report["commit_update"] = dict(ms=ms, device_ms=dev_ms, host_ms=host,
                                   plain_ms=plain_ms, bound_ms=bound_ms,
                                   bound_by=bound_by, max_abs_err=err_u)
    print(f"K2 update ({u} rows, {k} padded slots): bit-exact; {ms * 1e3:.1f} us, "
          f"{_dev(dev_ms, host)} "
          f"{_vs(plain_ms, bound_ms)}")

    # Slots past the table (live in the reference: row A-1 before the
    # call), one of them beside the lane that owns row A-1.
    past = torch.tensor([A_ROWS + 5, 17, A_ROWS - 1, A_ROWS, -1], device=dev)
    got = cm.update(table, meta, rh_k.clone(), dg_k.clone(), past, past.abs())
    want = cm.update_plain(table, meta, rh_k.clone(), dg_k.clone(), past, past.abs())
    torch.cuda.synchronize()
    err_past = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
    check(err_past == 0, "K2 update with slots past the table differs from the plain version")
    report["commit_update"]["max_abs_err"] = max(err_u, err_past)
    print("K2 update (slots past the table beside the owner of row A-1): bit-exact")

    p_k = cm.probe(table, meta, dg_k, rows)
    p_p = cm.probe_plain(table, meta, dg_k, rows)
    torch.cuda.synchronize()
    err_p = max_abs_err(p_k, p_p)
    check(err_p == 0, "K2 probe differs from the plain version")
    check(torch.equal(p_k[0], p_k[1]), "K2 probe: maintained digest != from-scratch digest")
    ms, dev_ms, host = kernel_ms(lambda: cm.probe(table, meta, dg_k, rows))
    plain_ms = time_ms(lambda: cm.probe_plain(table, meta, dg_k, rows), reps=10)
    bound_ms, bound_by = bound(A_ROWS * (64 + 8 + 8) + 32, A_ROWS * K2_OPS_PER_ROW)
    report["commit_probe"] = dict(ms=ms, device_ms=dev_ms, host_ms=host,
                                  plain_ms=plain_ms, bound_ms=bound_ms,
                                  bound_by=bound_by, max_abs_err=err_p)
    print(f"K2 probe: bit-exact; {ms * 1e3:.1f} us, {_dev(dev_ms, host)} {_vs(plain_ms, bound_ms)}")


def l2_hit_ns(dev) -> float:
    """One dependent L2 hit on this card: a single thread chases a random
    single-cycle permutation of 2^20 u32 indices (4 MiB: above L1, far
    below the 50 MB L2), warmed by one full cycle, then timed over a
    second one with CUDA events."""
    n = 1 << 20
    rng = np.random.default_rng(5)
    order = rng.permutation(n)
    nxt = np.empty(n, np.int32)
    nxt[order] = np.roll(order, -1)  # one cycle through every index
    nxt_t = torch.from_numpy(nxt).to(dev)
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    kernels.l2_chase(nxt_t, n, sink)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    kernels.l2_chase(nxt_t, n, sink)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e6 / n


def check_exact(dev, report, l2_ns):
    """K3 against its plain version (run on CPU copies of the same
    inputs) on full 8190-event batches of every class over a 2^20-row
    table, slots drawn from 8192 rows so events depend on each other;
    bit-exact on the table and the whole (8192, 37) output."""
    rng = np.random.default_rng(2027)
    pool = np.sort(rng.choice(A_ROWS, 8192, replace=False))
    scratch = k3.ExactScratch(8192, dev)
    for k, (cls, want) in enumerate(K3_CLASSES.items()):
        table, ev, dstat, n, ts_base = scan_cases.make_case(
            7000 + k, 8192, cls, A=A_ROWS, rows=pool, n=8190
        )
        pk = torch.from_numpy(k3.pack_events(ev).view(np.int64))
        ds = torch.from_numpy(dstat.view(np.int32))
        t_cpu = torch.from_numpy(table.view(np.int64).copy())
        t0 = time.perf_counter()
        _, out_p = k3.run_create_transfers(t_cpu, pk, ds, n, ts_base)
        plain_ms = (time.perf_counter() - t0) * 1e3
        t_k = torch.from_numpy(table.view(np.int64).copy()).to(dev)
        pk_k, ds_k = pk.to(dev), ds.to(dev)
        _, out_k = k3.run_create_transfers(t_k, pk_k, ds_k, n, ts_base, scratch=scratch)
        torch.cuda.synchronize()
        err = max(max_abs_err(out_k, out_p), max_abs_err(t_k, t_cpu))
        check(err == 0, f"K3 {cls}: kernel differs from the plain version")
        codes = set(k3.unpack_outputs(to_u64(out_p))["results"][:n].tolist())
        check(want <= codes, f"K3 {cls}: codes {sorted(want - codes)} not reached")
        line = f"K3 exact_scan[{cls}]: bit-exact; {len(codes)} distinct codes"
        if cls == "linked":  # the main path's dominant class: time it
            ms, dev_ms, host = kernel_ms(
                lambda: k3.run_create_transfers(t_k, pk_k, ds_k, n, ts_base, scratch=scratch)
            )
            rows = len(np.unique(np.clip(pk.numpy()[:n, [k3.COL["dr_slot"], k3.COL["cr_slot"]]], 0, None)))
            n_bytes = pk.numel() * 8 + 8192 * k3.N_COLS * 8 + 8192 * 4 + rows * 64 * 2
            bound_ms, bound_by = bound(n_bytes, n * K3_OPS_PER_EVENT)
            serial_ms = n * l2_ns * 1e-6
            report["exact_scan"] = dict(
                ms=ms, device_ms=dev_ms, host_ms=host, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=err, serial_floor_ms=serial_ms,
                plain_on="cpu",
            )
            line += (f"; {ms * 1e3:.1f} us/launch, {_dev(dev_ms, host)} (plain {plain_ms:.1f} ms "
                     f"on CPU copies; bound {bound_ms * 1e3:.3f} us by {bound_by}, "
                     f"serial floor {serial_ms * 1e3:.1f} us = {n} x {l2_ns:.1f} ns)")
        print(line)


def check_apply(dev, report):
    """K4 against its plain version (on the card) on 32,768 entries over
    a 2^20-row table: full 64-bit deltas, so carries from lo into hi and
    wraps past 2^128 are common, and 4,096 padding entries (slot >= A)
    that must be dropped."""
    table, packed = flush_cases.timed_case(A_ROWS)
    K, live = packed.shape[1], int((packed[0] < A_ROWS).sum())
    table = torch.from_numpy(table).to(dev)
    pk = torch.from_numpy(packed).to(dev)
    t_k = dk.apply_deltas(table.clone(), pk)
    t_p = dk.apply_deltas_plain(table.clone(), pk)
    torch.cuda.synchronize()
    err = max_abs_err(t_k, t_p)
    check(err == 0, "K4 differs from the plain version")
    ms, dev_ms, host = kernel_ms(lambda: dk.apply_deltas(t_k, pk))
    plain_ms = time_ms(lambda: dk.apply_deltas_plain(t_p, pk), reps=10)
    bound_ms, bound_by = bound(K * 32 + live * 32, live * K4_OPS_PER_ENTRY)
    # A sharded_host flush: its launches on the compact table of the
    # flushed rows (flush_cases), each against the plain version; the
    # first (32,768 entries) timed.
    c_table, chunks = flush_cases.flush_case(2029, A_ROWS, N_ACCOUNTS, compact=True)
    c_k = torch.from_numpy(c_table).to(dev)
    c_p = c_k.clone()
    for packed in chunks:
        c_pk = torch.from_numpy(packed).to(dev)
        dk.apply_deltas(c_k, c_pk)
        dk.apply_deltas_plain(c_p, c_pk)
    torch.cuda.synchronize()
    c_err = max_abs_err(c_k, c_p)
    check(c_err == 0, "K4 differs from the plain version on a compact table")
    c_pk = torch.from_numpy(chunks[0]).to(dev)
    c_ms, c_dev_ms, _ = kernel_ms(lambda: dk.apply_deltas(c_k, c_pk))
    n_c = c_pk.shape[1]
    compact = dict(rows=c_table.shape[0], entries=[int(p.shape[1]) for p in chunks], ms=c_ms,
                   device_ms=c_dev_ms, bound_ms=bound(n_c * 64, n_c * K4_OPS_PER_ENTRY)[0])
    report["apply_deltas"] = dict(ms=ms, device_ms=dev_ms, host_ms=host,
                                  plain_ms=plain_ms, bound_ms=bound_ms,
                                  bound_by=bound_by, max_abs_err=max(err, c_err),
                                  cases={"compact_flush": compact})
    print(f"K4 apply_deltas ({live} entries + {K - live} padding): bit-exact; "
          f"{ms * 1e3:.1f} us, {_dev(dev_ms, host)} {_vs(plain_ms, bound_ms)}; "
          f"a compact-table flush ({compact['rows']} rows, launches of {compact['entries']} "
          f"entries): bit-exact, the first {c_ms * 1e3:.1f} us, {_dev(c_dev_ms)}")


def check_tier_kernels(dev, report):
    """K10, K2 admit and K11 against their plain versions on the card, at
    the tiered phases' shapes, bit for bit.  K10: k = 128 and 16,384 rows
    (a timed batch's and a warm-up batch's admissions) into a 2^20-row
    balance table, with distinct out-of-range padding, and into the meta
    table; timed beside Tensor.index_copy_, the one PyTorch call that
    computes the same function.  K2 admit: 16,384 and 80 slots of a
    2^20-row hash table (a warm-up's and a timed admission's), each
    beside an empty kernel of its launch shape, and a call that holds
    slots past the table and row H-1.  K11: a (2^20, 8) balance table
    and a (2^20, 2) meta table holding words >= 2^31."""
    rng = np.random.default_rng(2035)
    table, meta = _tables(rng, A_ROWS, dev)
    meta_np = rng.integers(0, 1 << 32, (A_ROWS, 2), dtype=np.uint64).astype(np.uint32)
    meta_np[: A_ROWS // 3] |= np.uint32(1 << 31)
    meta = torch.from_numpy(meta_np.view(np.int32)).to(dev)
    errs, timed = [], {}
    for k in (128, 16_384):
        idx_np = rng.choice(A_ROWS, k, replace=False).astype(np.int64)
        padded = torch.from_numpy(np.concatenate([idx_np, A_ROWS + np.arange(64)])).to(dev)
        src = torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, (k + 64, 8))).to(dev)
        src_m = torch.from_numpy(rng.integers(-(1 << 31), (1 << 31) - 1, (k + 64, 2))
                                 .astype(np.int32)).to(dev)
        for tab, rows in ((table, src), (meta, src_m)):
            got = dk.tier_set_rows(tab.clone(), padded, rows)
            want = dk.tier_set_rows_plain(tab.clone(), padded, rows)
            torch.cuda.synchronize()
            errs.append(max_abs_err(got, want))
            check(errs[-1] == 0, f"K10 tier_set_rows (k={k}): kernel differs from the plain version")
        idx = padded[:k].contiguous()
        live = src[:k].contiguous()
        t_k = table.clone()
        (ms, dev_ms, host), (lib_ms, lib_dev_ms, lib_host) = paired_ms(
            lambda: dk.tier_set_rows(t_k, idx, live), lambda: t_k.index_copy_(0, idx, live),
            names=("set_rows",))
        plain_ms = time_ms(lambda: dk.tier_set_rows_plain(t_k, idx, live), reps=10)
        check(torch.equal(t_k, dk.tier_set_rows(table.clone(), idx, live)),
              "K10 and index_copy_ disagree")
        bound_ms, bound_by = bound(k * 8 + 2 * k * 64, k)
        timed[k] = dict(ms=ms, device_ms=dev_ms, host_ms=host, plain_ms=plain_ms,
                        library_ms=lib_ms, library_device_ms=lib_dev_ms,
                        library_host_ms=lib_host, bound_ms=bound_ms, bound_by=bound_by)
        print(f"K10 tier_set_rows (k={k} of 2^20 rows + 64 padding; balances and meta): "
              f"bit-exact; {ms * 1e3:.1f} us, {_dev(dev_ms, host)} {_vs(plain_ms, bound_ms)}, "
              f"index_copy_ {lib_ms * 1e3:.1f} us, {_dev(lib_dev_ms, lib_host)}")
    split = launch_split.run(dev)
    report["tier_set_rows"] = dict(timed[16_384], max_abs_err=max(errs),
                                   timed_case="k=16384 rows of a 2^20-row balance table",
                                   k128=timed[128], host_split=split)
    print("K10 host path, us per call (tools/launch_split.py, k=16384): " + json.dumps(split))

    # K2 admit at a warm-up admission's 16,384 slots and a timed one's 80
    # (the tiered phase's census: 48 launches of 16,380 slots, 64 of
    # 59-116, median 80), each beside an empty kernel of the same launch
    # shape; then slots past the table with row H-1 owned.
    rh = torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, (A_ROWS, 2))).to(dev)
    dg = torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, 2)).to(dev)
    errs, timed = [], {}
    for k in (16_384, 80):
        slots = torch.from_numpy(rng.choice(A_ROWS, k, replace=False).astype(np.int64)).to(dev)
        new_lo, new_hi = (torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, len(slots)))
                          .to(dev) for _ in range(2))
        rh_k, dg_k = cm.admit(rh.clone(), dg.clone(), slots, new_lo, new_hi)
        rh_p, dg_p = cm.admit_plain(rh.clone(), dg.clone(), slots, new_lo, new_hi)
        torch.cuda.synchronize()
        errs.append(max(max_abs_err(rh_k, rh_p), max_abs_err(dg_k, dg_p)))
        check(errs[-1] == 0, f"K2 admit (k={k}) differs from the plain version")
        ms, dev_ms, host = kernel_ms(lambda: cm.admit(rh_k, dg_k, slots, new_lo, new_hi),
                                     names=("cm_admit",))
        plain_ms = time_ms(lambda: cm.admit_plain(rh_p, dg_p, slots, new_lo, new_hi), reps=10)
        G, T = kernels.commit_admit_geometry(len(slots))
        empty_ms = device_ms(lambda: kernels.commit_empty(dev.index, G, T), names=("cm_empty",))
        bound_ms, bound_by = bound(k * (8 + 16 + 16 + 16) + 32, k * 6)
        timed[k] = dict(ms=ms, device_ms=dev_ms, host_ms=host, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by, geometry=[G, T],
                        empty_device_ms=empty_ms, timed_case=f"k={k} slots of 2^20")
        print(f"K2 admit ({k} slots, {G} blocks x {T}): bit-exact; "
              f"{ms * 1e3:.1f} us, {_dev(dev_ms, host)} {_vs(plain_ms, bound_ms)}; an empty "
              f"kernel of that launch {_dev_us(None if empty_ms is None else empty_ms * 1e3)} "
              f"on the device")
    H = A_ROWS
    past = np.concatenate([rng.choice(H - 1, 15_000, replace=False), [H - 1],
                           H + rng.choice(H, 1_383, replace=False)])
    slots = torch.from_numpy(rng.permutation(past).astype(np.int64)).to(dev)
    new_lo, new_hi = (torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, len(slots)))
                      .to(dev) for _ in range(2))
    rh_k, dg_k = cm.admit(rh.clone(), dg.clone(), slots, new_lo, new_hi)
    rh_p, dg_p = cm.admit_plain(rh.clone(), dg.clone(), slots, new_lo, new_hi)
    torch.cuda.synchronize()
    errs.append(max(max_abs_err(rh_k, rh_p), max_abs_err(dg_k, dg_p)))
    check(errs[-1] == 0, "K2 admit with slots past the table differs from the plain version")
    print(f"K2 admit ({len(slots)} slots, {int((slots >= H).sum())} past the table, row H-1 "
          f"among them): bit-exact")
    report["commit_admit"] = dict(timed[16_384], max_abs_err=max(errs), k80=timed[80])

    errs = []
    for name, tab in (("balances", table), ("meta", meta)):
        got = dk.checksum(tab)
        want = dk.checksum_plain(tab)
        torch.cuda.synchronize()
        errs.append(max_abs_err(got, want))
        check(errs[-1] == 0, f"K11 checksum[{name}]: kernel differs from the plain version")
        C = tab.shape[1]
        ms, dev_ms, host = kernel_ms(lambda: dk.checksum(tab), names=("checksum",))
        plain_ms = time_ms(lambda: dk.checksum_plain(tab), reps=10)
        bound_ms, bound_by = bound(tab.numel() * tab.element_size() + 2 * C * 8,
                                   tab.numel() * 4)
        print(f"K11 checksum[{name}] ({A_ROWS} x {C} {tab.dtype}): bit-exact; {ms * 1e3:.1f} us, "
              f"{_dev(dev_ms, host)} {_vs(plain_ms, bound_ms)}")
        if name == "balances":
            report["checksum"] = dict(ms=ms, device_ms=dev_ms, host_ms=host, plain_ms=plain_ms,
                                      bound_ms=bound_ms, bound_by=bound_by,
                                      timed_case="(2^20, 8) u64 balance table")
        else:
            report["checksum"]["meta"] = dict(ms=ms, device_ms=dev_ms, host_ms=host,
                                              plain_ms=plain_ms,
                                              bound_ms=bound_ms)
    # K11 with row0: the table split in SHARDS, each shard's digest under
    # its first global row, summed mod 2^64, is the joined table's.
    local = A_ROWS // SHARDS
    for name, tab in (("balances", table), ("meta", meta)):
        parts = [dk.checksum(tab[s * local:(s + 1) * local].contiguous(), s * local)
                 for s in range(SHARDS)]
        plain = [dk.checksum_plain(tab[s * local:(s + 1) * local], s * local)
                 for s in range(SHARDS)]
        torch.cuda.synchronize()
        errs += [max_abs_err(a, b) for a, b in zip(parts, plain)]
        check(max(errs) == 0, f"K11 checksum[{name}] with row0: kernel differs from plain")
        check(torch.equal(torch.stack(parts).sum(0), dk.checksum(tab)),
              f"K11 checksum[{name}]: the {SHARDS} shards' row0 digests do not sum to the "
              "joined table's")
    shard = table[local:2 * local].contiguous()
    ms, dev_ms, host = kernel_ms(lambda: dk.checksum(shard, local), names=("checksum",))
    bound_ms, _ = bound(shard.numel() * 8 + 16 * 8, shard.numel() * 4)
    report["checksum"]["row0"] = dict(ms=ms, device_ms=dev_ms, host_ms=host, bound_ms=bound_ms,
                                      timed_case=f"shard 1 of {SHARDS}: ({local}, 8), "
                                                 f"row0={local}")
    print(f"K11 checksum with row0 ({SHARDS} shards of {local} rows, balances and meta): "
          f"bit-exact, shard digests sum to the joined table's; one shard {ms * 1e3:.1f} us, "
          f"{_dev(dev_ms, host)} (bound {bound_ms * 1e3:.3f} us)")
    report["checksum"]["max_abs_err"] = max(errs)


# ---------------------------------------------------------------------------
# Row sharding: K12-K14, the sharded apply and the sharded wave executor.
# Every shard of a mesh here lies on the one card (S shards on one H100):
# copies between shards are device-local, and no time is a multi-GPU one.

SHARDS = 4              # the kernel checks' and sharded_waves' shard count
K12_OPS_PER_EVENT = 30   # per event: the limbs, two ownership tests, 8 atomics
K13_OPS_PER_CELL = 12    # per (row, column): limb carries, the u128 add, the test


def check_shard_kernels(dev, report):
    """K12, K13 admit and apply, K14 gather and scatter against their
    plain versions on the card, bit for bit, at the sharded phases'
    shapes: an 8190-event slice onto shard 1 of a 2^20-row table split
    in 4 (2^18 local rows; 64 rows of the table within 2^40 of 2^128,
    so events reject); K14 at W = 8, 2 and 1 on K = 16,380 slots (a wave
    batch's) and on a window unit's rows (serial_probes.k14_cases).  K12 is
    timed beside Tensor.index_put_(accumulate=True), K14 gather beside
    index_select + where and its scatter beside index_copy_."""
    local = A_ROWS // SHARDS
    shard = 1
    row0 = shard * local
    balances, *events = shard_cases.apply_events(2040, A_ROWS, workload.BATCH, near_ceiling=64)
    ev = [x[0] for x in sharded.shard_events(sharded.make_mesh([dev], dp=1), *events)]
    dr, cr, lo, hi, pend = ev
    E = dr.numel()
    table = sharded.shard_balances(sharded.make_row_mesh([dev] * SHARDS), balances)[shard]
    mask = torch.from_numpy(np.random.default_rng(5).random(E) < 0.7).to(dev)

    errs = []
    for m in (None, mask):
        got = sharded.accumulate(local, row0, *ev, mask=m)
        want = sharded._accumulate(local, row0, *ev, mask=m)
        torch.cuda.synchronize()
        errs.append(max_abs_err(got, want))
        check(errs[-1] == 0, f"K12 shard_accumulate (mask {m is not None}): kernel differs "
                             "from the plain version")
    acc = sharded.accumulate(local, row0, *ev)
    ms, dev_ms, host = kernel_ms(lambda: sharded.accumulate(local, row0, *ev),
                                 names=("shard_accumulate", "Memset"))
    plain_ms = time_ms(lambda: sharded._accumulate(local, row0, *ev), reps=10)
    idx, vals = [], []
    for slot, col_p, col_posted in ((dr, 0, 1), (cr, 2, 3)):
        own, rel = sharded.own_rows(slot.long(), local, shard)
        col = torch.where(pend, col_p, col_posted)
        cell = (rel * 4 + col)[:, None] * 4 + torch.arange(4, device=dev)
        idx.append(cell[own].reshape(-1))
        vals.append(torch.stack([lo & 0xFFFFFFFF, (lo >> 32) & 0xFFFFFFFF, hi & 0xFFFFFFFF,
                                 (hi >> 32) & 0xFFFFFFFF], -1)[own].reshape(-1))
    idx, vals = torch.cat(idx), torch.cat(vals)
    lib = torch.zeros(local * 16, dtype=torch.int64, device=dev)
    lib_ms, lib_dev_ms, lib_host = kernel_ms(lambda: lib.index_put_((idx,), vals, accumulate=True))
    lib.zero_()
    lib.index_put_((idx,), vals, accumulate=True)
    check(torch.equal(lib.view(local, 4, 4), acc), "K12 and index_put_ disagree")
    bound_ms, bound_by = bound(E * (4 + 4 + 8 + 8 + 1) + local * 128, E * K12_OPS_PER_EVENT)
    report["shard_accumulate"] = dict(
        ms=ms, device_ms=dev_ms, host_ms=host, plain_ms=plain_ms, library_ms=lib_ms,
        library_device_ms=lib_dev_ms, library_host_ms=lib_host, bound_ms=bound_ms,
        bound_by=bound_by,
        max_abs_err=max(errs), timed_case=f"{E} events onto {local} local rows")
    print(f"K12 shard_accumulate ({E} events onto {local} local rows, masked and not): "
          f"bit-exact; {ms * 1e3:.1f} us, {_dev(dev_ms, host)} {_vs(plain_ms, bound_ms)}, "
          f"index_put_ {lib_ms * 1e3:.1f} us, {_dev(lib_dev_ms, lib_host)}")

    got = sharded.admit(table, acc, row0, dr, cr)
    want = sharded.admit_plain(table, acc, row0, dr, cr)
    torch.cuda.synchronize()
    err = max_abs_err(got.long(), want.long())
    check(err == 0, "K13 shard_admit: kernel differs from the plain version")
    n_rej = int(got.sum())
    check(n_rej > 0, "K13 shard_admit: no event rejected")
    ms, dev_ms, host = kernel_ms(lambda: sharded.admit(table, acc, row0, dr, cr),
                                 names=("shard_admit",))
    plain_ms = time_ms(lambda: sharded.admit_plain(table, acc, row0, dr, cr), reps=10)
    rows = torch.unique(torch.cat([s[(s >= row0) & (s < row0 + local)] for s in (dr, cr)]))
    bound_ms, bound_by = bound(E * 8 + rows.numel() * (64 + 128) + E,
                               rows.numel() * 4 * K13_OPS_PER_CELL)
    report["shard_admit"] = dict(ms=ms, device_ms=dev_ms, host_ms=host,
                                 plain_ms=plain_ms, bound_ms=bound_ms,
                                 bound_by=bound_by, max_abs_err=err,
                                 timed_case=f"{E} events, {rows.numel()} local rows named, "
                                            f"{n_rej} rejected")
    print(f"K13 shard_admit ({E} events, {rows.numel()} local rows named, {n_rej} rejected): "
          f"bit-exact; {ms * 1e3:.1f} us, {_dev(dev_ms, host)} {_vs(plain_ms, bound_ms)}")
    # The sharded_apply phase's own slice (4095 events onto one of two
    # 2^19-row shards), and the k13 probe's device time of both shapes.
    for name, t_, a_, r0, d_, c_ in serial_probes.k13_cases(dev):
        if name != "phase_slice":
            continue
        got = sharded.admit(t_, a_, r0, d_, c_)
        want = sharded.admit_plain(t_, a_, r0, d_, c_)
        torch.cuda.synchronize()
        p_err = max_abs_err(got.long(), want.long())
        check(p_err == 0, "K13 shard_admit (phase slice): kernel differs from the plain version")
        p_ms, p_dev, p_host = kernel_ms(lambda: sharded.admit(t_, a_, r0, d_, c_),
                                        names=("shard_admit",))
        p_plain = time_ms(lambda: sharded.admit_plain(t_, a_, r0, d_, c_), reps=10)
        local_ = t_.shape[0]
        p_rows = torch.unique(torch.cat([s_[(s_ >= r0) & (s_ < r0 + local_)] for s_ in (d_, c_)]))
        p_bound, p_by = bound(d_.numel() * 8 + p_rows.numel() * (64 + 128) + d_.numel(),
                              p_rows.numel() * 4 * K13_OPS_PER_CELL)
        report["shard_admit"]["phase_slice"] = dict(
            ms=p_ms, device_ms=p_dev, host_ms=p_host, plain_ms=p_plain, bound_ms=p_bound,
            bound_by=p_by, max_abs_err=p_err, events=d_.numel(), local_rows=local_,
            rows_named=p_rows.numel(), rejected=int(got.sum()))
        print(f"K13 shard_admit (phase slice: {d_.numel()} events onto {local_} local rows, "
              f"{p_rows.numel()} named, {int(got.sum())} rejected): bit-exact; "
              f"{p_ms * 1e3:.1f} us, {_dev(p_dev, p_host)} {_vs(p_plain, p_bound)}")
    k13 = serial_probes.k13_sweep(dev)
    report["shard_admit"]["sweep"] = k13
    print(f"K13 probe: device us {({k: v['device_us'] for k, v in k13.items()})}")

    t_k, t_p = table.clone(), table.clone()
    sharded.apply(t_k, acc)
    sharded.apply_plain(t_p, acc)
    torch.cuda.synchronize()
    err = max_abs_err(t_k, t_p)
    check(err == 0, "K13 shard_apply: kernel differs from the plain version")
    ms, dev_ms, host = kernel_ms(lambda: sharded.apply(t_k, acc), names=("shard_apply",))
    plain_ms = time_ms(lambda: sharded.apply_plain(t_p, acc), reps=10)
    bound_ms, bound_by = bound(local * (64 + 64 + 128), local * 4 * K13_OPS_PER_CELL)
    report["shard_apply"] = dict(ms=ms, device_ms=dev_ms, host_ms=host,
                                 plain_ms=plain_ms, bound_ms=bound_ms,
                                 bound_by=bound_by, max_abs_err=err,
                                 timed_case=f"{local} local rows")
    print(f"K13 shard_apply ({local} local rows): bit-exact; {ms * 1e3:.1f} us, "
          f"{_dev(dev_ms, host)} {_vs(plain_ms, bound_ms)}")

    rng = np.random.default_rng(2042)
    for key, W, t, slots in serial_probes.k14_cases(dev, table):
        gather, scatter = k14_case(t, slots, shard, rng)
        if key == "widths" and W == 8:
            # The headline: the wave executor's batch at the balances' width.
            report["shard_gather"], report["shard_scatter"] = gather, scatter
        else:
            report["shard_gather"].setdefault(key, {})[W] = gather
            report["shard_scatter"].setdefault(key, {})[W] = scatter


def k14_case(table, slots, shard, rng):
    """K14 gather and scatter of the global `slots` on the (local_rows,
    W) shard `table` of a 2^20-row table against the plain versions, bit
    for bit; each timed beside index_select + where (gather) and
    index_copy_ (scatter).  Returns the gather's and the scatter's
    report entries."""
    local, W = table.shape
    own, rel = sharded.own_rows(slots, local, shard)
    K, owned = slots.numel(), int(own.sum())
    case = f"K={K} slots of 2^20, {owned} owned, W={W}"
    got = sharded.gather_part(table, slots, shard)
    want = sharded.gather_part_plain(table, slots, shard)
    torch.cuda.synchronize()
    err_g = max_abs_err(got, want)
    check(err_g == 0, f"K14 shard_gather ({case}): kernel differs from the plain version")
    g_ms, g_dev, g_host = kernel_ms(lambda: sharded.gather_part(table, slots, shard),
                                    names=("shard_gather",))
    g_plain = time_ms(lambda: sharded.gather_part_plain(table, slots, shard), reps=10)
    own2 = own[:, None]
    g_lib, g_lib_dev, g_lib_host = kernel_ms(
        lambda: torch.where(own2, table.index_select(0, rel), 0))
    check(torch.equal(torch.where(own2, table.index_select(0, rel), 0), got),
          f"K14 gather and index_select + where disagree ({case})")
    g_bound, g_by = bound(K * 8 + owned * 8 * W + K * 8 * W, K * W)
    new = torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, (K, W))).to(table.device)
    t_k, t_p = table.clone(), table.clone()
    sharded.scatter_part(t_k, slots, new, shard)
    sharded.scatter_part_plain(t_p, slots, new, shard)
    torch.cuda.synchronize()
    err_s = max_abs_err(t_k, t_p)
    check(err_s == 0, f"K14 shard_scatter ({case}): kernel differs from the plain version")
    s_plain = time_ms(lambda: sharded.scatter_part_plain(t_p, slots, new, shard), reps=10)
    rel_own, new_own = rel[own].contiguous(), new[own].contiguous()
    (s_ms, s_dev, s_host), (s_lib, s_lib_dev, s_lib_host) = paired_ms(
        lambda: sharded.scatter_part(t_k, slots, new, shard),
        lambda: t_k.index_copy_(0, rel_own, new_own), names=("shard_scatter",))

    def full_scatter():
        # The same function in PyTorch from the unfiltered slots: own_rows,
        # the owned entries picked out, index_copy_.
        o, r = sharded.own_rows(slots, local, shard)
        t_k.index_copy_(0, r[o], new[o])

    s_full, s_full_dev, s_full_host = kernel_ms(full_scatter)
    # The scatter reads every slot but only the owned entries' rows.
    s_bound, s_by = bound(K * 8 + 2 * owned * 8 * W, K * W)
    print(f"K14 W={W} ({case}): bit-exact; gather {g_ms * 1e3:.1f} us, {_dev(g_dev, g_host)} "
          f"{_vs(g_plain, g_bound)}, index_select + where {g_lib * 1e3:.1f} us, "
          f"{_dev(g_lib_dev, g_lib_host)}; scatter {s_ms * 1e3:.1f} us, {_dev(s_dev, s_host)} "
          f"{_vs(s_plain, s_bound)}, index_copy_ {s_lib * 1e3:.1f} us, "
          f"{_dev(s_lib_dev, s_lib_host)}; own_rows + index_copy_ {s_full * 1e3:.1f} us, "
          f"{_dev(s_full_dev, s_full_host)}")
    return (
        dict(ms=g_ms, device_ms=g_dev, host_ms=g_host, plain_ms=g_plain, library_ms=g_lib,
             library_device_ms=g_lib_dev, library_host_ms=g_lib_host, bound_ms=g_bound,
             bound_by=g_by, max_abs_err=err_g,
             timed_case=case),
        dict(ms=s_ms, device_ms=s_dev, host_ms=s_host, plain_ms=s_plain, library_ms=s_lib,
             library_device_ms=s_lib_dev, library_host_ms=s_lib_host, bound_ms=s_bound,
             bound_by=s_by, max_abs_err=err_s,
             library_full=dict(ms=s_full, device_ms=s_full_dev, host_ms=s_full_host),
             timed_case=case),
    )



# ---------------------------------------------------------------------------
# The multi-batch launchers: K1, K5 and K6 over a resident stack
# (scan_of) or one batch of a resident superbatch (staged).

LAUNCH_G = 4              # batches per scan_of call in the checks
TIMED_G = (4, 16, 32)     # scan_of depths timed
TIMED_KINDS = ("orderfree_lo", "linked_small", "two_phase_lo")  # the scan_kinds probe's


def batch_bound(kind, pk, n, ring_row) -> tuple[float, float]:
    """(bytes, operations) one batch of `kind` must move and do: the
    packed batch, the distinct named rows read (balances and meta) and
    written, one ring row; the kernel's operations per event, per row
    and, for K5, per limit entry and fixpoint iteration."""
    fam = dk.FAMILY[kind]
    if fam == "orderfree":
        n_bytes, rows = orderfree_bytes(dk.KIND_MODE[kind], pk, n, None)
        return n_bytes, n * K1_OPS_PER_EVENT + rows * K1_OPS_PER_ROW
    pk_np = to_u64(pk)
    cols = [dk.COL_SLOTS] if fam == "linked" else [dk.COL_SLOTS, dk.COL_TP_SLOTS]
    idx = _slots_of(pk_np, n, cols)
    n_bytes = pk_np.nbytes + len(idx) * (64 + 8) + len(idx) * 64 + 512
    if fam == "two_phase":
        return n_bytes, n * K6_OPS_PER_EVENT
    iters = dk.unpack_summary(ring_row)["iters"]
    return n_bytes, n * K5_OPS_PER_EVENT + 2 * n * K5_OPS_PER_ENTRY_ITER * iters


def check_launchers(dev, report):
    """scan_of for every kind (G = LAUNCH_G, ring rows wrapping past the
    end) and staged for the five *_staged names at g = 0, G - 1, G and
    -1 (the clamp), on the experiments' probe batches (full 8190-event
    batches over a 2^20-row table of random balances): each against its
    plain version and against the same batches launched one per call,
    table and ring bit for bit.  Then µs per batch of orderfree_lo one
    per call with a sync after each, scan_of at TIMED_G and staged, and
    scan_of at 16 for the scan_kinds probe's three kinds."""
    from tigerbeetle_tpu_torch.experiments import common

    rng = np.random.default_rng(2031)
    table, meta = _tables(rng, A_ROWS, dev)
    ring = torch.zeros((RING_ROWS, dk.SUMMARY_WORDS), dtype=torch.int64, device=dev)
    G = LAUNCH_G
    ns = np.array([common.N - 7 * g for g in range(G)], np.int64)
    tsb = np.arange(G, dtype=np.uint64) + np.uint64(1 << 40)
    err_scan = err_staged = 0
    stacks = {}
    for kind in dk.KIND_MODE:
        stacks[kind] = stack = common.upload(common.probe_stack(kind, A_ROWS, G, seed=41), dev)
        at0 = RING_ROWS - 2
        out = []
        for run in ("kernel", "plain", "one per call"):
            t, r = table.clone(), ring.clone()
            kernels.reset_launches()
            if run == "one per call":
                for g in range(G):
                    dk.KERNELS[kind](t, meta, r, (at0 + g) % RING_ROWS, stack[g], int(ns[g]),
                                     int(tsb[g]))
            else:
                dk.scan_of(kind, G, plain=run == "plain")(t, meta, r, at0, stack, ns, tsb)
            torch.cuda.synchronize()
            out.append((t, r, kernels.launches["scan_of"]))
        check([c for *_x, c in out] == [G, 0, 0], f"scan_of[{kind}]: launches {out[0][2]}")
        e = max(max(max_abs_err(out[0][0], t), max_abs_err(out[0][1], r)) for t, r, _ in out[1:])
        check(e == 0, f"scan_of[{kind}]: differs from the plain loop or one launch per call")
        err_scan = max(err_scan, e)
        del out
    print(f"scan_of: {len(dk.KIND_MODE)} kinds x G = {G} (ring rows {RING_ROWS - 2} onward, "
          f"wrapping): bit-exact against the plain loop and one launch per call")
    for name, kind in sorted(dk.STAGED.items()):
        sup = stacks[kind].reshape(G * dk.B, -1)
        for g in (0, G - 1, G, -1):
            s = dk.dynamic_start(g * dk.B, G * dk.B, dk.B)
            t_k, r_k, t_p, r_p, t_1, r_1 = (x.clone() for x in (table, ring) * 3)
            kernels.reset_launches()
            getattr(dk, name)(t_k, meta, r_k, 9, sup, g, common.N, 1 << 40)
            check(kernels.launches["staged"] == 1, f"{name}: not one staged launch")
            dk.staged(kind, plain=True)(t_p, meta, r_p, 9, sup, g, common.N, 1 << 40)
            dk.KERNELS[kind](t_1, meta, r_1, 9, sup[s:s + dk.B], common.N, 1 << 40)
            torch.cuda.synchronize()
            e = max(max_abs_err(t_k, t_p), max_abs_err(r_k, r_p), max_abs_err(t_k, t_1),
                    max_abs_err(r_k, r_1))
            check(e == 0, f"{name} g={g}: differs from the plain version or its own launch")
            err_staged = max(err_staged, e)
    print(f"staged: {len(dk.STAGED)} names x g in (0, {G - 1}, {G}, -1): bit-exact against the "
          f"plain version and one launch on rows [dynamic_start(g * B), + B)")
    del stacks

    # Timing: orderfree_lo, the probes' kind, on full batches.
    kind = "orderfree_lo"
    scratch = common.scratch_for(kind, A_ROWS, dev)
    big = common.upload(common.probe_stack(kind, A_ROWS, max(TIMED_G), seed=43), dev)
    ns_all = np.full(max(TIMED_G), common.N, np.int64)
    tsb_all = np.arange(max(TIMED_G), dtype=np.uint64) + np.uint64(1 << 40)
    t, r = table.clone(), ring.clone()
    dk.KERNELS[kind](t, meta, r, 0, big[0], common.N, 1 << 40)
    b_bytes, b_ops = batch_bound(kind, big[0], common.N, to_u64(r[0]))
    solo = dk.scan_of(kind, 1)
    solo_ms = time_ms(lambda: solo(t, meta, r, 0, big[:1], ns_all[:1], tsb_all[:1],
                                   scratch=scratch))
    us = {"solo_sync": solo_ms * 1e3}
    for Gt in TIMED_G:
        scan = dk.scan_of(kind, Gt)
        args = (t, meta, r, 0, big[:Gt], ns_all[:Gt], tsb_all[:Gt])
        us[str(Gt)] = time_ms(lambda: scan(*args, scratch=scratch)) / Gt * 1e3
    G16 = 16
    scan16 = dk.scan_of(kind, G16)
    args16 = (t, meta, r, 0, big[:G16], ns_all[:G16], tsb_all[:G16])
    scan_ms, scan_dev, scan_host = kernel_ms(lambda: scan16(*args16, scratch=scratch))
    t_p, r_p = table.clone(), ring.clone()
    plain16 = dk.scan_of(kind, G16, plain=True)
    scan_plain = time_ms(lambda: plain16(t_p, meta, r_p, 0, big[:G16], ns_all[:G16],
                                         tsb_all[:G16]), reps=3, warm=1)
    scan_bound, scan_by = bound(G16 * b_bytes, G16 * b_ops)
    sup = big[:8].reshape(8 * dk.B, -1)
    stg = dk.orderfree_lo_staged
    st_ms, st_dev, st_host = kernel_ms(
        lambda: stg(t, meta, r, 3, sup, 5, common.N, 1, scratch=scratch))
    st_plain = time_ms(lambda: dk.staged(kind, plain=True)(t_p, meta, r_p, 3, sup, 5, common.N, 1),
                       reps=5, warm=1)
    st_bound, st_by = bound(b_bytes, b_ops)
    us["staged"] = st_ms * 1e3
    by_kind = {}
    for k in TIMED_KINDS:
        st = common.upload(common.probe_stack(k, A_ROWS, G16, seed=45), dev)
        sc = common.scratch_for(k, A_ROWS, dev)
        tk, rk = table.clone(), ring.clone()
        scan_k = dk.scan_of(k, G16)
        kargs = (tk, meta, rk, 0, st, ns_all[:G16], tsb_all[:G16])
        k_ms, k_dev, k_host = kernel_ms(lambda: scan_k(*kargs, scratch=sc))
        kb, ko = batch_bound(k, st[0], common.N, to_u64(rk[0]))
        by_kind[k] = dict(us_per_batch=k_ms / G16 * 1e3,
                          device_us_per_batch=None if k_dev is None else k_dev / G16 * 1e3,
                          host_us_per_batch=k_host / G16 * 1e3,
                          bound_us_per_batch=bound(kb, ko)[0] * 1e3)
        del st, tk, rk
    print(f"scan_of[{kind}] per batch: solo + sync {us['solo_sync']:.1f} us, "
          + ", ".join(f"scan-{g} {us[str(g)]:.1f} us" for g in TIMED_G)
          + f", staged {us['staged']:.1f} us; scan-16 call {scan_ms * 1e3:.1f} us, "
          f"{_dev(scan_dev, scan_host)} {_vs(scan_plain, scan_bound)}; staged call "
          f"{_dev(st_dev, st_host)} "
          f"{_vs(st_plain, st_bound)}")
    print("scan_of G=16 per batch by kind: " + "; ".join(
        f"{k} {v['us_per_batch']:.1f} us (device {_dev_us(v['device_us_per_batch'])}, "
        f"bound {v['bound_us_per_batch']:.3f} us)" for k, v in by_kind.items()))
    report["scan_of"] = dict(ms=scan_ms, device_ms=scan_dev, host_ms=scan_host,
                             plain_ms=scan_plain,
                             bound_ms=scan_bound, bound_by=scan_by, max_abs_err=err_scan,
                             timed_case=f"{kind} G={G16}", us_per_batch=us, by_kind=by_kind)
    report["staged"] = dict(ms=st_ms, device_ms=st_dev, host_ms=st_host, plain_ms=st_plain,
                            bound_ms=st_bound,
                            bound_by=st_by, max_abs_err=err_staged,
                            timed_case="orderfree_lo_staged g=5 of 8")
    del big, t, r, t_p, r_p
    torch.cuda.empty_cache()

CEILING_ROWS = 64  # rows past the accounts seeded within 2^40 of 2^128


def sharded_apply_inputs():
    """(balances, per-batch event columns): gen_simple's 1,000,000 timed
    transfers at 1,000,000 accounts decoded to (dr_slot, cr_slot,
    amount_lo, amount_hi, is_pending) (account k is row k - 1), then one
    8190-event batch of which half name the CEILING_ROWS rows past the
    accounts, each seeded within 2^40 of 2^128 in one column, with
    amounts up to 2^41: their events reject."""
    _setup, timed, sizing = workload.gen_simple(N_TRANSFERS, n_accounts=N_ACCOUNTS)
    check(sizing[0] == A_ROWS, "sharded_apply: table is not 2^20 rows")
    batches = []
    for _op, body in timed:
        t = np.frombuffer(body, TRANSFER_DTYPE)
        batches.append(((t["debit_account_id_lo"] - 1).astype(np.int32),
                        (t["credit_account_id_lo"] - 1).astype(np.int32),
                        t["amount_lo"].copy(), t["amount_hi"].copy(),
                        (t["flags"] & TransferFlags.pending) != 0))
    rng = np.random.default_rng(2042)
    balances = np.zeros((A_ROWS, 8), np.uint64)
    hot = N_ACCOUNTS + np.arange(CEILING_ROWS)
    col = rng.integers(0, 4, CEILING_ROWS)
    balances[hot, 2 * col] = np.uint64((1 << 64) - (1 << 40))
    balances[hot, 2 * col + 1] = np.uint64((1 << 64) - 1)
    E = workload.BATCH
    dr = rng.integers(0, N_ACCOUNTS, E).astype(np.int32)
    dr[: E // 2] = hot[rng.integers(0, CEILING_ROWS, E // 2)]
    cr = ((dr.astype(np.int64) + 1) % N_ACCOUNTS).astype(np.int32)
    batches.append((dr, cr, rng.integers(1, 1 << 41, E).astype(np.uint64),
                    np.zeros(E, np.uint64), rng.random(E) < 0.5))
    return balances, batches


def _busy_line(trace, seconds) -> str:
    if trace is None:
        return "not measured (no device activity in the trace)"
    busy_ms, top = trace
    return (f"{busy_ms:.3f} ms of {seconds:.3f} s (busy share {busy_ms / 1e3 / seconds:.6f}); "
            f"top {top}")


def run_sharded_apply(mesh, balances, slices, plain, profile=False):
    """Every batch through one build_apply_step; returns (tables, the
    admitted masks concatenated, seconds, device trace or None)."""
    step = sharded.build_apply_step(mesh, A_ROWS, plain=plain)
    tables = sharded.shard_balances(mesh, balances)
    admitted = []
    torch.cuda.synchronize()
    prof = device_profiler() if profile else contextlib.nullcontext()
    with prof:
        t0 = time.perf_counter()
        for ev in slices:
            tables, adm = step(tables, *ev)
            admitted.append(adm)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    trace = device_busy(prof) if profile else None
    return tables, torch.cat(admitted).cpu().numpy(), elapsed, trace


def run_sharded_apply_phase(dev):
    """Phase sharded_apply: a 2 x 2 (dp, shard) mesh of one card; the
    final table and admitted masks equal the vectorised oracle's and a
    plain-version run's, bit for bit.  Returns (main-path launches,
    check launches)."""
    mesh = sharded.make_mesh([dev] * 4, dp=2)
    n_dp, n_shard = mesh.shape["dp"], mesh.shape["shard"]
    balances, batches = sharded_apply_inputs()
    slices = [sharded.shard_events(mesh, *b) for b in batches]
    n_events = sum(len(b[0]) for b in batches)
    kernels.reset_launches()
    tables, admitted, elapsed, _ = run_sharded_apply(mesh, balances, slices, False)
    launches = dict(kernels.launches)
    nb = len(batches)
    want = {"shard_accumulate": 2 * n_dp * n_shard * nb, "shard_admit": n_dp * n_shard * nb,
            "shard_apply": n_shard * nb}
    for name, count in want.items():
        check(launches[name] == count,
              f"sharded_apply: {launches[name]} {name} launches != {count}")
    got = shard_cases.join_tables(tables)
    del tables
    kernels.reset_launches()
    p_tables, p_admitted, p_elapsed, _ = run_sharded_apply(mesh, balances, slices, True)
    check(not any(kernels.launches[k] for k in want), "sharded_apply: the plain run launched")
    check_launches = dict(kernels.launches)
    check((shard_cases.join_tables(p_tables) == got).all(),
          "sharded_apply: table differs from the plain-version run")
    check((p_admitted == admitted).all(), "sharded_apply: admitted differs from the plain run")
    del p_tables
    t0 = time.perf_counter()
    oracle = balances.copy()
    o_admitted = []
    for b in batches:
        oracle, adm = shard_cases.apply_oracle(oracle, *b)
        o_admitted.append(adm)
    oracle_s = time.perf_counter() - t0
    check((got == oracle).all(), "sharded_apply: table differs from the oracle")
    check((np.concatenate(o_admitted) == admitted).all(),
          "sharded_apply: admitted differs from the oracle")
    n_rej = int((~admitted).sum())
    check(n_rej > 0 and (~admitted[: -len(batches[-1][0])]).sum() == 0,
          "sharded_apply: rejects outside the ceiling batch, or none in it")
    _, prof_admitted, prof_s, trace = run_sharded_apply(mesh, balances, slices, False, True)
    check((prof_admitted == admitted).all(), "sharded_apply: the profiled run differs")
    torch.cuda.empty_cache()
    print(f"phase sharded_apply ({n_dp} x {n_shard} mesh on one card, {A_ROWS} rows, "
          f"{n_events} transfers in {nb} batches of <= {workload.BATCH}): "
          f"{n_events / elapsed:.0f} events/s ({elapsed / nb * 1e3:.3f} ms per batch); "
          f"plain-version run {n_events / p_elapsed:.0f} events/s; numpy oracle {oracle_s:.1f} s; "
          f"{n_rej} rejected (ceiling batch); main-path launches "
          f"{ {k: launches[k] for k in want} }; device busy {_busy_line(trace, prof_s)}; "
          f"table and admitted masks equal the oracle's and the plain run's; checks passed")
    return launches, check_launches


WAVE_SHARD_SEED = 2050
WAVE_SHARD_RUNS = 3  # timed runs of the stream, each on fresh shard tables


def run_sharded_waves_phase(dev):
    """Phase sharded_waves: WAVE_BATCHES full 8190-event batches
    (shard_cases.wave_stream: one wave; a chain wave, then a wave; wave,
    chains, wave, chains), each on its own rows of one 2^20-row table,
    run one after another through _execute_plan_sharded over a 4-shard
    row mesh of one card.  The stream is timed WAVE_SHARD_RUNS times on
    fresh tables (the first run is the main path's); every batch's
    packed outputs and the final joined table equal the dense
    executor's and a plain-version sharded run's.  Returns (main-path
    launches, check launches)."""
    mesh = sharded.make_row_mesh([dev] * SHARDS)
    B = workload.BATCH
    table, batches = shard_cases.wave_stream(WAVE_SHARD_SEED, WAVE_BATCHES, B, A_ROWS)
    fixes = [shard_cases.hist_fix(plan, n, B) for _ev, _dstat, n, _ts, plan in batches]
    n_events = sum(n for _ev, _dstat, n, _ts, _plan in batches)
    kinds = [k for *_b, plan in batches for k, _ in plan.segments]
    want = {"wave_step": kinds.count("wave"), "chain_wave": kinds.count("chains"),
            "exact_init": len(batches), "exact_finalize": len(batches),
            "shard_gather": SHARDS * len(batches), "shard_scatter": SHARDS * len(batches)}
    scratch = waves.WaveScratch(dev)

    def run(plain=False, profile=False):
        tables = sharded.shard_balances(mesh, table)
        outs = []
        torch.cuda.synchronize()
        prof = device_profiler() if profile else contextlib.nullcontext()
        with prof:
            t0 = time.perf_counter()
            for (ev, dstat, n, ts_base, plan), fix in zip(batches, fixes):
                tables, packed = waves._execute_plan_sharded(
                    tables, ev, dstat, n, ts_base, plan, fix, mesh,
                    scratch=None if plain else scratch, plain=plain)
                outs.append(packed)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
        return torch.cat(tables), outs, elapsed, (device_busy(prof) if profile else None)

    launches, rates = None, []
    for _ in range(WAVE_SHARD_RUNS):
        kernels.reset_launches()
        joined, outs, elapsed, _ = run()
        got = dict(kernels.launches)
        for name, count in want.items():
            check(got[name] == count, f"sharded_waves: {got[name]} {name} launches != {count}")
        if launches is None:
            launches, first_joined, first_outs = got, joined, outs
        check(torch.equal(joined, first_joined)
              and all(torch.equal(a, b) for a, b in zip(outs, first_outs)),
              "sharded_waves: a timed run differs from the first")
        rates.append(n_events / elapsed)
        del joined, outs

    kernels.reset_launches()
    p_joined, p_outs, p_elapsed, _ = run(plain=True)
    check(not any(kernels.launches[k] for k in want), "sharded_waves: the plain run launched")
    check(torch.equal(p_joined, first_joined)
          and all(torch.equal(a, b) for a, b in zip(p_outs, first_outs)),
          "sharded_waves: differs from the plain-version run")
    del p_joined, p_outs
    dense = torch.from_numpy(table.view(np.int64).copy()).to(dev)
    for k, ((ev, dstat, n, ts_base, plan), fix) in enumerate(zip(batches, fixes)):
        want_packed = waves.run_create_transfers_waves(dense, ev, dstat, n, ts_base, plan, fix,
                                                       scratch=scratch)
        check(torch.equal(first_outs[k], want_packed),
              f"sharded_waves batch {k}: packed outputs differ from the dense executor's")
    check(torch.equal(first_joined, dense), "sharded_waves: joined table differs from the "
                                            "dense executor's")
    check_launches = dict(kernels.launches)
    del dense
    prof_joined, prof_outs, prof_s, trace = run(profile=True)
    check(torch.equal(prof_joined, first_joined)
          and all(torch.equal(a, b) for a, b in zip(prof_outs, first_outs)),
          "sharded_waves: the profiled run differs")
    del prof_joined, prof_outs, first_joined, first_outs
    torch.cuda.empty_cache()
    spread = ", ".join(f"{r:.0f}" for r in rates)
    print(f"phase sharded_waves ({SHARDS}-shard row mesh on one card, {A_ROWS} rows, "
          f"{len(batches)} batches of {B} events, {n_events} events, {len(kinds)} segments "
          f"({want['wave_step']} wave, {want['chain_wave']} chains)): {rates[0]:.0f} events/s "
          f"({n_events / rates[0] / len(batches) * 1e3:.3f} ms per batch); "
          f"{WAVE_SHARD_RUNS} timed runs {spread} events/s (min {min(rates):.0f}, "
          f"median {sorted(rates)[len(rates) // 2]:.0f}, max {max(rates):.0f}); "
          f"plain-version run {n_events / p_elapsed:.0f} events/s; main-path launches "
          f"{ {k: launches[k] for k in want} }; device busy {_busy_line(trace, prof_s)}; "
          f"packed outputs and tables equal the dense executor's and the plain run's; "
          f"checks passed")
    return launches, check_launches


# K5's and K6's cases for the check: (scenario, kind), the first the one
# timed (the main path's shape: the bench streams' small amounts pick
# linked_small and two_phase_lo; "spread" is "limits" over 1,000
# accounts, as the linked stream's, where the default pool of 24 makes
# every chain contend).
LINKED_CHECKS = [("spread", "linked_small"), ("limits", "linked_small"), ("limits", "linked"), ("multi_iter", "linked_small"),
                 ("nonconverge", "linked_small"), ("precond_sum", "linked"),
                 ("small_wrapped", "linked_small"), ("overflow", "linked"),
                 ("padding", "linked"), ("static", "linked_small")]
TWO_PHASE_CHECKS = [("mixed", "two_phase_lo"), ("mixed", "two_phase"), ("inbatch", "two_phase_lo"),
                    ("durable", "two_phase_lo"), ("races", "two_phase"), ("wide", "two_phase"),
                    ("overflow", "two_phase_lo"), ("underflow", "two_phase"),
                    ("padding", "two_phase_lo"), ("contended", "two_phase_lo"),
                    ("target_static", "two_phase"), ("hot", "two_phase_lo"),
                    ("distinct", "two_phase")]


def _slots_of(pk, n, cols):
    """Distinct rows the packed batch names in slot columns `cols`."""
    w = pk[:n, cols].reshape(-1)
    s = np.concatenate([(w & np.uint64(0xFFFFFFFF)).astype(np.int64),
                        (w >> np.uint64(32)).astype(np.int64)]) - 1
    return np.unique(s[s >= 0])


def check_semantic(dev, report, name, checks, gen, l2_ns=None):
    """K5 or K6 against its plain version ON THE CARD, on 8192-event
    batches (dk.B) over a 2^20-row table whose batch rows are spread
    over it (most above 2^17: the reference's u64-key path): the table
    and the whole ring bit for bit.  The first case is timed."""
    fn = dk.linked if name == "linked" else dk.two_phase
    flag = "small" if name == "linked" else "lo_only"
    rng = np.random.default_rng(2029)
    rows = np.sort(rng.choice(A_ROWS, 8192, replace=False))
    ring = torch.zeros((RING_ROWS, dk.SUMMARY_WORDS), dtype=torch.int64, device=dev)
    scratch = dk.new_scratch(name, A_ROWS, dev)
    slot_cols = [dk.COL_SLOTS] if name == "linked" else [dk.COL_SLOTS, dk.COL_TP_SLOTS]
    for i, (scenario, kind) in enumerate(checks):
        spread = scenario == "spread"
        table, meta, pk, n = gen(900 + i, dk.B, "limits" if spread else scenario, A=A_ROWS,
                                 rows=rows, **({"pool": 1000} if spread else {}))
        variant = {flag: kind.endswith(("_small", "_lo"))}
        t0 = torch.from_numpy(table.view(np.int64).copy()).to(dev)
        m = torch.from_numpy(meta.view(np.int32)).to(dev)
        p = torch.from_numpy(pk.view(np.int64)).to(dev)
        t_k, r_k, t_p, r_p = t0.clone(), ring.clone(), t0.clone(), ring.clone()
        fn(t_k, m, r_k, 7, p, n, 1 << 40, scratch=scratch, **variant)
        torch.cuda.synchronize()
        plain = dk.linked_plain if name == "linked" else dk.two_phase_plain
        plain(t_p, m, r_p, 7, p, n, 1 << 40, **variant)
        torch.cuda.synchronize()
        err = max(max_abs_err(t_k, t_p), max_abs_err(r_k, r_p))
        check(err == 0, f"{name} {kind}[{scenario}]: kernel differs from the plain version")
        s = dk.unpack_summary(to_u64(r_k[7]))
        line = (f"{'K5' if name == 'linked' else 'K6'} {kind}[{scenario}]: bit-exact; "
                f"n_fail={s['n_fail']} overflow={s['overflow']} precond={s['precond']}")
        if name == "linked":
            line += f" iters={s['iters']}"
        if i == 0:
            idx_np = _slots_of(pk, n, slot_cols)
            idx = torch.from_numpy(idx_np).to(dev)
            saved = t0[idx]

            def reset(t):
                return lambda: t.index_copy_(0, idx, saved)

            kernel_names = ("linked_kernel",) if name == "linked" else ("two_phase_kernel",)
            ms, dev_ms, host = kernel_ms(
                lambda: fn(t_k, m, r_k, 7, p, n, 1 << 40, scratch=scratch, **variant),
                reset=reset(t_k), names=kernel_names,
            )
            plain_ms = time_ms(lambda: plain(t_p, m, r_p, 7, p, n, 1 << 40, **variant),
                               reps=5, warm=1, reset=reset(t_p))
            rows_n = len(idx)
            n_bytes = pk.nbytes + rows_n * (64 + 8) + rows_n * 64 + 512
            if name == "linked":
                entries = int(((meta[idx_np, 0] & (dk.AF_DR_LIMIT | dk.AF_CR_LIMIT)) != 0).sum())
                ops = n * K5_OPS_PER_EVENT + 2 * n * K5_OPS_PER_ENTRY_ITER * s["iters"]
            else:
                ops = n * K6_OPS_PER_EVENT
            bound_ms, bound_by = bound(n_bytes, ops)
            r = dict(ms=ms, device_ms=dev_ms, host_ms=host, plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by=bound_by, max_abs_err=err, timed_case=f"{kind}[{scenario}]")
            line += f"; {ms * 1e3:.1f} us/launch, {_dev(dev_ms, host)} {_vs(plain_ms, bound_ms)}"
            if name == "linked":
                # The serial floor: the fixpoint's dependent passes, each
                # at least one L2 round trip; the barrier floor: the
                # cluster barriers of its iterations.
                r["serial_floor_ms"] = s["iters"] * K5_PASSES_PER_ITER * l2_ns * 1e-6
                r["iters"] = s["iters"]
                blocks = kernels.linked_geometry(dk.B)[0]
                sync_us = serial_probes.barrier_sweep(dev)[f"cluster_{blocks}_us"]
                r["barrier_floor_ms"] = s["iters"] * K5_BARRIERS_PER_ITER * sync_us * 1e-3
                line += (f", serial floor {r['serial_floor_ms'] * 1e3:.2f} us = {s['iters']} iters"
                         f" x {K5_PASSES_PER_ITER} passes x {l2_ns:.1f} ns, barrier floor "
                         f"{r['barrier_floor_ms'] * 1e3:.2f} us = {s['iters']} iters x "
                         f"{K5_BARRIERS_PER_ITER} x {sync_us:.3f} us; {entries} limit rows; "
                         f"one cluster of {blocks} blocks")
            else:
                blocks, threads, _smem = kernels.two_phase_geometry(dk.B)
                r["rows"] = rows_n
                line += (f"; {rows_n} rows; one cooperative grid of {blocks} blocks x "
                         f"{threads} threads")
            report[name] = r
        print(line)
    if name == "linked":
        # The first timed batch of the linked phase, as the device engine
        # launched K5 on it: kernel against plain version, then timed.
        table, meta, pk, n, small = serial_probes.linked_phase_batch(dev)
        r_k = torch.zeros((RING_ROWS, dk.SUMMARY_WORDS), dtype=torch.int64, device=dev)
        t_k, t_p, r_p = table.clone(), table.clone(), r_k.clone()
        dk.linked(t_k, meta, r_k, 7, pk, n, 1 << 40, small=small)
        dk.linked_plain(t_p, meta, r_p, 7, pk, n, 1 << 40, small=small)
        torch.cuda.synchronize()
        err = max(max_abs_err(t_k, t_p), max_abs_err(r_k, r_p))
        check(err == 0, "linked: K5 differs from the plain version on a linked-phase batch")
        report[name]["max_abs_err"] = max(report[name]["max_abs_err"], err)
        sweep = serial_probes.k5_sweep(dev)
        report[name]["sweep"] = sweep
        for case in ("timed", "linked_phase"):
            c = sweep[case]
            print(f"K5 {case} batch ({c['events']} events, {c['iters']} iterations, "
                  f"{c['geometry'][0]} blocks x {c['geometry'][1]} threads): "
                  f"{_dev_us(c['device_us'])}; stages (cycles at {sweep['sm_clock_khz']} kHz): "
                  + ", ".join(f"{k} {v:.0f}" for k, v in c["stage_cycles"].items()))


# ---------------------------------------------------------------------------
# The wave kernels, at the main path's shapes on a 2^20-row table.


def _rows_of(ev, n):
    """Distinct table rows a batch's first n events name."""
    cols = [np.asarray(ev[c][:n], np.int64) for c in ("dr_slot", "cr_slot", "p_dr_slot",
                                                       "p_cr_slot")]
    s = np.concatenate(cols)
    return np.unique(s[s >= 0])


def _wave_pair(dev, table, ev, dstat):
    """[table, packed events, carry] on the card for the kernel and for
    its plain version (also on the card), the carry from tb_exact_init
    and from make_carry respectively."""
    t = torch.from_numpy(table.view(np.int64).copy()).to(dev)
    pk = torch.from_numpy(k3.pack_events(ev).view(np.int64)).to(dev)
    ds = torch.from_numpy(dstat.view(np.int32)).to(dev)
    w = torch.empty(k3.scratch_words(pk.shape[0]), dtype=torch.int64, device=dev)
    k3.exact_init(w, ds)
    w_p = k3.make_carry(torch.empty_like(w), ds)
    return [t, pk, w], [t.clone(), pk, w_p]


def _err(a, b):
    return max(max_abs_err(a[0], b[0]), max_abs_err(a[2], b[2]))


def _resetter(state, rows):
    """Restores a state's touched table rows and its carry (outside the
    timed events)."""
    t, _pk, w = state
    saved_rows, saved_w = t[rows].clone(), w.clone()
    return lambda: (t.index_copy_(0, rows, saved_rows), w.copy_(saved_w))


def _wave_bytes(lanes, rows):
    """Least bytes of a wave-like step: each lane's event row (52 words)
    and index read, its touched rows read and written, ~35 carry words
    written (result, mask, record, status, snapshots, pulses)."""
    return lanes * (416 + 4) + rows * 128 + lanes * 35 * 8


def check_waves(dev, report, l2_ns):
    """K7, K8, K9, a K3 segment and K3's init and finalize against their
    plain versions on the card, bit for bit (table and carry), at the
    main path's shapes; each timed."""
    rng = np.random.default_rng(2030)
    pool = np.sort(rng.choice(A_ROWS, 200_000, replace=False))
    scratch = waves.WaveScratch(dev)

    # K7: one 8190-lane wave, without and with a commit mask.
    table, ev, dstat, n, ts_base, plan = wave_cases.wide_case(31, 8192, A_ROWS, rows=pool)
    idx = torch.from_numpy(np.asarray(plan.segments[0][1], np.int32)).to(dev)
    rows = torch.from_numpy(_rows_of(ev, n)).to(dev)
    K = idx.numel()
    errs = []
    for masked in (False, True):
        kern, plain = _wave_pair(dev, table, ev, dstat)
        mask = None
        if masked:
            mask = torch.from_numpy((np.random.default_rng(4).random(K) < 0.7)
                                    .astype(np.uint8)).to(dev)
        waves.wave_step(*kern, idx, n, ts_base, mask=mask)
        waves.wave_step_plain(*plain, idx, n, ts_base, mask)
        torch.cuda.synchronize()
        errs.append(_err(kern, plain))
        check(errs[-1] == 0, f"K7 wave_step (mask {masked}): kernel differs from the plain version")
    kern, plain = _wave_pair(dev, table, ev, dstat)
    ms, dev_ms, host = kernel_ms(lambda: waves.wave_step(*kern, idx, n, ts_base),
                                 reset=_resetter(kern, rows), names=("wave_",))
    plain_ms = time_ms(lambda: waves.wave_step_plain(*plain, idx, n, ts_base), reps=5, warm=1,
                       reset=_resetter(plain, rows))
    bound_ms, bound_by = bound(_wave_bytes(K, rows.numel()), K * K7_OPS_PER_LANE)
    report["wave_step"] = dict(ms=ms, device_ms=dev_ms, host_ms=host,
                               plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by, max_abs_err=max(errs),
                               timed_case=f"{K}-lane wave")
    print(f"K7 wave_step ({K} lanes, unmasked and masked): bit-exact; {ms * 1e3:.1f} us, "
          f"{_dev(dev_ms, host)} {_vs(plain_ms, bound_ms)}")

    # K9, then the whole speculative step (K9 + K7 with commit mask =
    # not conflicted) on an 8190-event batch of every shape.
    from tigerbeetle_tpu_torch.state_machine import resolve

    table, ev, dstat, n, ts_base = scan_cases.make_case(2031, 8192, "mixed", A=A_ROWS,
                                                        rows=pool[:8192], n=8190)
    meta = resolve.spec_meta_from_events(ev, n, False)
    pk = torch.from_numpy(k3.pack_events(ev).view(np.int64)).to(dev)
    sidx = torch.arange(n, dtype=torch.int32, device=dev)
    serial = torch.from_numpy(meta["chain_member"].astype(np.uint8)).to(dev)
    f_k = waves.spec_conflicts(pk, sidx, serial, n, A_ROWS, scratch=scratch)
    f_p = waves.spec_conflicts_plain(pk, sidx, serial, n, A_ROWS).to(torch.uint8)
    torch.cuda.synchronize()
    err = max_abs_err(f_k.long(), f_p.long())
    check(err == 0, "K9 spec_conflicts: kernel differs from the plain version")

    def spec_pair(ev_x, n_x, ser_x):
        """K9 on `scratch` and the plain version (on the card) of one
        batch's n_x lanes: (kernel flags, plain flags, packed, idx, serial)."""
        pk_x = torch.from_numpy(k3.pack_events(ev_x).view(np.int64)).to(dev)
        idx_x = torch.arange(n_x, dtype=torch.int32, device=dev)
        s_x = torch.from_numpy(np.ascontiguousarray(ser_x[:n_x])).to(dev)
        got = waves.spec_conflicts(pk_x, idx_x, s_x, n_x, A_ROWS, scratch=scratch)
        want = waves.spec_conflicts_plain(pk_x, idx_x, s_x, n_x, A_ROWS).to(torch.uint8)
        torch.cuda.synchronize()
        return got, want, pk_x, idx_x, s_x

    # Seven batches of seven classes over the same rows, back to back on
    # the one scratch, then a batch whose slots, groups and targets are
    # all distinct (no conflict but the serial mask's), timed.
    for ev_s, n_s, ser_s in wave_cases.spec_stream(2034, 7, 8192, A_ROWS, rows=pool[:8192]):
        got, want = spec_pair(ev_s, n_s, ser_s)[:2]
        err = max(err, max_abs_err(got.long(), want.long()))
        check(err == 0, "K9 spec_conflicts: a back-to-back call differs from the plain version")
    ev_d, n_d, ser_d = wave_cases.distinct_spec_case(2033, 8192, A_ROWS, n=8190)
    got, want, pk_d, idx_d, s_d = spec_pair(ev_d, n_d, ser_d)
    err = max(err, max_abs_err(got.long(), want.long()))
    check(err == 0 and torch.equal(got, s_d),
          "K9 spec_conflicts: the distinct-slot batch differs from the plain version")
    d_ms, d_dev_ms, _ = kernel_ms(lambda: waves.spec_conflicts(pk_d, idx_d, s_d, n_d, A_ROWS,
                                                               scratch=scratch),
                                  names=("spec_",))
    spec = []
    for plain_fns in (False, True):
        t = torch.from_numpy(table.view(np.int64).copy()).to(dev)
        carry, confl = waves.run_speculative_engine(t, ev, dstat, meta["chain_member"], n,
                                                    ts_base, scratch=scratch, plain=plain_fns)
        torch.cuda.synchronize()
        spec.append([t, None, carry.words[:k3.scratch_words(8192)].clone(), confl])
    err_s = max(_err(spec[0], spec[1]), max_abs_err(spec[0][3].long(), spec[1][3].long()))
    check(err_s == 0, "K9 + K7 speculative step: kernels differ from the plain versions")
    ms, dev_ms, host = kernel_ms(lambda: waves.spec_conflicts(pk, sidx, serial, n, A_ROWS,
                                                              scratch=scratch),
                                 names=("spec_",))
    plain_ms = time_ms(lambda: waves.spec_conflicts_plain(pk, sidx, serial, n, A_ROWS),
                       reps=5, warm=1)
    bound_ms, bound_by = bound(n * (12 * 8 + 4 + 1 + 1), n * K9_OPS_PER_LANE)
    report["spec_conflicts"] = dict(ms=ms, device_ms=dev_ms, host_ms=host, plain_ms=plain_ms,
                                    bound_ms=bound_ms, bound_by=bound_by,
                                    max_abs_err=max(err, err_s),
                                    timed_case=f"{n}-event batch, {int(f_k.sum())} conflicted",
                                    cases={"distinct": dict(events=n_d, ms=d_ms,
                                                            device_ms=d_dev_ms)})
    print(f"K9 spec_conflicts ({n} events, {int(f_k.sum())} conflicted; then K7 with the "
          f"commit mask; seven batches back to back on one scratch; a distinct-slot batch "
          f"{d_ms * 1e3:.1f} us, {_dev(d_dev_ms)}): bit-exact; {ms * 1e3:.1f} us, "
          f"{_dev(dev_ms, host)} {_vs(plain_ms, bound_ms)}")

    # K8: 8 positions x 4096 chains (hub accounts credited by many
    # chains, chains that die), and a 7-member shape.
    errs = []
    for n_chains, max_len in ((1000, 7), (4096, 2)):
        table, ev, dstat, n, ts_base, plan = wave_cases.chain_case(
            2032 + max_len, n_chains, 8192, A=A_ROWS, rows=pool, max_len=max_len)
        P = plan.chain_steps[0]
        plane = torch.from_numpy(waves._chain_plane(ev["flags"], plan.segments[0][1], P,
                                                    8192)).to(dev)
        kern, plain = _wave_pair(dev, table, ev, dstat)
        waves.chain_wave(*kern, plane, n, ts_base)
        waves.chain_wave_plain(*plain, plane, n, ts_base)
        torch.cuda.synchronize()
        errs.append(_err(kern, plain))
        check(errs[-1] == 0,
              f"K8 chain_wave ({n_chains} chains): kernel differs from the plain version")
        dead = int((k3.carry_to_dict(kern[2], 8192)["results"][:n] == 1).sum())
    rows = torch.from_numpy(_rows_of(ev, n)).to(dev)
    kern, plain = _wave_pair(dev, table, ev, dstat)
    ms, dev_ms, host = kernel_ms(
        lambda: waves.chain_wave(*kern, plane, n, ts_base),
        reset=_resetter(kern, rows), names=("chain_wave",))
    plain_ms = time_ms(lambda: waves.chain_wave_plain(*plain, plane, n, ts_base), reps=5,
                       warm=1, reset=_resetter(plain, rows))
    bound_ms, bound_by = bound(_wave_bytes(n, rows.numel()), n * K8_OPS_PER_CELL)
    serial_ms = 2 * P * l2_ns * 1e-6
    # The barrier floor: 2P cluster barriers (K8 runs 2P - 1) of the
    # cluster this plane launches.
    blocks, threads = kernels.chain_wave_geometry(plane.shape[1])
    barriers = serial_probes.barrier_sweep(dev)
    sync_us = barriers.get(f"cluster_{blocks}_us")
    if sync_us is None:  # a cluster size the probe does not time: the next one up
        sync_us = barriers[f"cluster_{min(g for g in (2, 8, 16) if g >= blocks)}_us"]
    barrier_ms = 2 * P * sync_us * 1e-3
    sweep = serial_probes.k8_sweep(dev)
    report["chain_wave"] = dict(ms=ms, device_ms=dev_ms, host_ms=host,
                                plain_ms=plain_ms, bound_ms=bound_ms,
                                bound_by=bound_by, max_abs_err=max(errs),
                                serial_floor_ms=serial_ms, barrier_floor_ms=barrier_ms,
                                barriers=barriers, sweep=sweep,
                                timed_case=f"P={P} x C={plane.shape[1]}, {dead} failed members, "
                                           f"{blocks} blocks x {threads} threads")
    print(f"K8 chain_wave (P={P} x C={plane.shape[1]}, {dead} members failed or rolled back; "
          f"one cluster of {blocks} blocks x {threads} threads): "
          f"bit-exact; {ms * 1e3:.1f} us, {_dev(dev_ms, host)} {_vs(plain_ms, bound_ms)}, "
          f"position floor {serial_ms * 1e3:.2f} us = {2 * P} phases x {l2_ns:.1f} ns, "
          f"barrier floor {barrier_ms * 1e3:.2f} us = {2 * P} x {sync_us:.3f} us")
    print("barriers (us each): " + ", ".join(
        f"{k[:-3]} {v:.3f}" if k.endswith("_us") else f"{k} {v}" for k, v in barriers.items()))
    print("K8 sweep (device us per chain wave): " + "; ".join(
        f"C={r['chains']} chains of 2..{r['max_len']} (P={r['P']}, {r['events']} events) "
        f"{_dev_us(r['device_us'])}" for r in sweep))

    # A K3 segment resumed mid-batch from K7 carries, then finalize and
    # init, on a linked-class batch over 8192 rows.
    table, ev, dstat, n, ts_base, plan = wave_cases.plan_case(
        2034, 8192, "linked", A=A_ROWS, rows=pool[:8192], n=8190)
    kern, _ = _wave_pair(dev, table, ev, dstat)
    first_wave = next(k for k, (kind, _) in enumerate(plan.segments) if kind == "wave")
    seg_at = max((k for k, (kind, _) in enumerate(plan.segments)
                  if kind == "scan" and k > first_wave),
                 key=lambda k: len(plan.segments[k][1]))
    for kind, ix in plan.segments[:seg_at]:
        ixt = torch.from_numpy(np.asarray(ix, np.int32)).to(dev)
        if kind == "wave":
            waves.wave_step(*kern, ixt, n, ts_base)
        else:
            k3.scan_segment(kern[0], kern[1], kern[2], ixt, n, ts_base)
    plain = [kern[0].clone(), kern[1], kern[2].clone()]
    seg = torch.from_numpy(np.asarray(plan.segments[seg_at][1], np.int32)).to(dev)
    k3.scan_segment(kern[0], kern[1], kern[2], seg, n, ts_base)
    k3.scan_segment_plain(plain[0], plain[1], plain[2], seg, n, ts_base)
    torch.cuda.synchronize()
    err = _err(kern, plain)
    check(err == 0, "K3 exact_segment: kernel differs from the plain version")
    L = seg.numel()
    rows = torch.from_numpy(_rows_of(ev, n)).to(dev)
    ms, dev_ms, host = kernel_ms(
        lambda: k3.scan_segment(kern[0], kern[1], kern[2], seg, n, ts_base),
        reset=_resetter(kern, rows), names=("segment_kernel",))
    plain_ms = time_ms(lambda: k3.scan_segment_plain(plain[0], plain[1], plain[2], seg, n,
                                                     ts_base),
                       reps=3, warm=1, reset=_resetter(plain, rows))
    bound_ms, bound_by = bound(L * (416 + 4) + rows.numel() * 128 + L * 50 * 8,
                               L * K3_OPS_PER_EVENT)
    sweep = serial_probes.k3_sweep(dev)
    report["exact_segment"] = dict(ms=ms, device_ms=dev_ms, host_ms=host, plain_ms=plain_ms,
                                   bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
                                   serial_floor_ms=L * l2_ns * 1e-6, sweep=sweep,
                                   timed_case=f"{L}-event segment after {seg_at} segments")
    print(f"K3 exact_segment ({L} events, resumed after {seg_at} segments): bit-exact; "
          f"{ms * 1e3:.1f} us, {_dev(dev_ms, host)} {_vs(plain_ms, bound_ms)}, "
          f"serial floor {L * l2_ns * 1e-3:.1f} us")
    print("K3 length sweep (device us, events [0, L) from a fresh carry): " + ", ".join(
        f"L={k} {_dev_us(v)}" for k, v in sweep["segment_us"].items())
        + f"; fixed {sweep['fixed_us']:.2f} us + {sweep['per_event_us']:.3f} us per event; "
          f"whole scan {_dev_us(sweep['scan_us'])} for {sweep['scan_events']} events")

    B = 8192
    fix = torch.zeros(B, dtype=torch.uint8)
    fix[:n] = torch.from_numpy(plan.wave_mask.astype(np.uint8))
    fix = fix.to(dev)
    out_k = k3.finalize(kern[0], kern[2], B, fix)
    out_p = k3.finalize_plain(kern[0], kern[2], B, fix)
    torch.cuda.synchronize()
    err = max_abs_err(out_k, out_p)
    check(err == 0, "K3 exact_finalize: kernel differs from the plain version")
    ms, dev_ms, host = kernel_ms(lambda: k3.finalize(kern[0], kern[2], B, fix),
                                 names=("finalize_kernel",))
    plain_ms = time_ms(lambda: k3.finalize_plain(kern[0], kern[2], B, fix), reps=5, warm=1)
    n_fix = int(fix.sum())
    bound_ms, bound_by = bound(B * 36 * 8 + B + n_fix * 128 + B * k3.N_COLS * 8, B * 40)
    report["exact_finalize"] = dict(ms=ms, device_ms=dev_ms, host_ms=host, plain_ms=plain_ms,
                                    bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
                                    timed_case=f"B={B}, {n_fix} snapshots rewritten")
    print(f"K3 exact_finalize (B={B}, {n_fix} rewritten): bit-exact; {ms * 1e3:.1f} us, "
          f"{_dev(dev_ms, host)} {_vs(plain_ms, bound_ms)}")

    # Finalize alone on seeded carries: an odd B that is no multiple of
    # the kernel's tile, no row / every row / a third fixed, rewrites at
    # created slots that clip, a compact table, and a carry one word off
    # 16-byte alignment.
    for fb, fa, off in ((203, 37, 0), (B, A_ROWS, 1), (97, 5000, 1)):
        for mode in wave_cases.FIX_MODES:
            f_table, f_words, f_fix = wave_cases.finalize_case(fb + fa + off, fb, fa, mode)
            f_t = torch.from_numpy(f_table.view(np.int64)).to(dev)
            f_w = torch.zeros(f_words.size + off, dtype=torch.int64, device=dev)[off:]
            f_w.copy_(torch.from_numpy(f_words.view(np.int64)))
            f_hf = None if f_fix is None else torch.from_numpy(f_fix.astype(np.uint8)).to(dev)
            f_err = max_abs_err(k3.finalize(f_t, f_w, fb, f_hf), k3.finalize_plain(f_t, f_w, fb, f_hf))
            check(f_err == 0, f"K3 exact_finalize (B={fb}, A={fa}, fix {mode}, carry offset {off}): "
                              "kernel differs from the plain version")
    blocks, threads = kernels.exact_finalize_geometry(B)
    print(f"K3 exact_finalize on seeded carries (B = 203, 8192, 97; fix none / all / a third; "
          f"clipped slots; carry offsets 0, 1 word): bit-exact; {blocks} blocks x {threads} "
          f"threads at B = {B}")
    report["exact_finalize"]["geometry"] = [blocks, threads]

    ds = torch.from_numpy(dstat.view(np.int32)).to(dev)
    w_k = torch.empty(k3.scratch_words(B), dtype=torch.int64, device=dev)
    w_p = torch.empty_like(w_k)
    k3.exact_init(w_k, ds)
    k3.make_carry(w_p, ds)
    torch.cuda.synchronize()
    err = max_abs_err(w_k, w_p)
    check(err == 0, "K3 exact_init: kernel differs from the plain version")
    # The 8-byte path: an odd batch, and carries one word off 16-byte
    # alignment; the words past the carry keep their sentinel.
    init_rng = np.random.default_rng(2043)
    for ib, off in ((4097, 0), (B, 1), (4097, 1)):
        n_w = k3.scratch_words(ib)
        ids = torch.from_numpy(init_rng.integers(-(1 << 31), 1 << 31, ib, dtype=np.int64)
                               .astype(np.int32)).to(dev)
        base = torch.full((n_w + off + 1,), 0x5A5A5A5A5A5A5A5A, dtype=torch.int64, device=dev)
        k3.exact_init(base[off:off + n_w], ids)
        want = k3.make_carry(torch.empty(n_w, dtype=torch.int64, device=dev), ids)
        torch.cuda.synchronize()
        err = max(err, max_abs_err(base[off:off + n_w], want))
        check(err == 0 and int(base[-1]) == 0x5A5A5A5A5A5A5A5A,
              f"K3 exact_init (B={ib}, carry offset {off}): kernel differs from the plain "
              "version or wrote past the carry")
    ms, dev_ms, host = kernel_ms(lambda: k3.exact_init(w_k, ds), names=("init_kernel",))
    plain_ms = time_ms(lambda: k3.make_carry(w_p, ds), reps=5, warm=1)
    # Yardstick, not the same function: zero_() of the same words.
    z_ms, z_dev, z_host = kernel_ms(w_p.zero_)
    bound_ms, bound_by = bound(B * 4 + k3.scratch_words(B) * 8, k3.scratch_words(B))
    report["exact_init"] = dict(ms=ms, device_ms=dev_ms, host_ms=host,
                                plain_ms=plain_ms, bound_ms=bound_ms,
                                bound_by=bound_by, max_abs_err=err, timed_case=f"B={B}",
                                yardstick=dict(call="zero_ of the carry's words", ms=z_ms,
                                               device_ms=z_dev, host_ms=z_host))
    print(f"K3 exact_init (B={B}; also B=4097 and carries one word off alignment): "
          f"bit-exact; {ms * 1e3:.1f} us, {_dev(dev_ms, host)} {_vs(plain_ms, bound_ms)}; "
          f"zero_() of the same words {z_ms * 1e3:.1f} us, {_dev(z_dev, z_host)}")


def k7_lanes(dev, report, main_lanes):
    """K7's lanes per wave on the main path (median, p90, max per phase
    and over both), and its device time at the median, the p90 and 8190
    lanes."""
    stats = {}
    for name, ks in list(main_lanes.items()) + [("both", sum(main_lanes.values(), []))]:
        k = np.asarray(ks)
        stats[name] = dict(waves=int(k.size), median=int(np.median(k)),
                           p90=int(np.percentile(k, 90, method="higher")), max=int(k.max()))
    both = stats["both"]
    rng = np.random.default_rng(2030)
    pool = np.sort(rng.choice(A_ROWS, 200_000, replace=False))
    for K in sorted({both["median"], both["p90"]}):
        table, ev, dstat, n, ts_base, plan = wave_cases.wide_case(31, 8192, A_ROWS, rows=pool, n=K)
        idx = torch.from_numpy(np.asarray(plan.segments[0][1], np.int32)).to(dev)
        kern, plain = _wave_pair(dev, table, ev, dstat)
        waves.wave_step(*kern, idx, n, ts_base)
        waves.wave_step_plain(*plain, idx, n, ts_base)
        torch.cuda.synchronize()
        err = _err(kern, plain)
        check(err == 0, f"K7 wave_step ({K} lanes): kernel differs from the plain version")
        report["wave_step"]["max_abs_err"] = max(report["wave_step"]["max_abs_err"], err)
    sweep = serial_probes.k7_sweep(dev, lanes=sorted({both["median"], both["p90"], 8190}))
    report["wave_step"]["sweep"] = {"main_path_lanes": stats, "by_lanes": sweep}
    print("K7 lanes per wave on the main path: " + "; ".join(
        f"{n} {s['waves']} waves, median {s['median']}, p90 {s['p90']}, max {s['max']}"
        for n, s in stats.items()))
    print("K7 sweep (device us per wave): " + "; ".join(
        f"K={r['K']} ({r['geometry'][0]} blocks x {r['geometry'][1]}, barrier "
        f"{('block', 'cluster', 'grid')[r['geometry'][2]]}) {_dev_us(r['device_us'])}"
        + "".join(f", {k[:-3]} {_dev_us(v)}" for k, v in r.items()
                  if k.endswith("_us") and k != "device_us")
        for r in sweep))


# ---------------------------------------------------------------------------
# The main path: TorchStateMachine driven through the harness.


def failure_stream(n_batches: int, batch: int):
    """gen_simple over 1000 accounts, but 100 events per batch debit a
    nonexistent account and 20 name the same account twice: more than
    FAIL_CAP failures in every batch.  A last batch debits account 1
    twice by ~2^127 (the reference's test_fallback_overflow_orderfree
    shape): K1 flags it and its exact re-execution ranks the overflow
    codes through K3."""
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
    arr = np.frombuffer(timed[-1][1], TRANSFER_DTYPE).copy()
    arr["id_lo"] += np.uint64(batch)
    arr["debit_account_id_lo"][:2] = 1
    arr["credit_account_id_lo"][:2] = [2, 3]
    arr["amount_lo"][:2] = 5
    arr["amount_hi"][:2] = 1 << 63
    timed.append((Operation.create_transfers, arr.tobytes()))
    return setup, timed


def expiry_stream(n_batches: int, batch: int, n_accounts: int):
    """n_batches of pending transfers with timeouts of 1-8 s over
    n_accounts; then the realtime moves 20 s past them and one more
    (plain) batch follows: the harness injects the pulses before it, and
    they expire every pending."""
    setup, _, _ = workload.gen_simple(batch, n_accounts=n_accounts, batch=batch)
    rng = np.random.default_rng(48)
    timed = []
    tid = workload.TID0
    for _ in range(n_batches + 1):
        dr = rng.integers(1, n_accounts + 1, batch).astype(np.uint64)
        last = len(timed) == n_batches
        body = workload.transfers_bytes(
            np.arange(tid, tid + batch, dtype=np.uint64), dr,
            dr % np.uint64(n_accounts) + np.uint64(1), rng.integers(1, 100, batch),
            flags=None if last else np.full(batch, int(TransferFlags.pending), np.uint16),
            timeout=None if last else rng.integers(1, 9, batch),
        )
        if last:
            late = 20 * 1_000_000_000
            timed.append((Operation.lookup_accounts, ids_bytes([1]), late))
            timed.append((Operation.create_transfers, body, late + 1))
        else:
            timed.append((Operation.create_transfers, body))
        tid += batch
    return setup, timed


class HostSplit:
    """Host seconds of a host-engine run's timed batches by part: each
    native lane's calls into the library, the write-behind flushes (the
    queue's compaction and the K4 launches), and the rest (decode,
    joins, store and reply bookkeeping in Python), as the difference to
    the timed run's wall clock."""

    NATIVE = ("commit_transfers", "commit_linked", "commit_two_phase", "commit_exact")

    def __init__(self):
        self.seconds = collections.Counter()

    def _wrap(self, obj, name, key):
        fn = getattr(obj, name)

        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.seconds[key] += time.perf_counter() - t0

        setattr(obj, name, timed)

    def attach(self, sm):
        if sm._native is not None:
            for name in self.NATIVE:
                self._wrap(sm._native, name, name)
        self._wrap(sm._dev, "flush", "flush")

    def line(self, elapsed: float) -> str:
        parts = {k: v for k, v in self.seconds.items() if v}
        rest = elapsed - sum(parts.values())
        return " ".join(f"{k}={v:.3f}s" for k, v in sorted(parts.items())) + f" rest={rest:.3f}s"


def semantic_routed(sm) -> dict:
    """{"linked": batches the device engine's router sent to K5,
    "two_phase": to K6} (the host engine sends none); stat_linked_batches
    and stat_two_phase_batches also count the host path's lanes, as the
    reference's counters do."""
    kinds = getattr(sm._dev, "stat_semantic_batches", {})
    return {"linked": kinds.get("linked", 0) + kinds.get("linked_small", 0),
            "two_phase": kinds.get("two_phase", 0) + kinds.get("two_phase_lo", 0)}


def native_counters(sm) -> str:
    """The host path's lane counters: whether the native library is on,
    the events the fast lanes took (stat_device_events: the order-free,
    linked and two-phase lanes, native or Python), the batches each
    native bookkeeping tail took, and the exact path's events."""
    return (f"native {'on' if sm._native is not None else 'off'}: fast-lane events "
            f"{sm.stat_device_events}, hot / slow tail batches {sm.stat_hot_tail_batches} / "
            f"{sm.stat_slow_tail_batches}, exact-path events {sm.stat_exact_events}")


def _submit(h, item):
    op, body = item[0], item[1]
    return h.submit_async(op, body, realtime=item[2] if len(item) > 2 else None)


def run_stream(setup, timed, account_capacity, transfer_capacity, plain, engine,
               profile=False, devices=None, checkpoint=False, named=(), split=None):
    """Drive one stream through the harness.  The launch counts are set
    to 0 just before the state machine is built and read just after the
    stream has drained (device engine) or flushed (host engine), and
    after the checkpoint tripwire (verify_device_mirror) when
    `checkpoint`.  `devices` is the machine's device list (None: every
    visible card, as a user's call).  Returns (machine, replies, seconds
    of the timed batches, launches, device trace or None); the trace
    carries a third item, {key: device ms} of the device functions whose
    names hold each key of `named`, when `named` is given, and a fourth,
    {key: their count}.  A HostSplit `split` times the host engine's
    parts over the timed batches."""
    kernels.reset_launches()
    sm = TorchStateMachine(
        account_capacity=account_capacity, transfer_capacity=transfer_capacity,
        plain=plain, engine=engine, devices=devices,
    )
    if split is not None:
        split.attach(sm)
    h = SingleNodeHarness(sm)
    replies = [h.submit(op, body) for op, body in setup]
    torch.cuda.synchronize()
    if split is not None:
        split.seconds.clear()
    for timer in ENGINE_TIMERS:  # count the timed batches only
        if hasattr(sm._dev, timer):
            setattr(sm._dev, timer, 0.0)
    prof = device_profiler() if profile else contextlib.nullcontext()
    with prof:
        t0 = time.perf_counter()
        futs = [_submit(h, item) for item in timed]
        replies += [f.result() for f in futs]
        if engine == "device":
            sm._dev.drain()
        else:
            sm._dev.read()  # the write-behind lane's flush barrier
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    if checkpoint:
        sm.verify_device_mirror()
    launches = dict(kernels.launches)
    trace = device_busy(prof) if profile else None
    if trace is not None and named:
        trace = trace + (device_named_ms(prof, named), device_named_count(prof, named))
    return sm, replies, elapsed, launches, trace


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


def device_named_ms(prof, keys) -> dict:
    """{key: device ms of the trace's device functions whose name holds
    key}."""
    from torch.autograd import DeviceType

    out = dict.fromkeys(keys, 0.0)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for key in keys:
                if key in e.name:
                    out[key] += e.time_range.elapsed_us() / 1e3
    return out


def device_named_count(prof, keys) -> dict:
    """{key: the trace's device functions whose name holds key}."""
    from torch.autograd import DeviceType

    out = dict.fromkeys(keys, 0)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for key in keys:
                out[key] += key in e.name
    return out


# Host wall-clock split of the engine (upload + launch enqueue, ring
# fetch = the one device synchronisation per window, host bookkeeping).
# stat_t_rows and stat_t_remap are the sharded engine's parts of h2d.
ENGINE_TIMERS = ("stat_t_h2d", "stat_t_rows", "stat_t_remap", "stat_t_dispatch",
                 "stat_t_fetch", "stat_t_finish")


def transfer_events(ops) -> int:
    return sum(
        len(item[1]) // TRANSFER_DTYPE.itemsize
        for item in ops if item[0] == Operation.create_transfers
    )


def host_digest(sm) -> np.ndarray:
    """Host engine: the from-scratch digest of the device table with the
    meta columns of the attribute store (K2 rebuild on the card, a
    check-only launch: the host engine keeps no device digest)."""
    table = sm._dev.read()
    A = table.shape[0]
    meta = torch.from_numpy(
        sm._commit_meta_cols(np.arange(A, dtype=np.int64)).view(np.int32)
    ).to(table.device)
    rows = torch.arange(A, dtype=torch.int64, device=table.device)
    return to_u64(cm.rebuild(table, meta, rows)[1])


def tables_of(sm):
    """The device tables (drained and flushed): hot-shaped under
    tiering."""
    if sm.engine == "device":
        return sm._dev.to_numpy_tables()
    sm._dev.flush()
    return (to_u64(sharded.dense(sm._dev.balances)),)


def scrub_line(sm) -> str:
    dev = sm._dev
    if sm.engine != "device":
        return "host engine: no scrub"
    return (f"scrubs {dev.stat_scrubs} (K2 probe {dev.stat_scrub_cheap}, full fetch "
            f"{dev.stat_scrub_fallback}, heals {dev.stat_scrub_heals}), demotions "
            f"{dev.stat_demotions}, link errors {dev.stat_link_errors}")


def check_link_quiet(name, sm, launches):
    """Outside the lifecycle phase nothing demotes or errs on the link,
    and K2 probe's main-path launches are the scrubs' cheap compares
    (one a scrub, one a shard sharded; the device-engine runs end
    without a tripwire before their counts are read).  The host engine
    launches none: it keeps no device digest, its tripwire is K11."""
    dev = sm._dev
    if sm.engine != "device":
        check(launches["commit_probe"] == 0, f"{name}: the host engine launched K2 probe")
        return
    check(dev.stat_demotions == 0 and dev.stat_link_errors == 0,
          f"{name}: {dev.stat_demotions} demotions, {dev.stat_link_errors} link errors")
    check(dev.stat_scrub_heals == 0, f"{name}: a scrub healed a divergence")
    per = len(dev.balances.shards) if dev.sharding is not None else 1
    want = dev.stat_scrub_cheap * per
    check(launches["commit_probe"] == want,
          f"{name}: {launches['commit_probe']} K2 probe launches != {want} "
          f"({dev.stat_scrub_cheap} cheap scrubs)")


def run_phase(name, setup, timed, account_capacity, engine="device", must=(),
              expect_fallbacks=False, extra=None):
    """Run one phase: the main-path run, its checks, the plain-version
    run on the card, and a profiled run.  `must` names the kernels the
    main path has to launch; `extra(sm, replies)` adds phase checks.
    The host engine's main-path run also gives its host split.  Returns
    (main-path launches, check launches)."""
    transfer_capacity = transfer_events(setup + timed) + 1024
    host_split = HostSplit() if engine == "host" else None
    sm, replies, elapsed, launches, _ = run_stream(
        setup, timed, account_capacity, transfer_capacity, False, engine, split=host_split
    )
    for kname in must:
        check(launches[kname] > 0, f"{name}: {kname} was not launched")
    check_link_quiet(name, sm, launches)
    check(launches["exact_scan"] == sm.stat_exact_batches,
          f"{name}: {launches['exact_scan']} K3 launches != {sm.stat_exact_batches} exact batches")
    # K5 and K6 launch once per batch the device engine's router sent
    # them (a flagged batch is launched and re-executed exactly, and
    # recovery launches the window's later batches again: then at least
    # once); the batches the host path's lanes took launch neither.
    routed = semantic_routed(sm)
    for kname in ("linked", "two_phase"):
        same = (launches[kname] == routed[kname] if sm.stat_fallback_events == 0
                else launches[kname] >= routed[kname])
        check(same, f"{name}: {launches[kname]} {kname} launches != {routed[kname]} routed batches")
    # Every wave or speculative execution initialises and finalizes one
    # carry: host wave batches once, window records once (again when
    # exact recovery re-runs a window's later records).
    executed = sm.stat_wave_batches + sm.stat_dev_wave_batches
    check(launches["exact_init"] == launches["exact_finalize"],
          f"{name}: K3 init and finalize launches differ")
    check(launches["exact_init"] == executed if sm.stat_fallback_events == 0
          else launches["exact_init"] >= executed,
          f"{name}: {launches['exact_init']} carries for {executed} wave executions")
    n_transfers = transfer_events(setup + timed)
    n_timed = transfer_events(timed)
    dev = sm._dev
    # Every event's code came from a semantic kernel (K1, K5, K6) or from
    # the host path (exact lane, flagged batches' re-execution included).
    resolved = sm.stat_device_semantic_events + sm.stat_host_semantic_events
    check(resolved == n_transfers, f"{name}: {resolved} events resolved != {n_transfers}")
    if expect_fallbacks:
        check(dev.stat_fallback_batches > 0, f"{name}: no batch was flagged")
        check(launches["commit_rebuild"] > 1, f"{name}: recovery did not rebuild the digest")
    else:
        check(sm.stat_fallback_events == 0, f"{name}: unexpected fallback")
    if extra is not None:
        extra(sm, replies)
    kernels.reset_launches()
    sm.verify_device_mirror()
    root = sm.state_root()
    if engine == "device":
        pair = dev.commit_probe()
        check(cm.root_bytes(pair[0]) == root and cm.root_bytes(pair[1]) == root,
              f"{name}: device digest != host root")
    else:
        check(cm.root_bytes(host_digest(sm)) == root,
              f"{name}: digest of the device table != host root")
    check_launches = dict(kernels.launches)
    split = engine_split(dev)
    scrub_line_s = scrub_line(sm)
    exact = (f"exact batches {sm.stat_exact_batches} ({sm.stat_exact_events} events); "
             f"linked batches {sm.stat_linked_batches} (sent to K5 {routed['linked']}; fixpoint "
             f"iterations {sm.stat_resolve_iters}); two-phase batches "
             f"{sm.stat_two_phase_batches} (sent to K6 {routed['two_phase']}); "
             f"fallback events {sm.stat_fallback_events}; {wave_counters(sm)}; "
             f"{native_counters(sm)}")
    if host_split is not None:
        exact += f"; host split {host_split.line(elapsed)}"
    tables = tables_of(sm)
    del sm, dev
    torch.cuda.empty_cache()

    ref, ref_replies, ref_elapsed, _, _ = run_stream(
        setup, timed, account_capacity, transfer_capacity, True, engine
    )
    check(ref_replies == replies, f"{name}: replies differ from the plain-version run")
    check(ref.state_root() == root, f"{name}: state root differs from the plain-version run")
    check(all((a == b).all() for a, b in zip(tables, tables_of(ref))),
          f"{name}: device tables differ from the plain-version run")
    del ref
    torch.cuda.empty_cache()

    busy = profiled_busy(name, setup, timed, account_capacity, transfer_capacity, engine,
                         replies, n_timed)
    print(
        f"phase {name} ({engine} engine): {n_timed} timed events in {elapsed:.3f} s = "
        f"{n_timed / elapsed:.0f} events/s "
        f"(plain-version run {n_timed / ref_elapsed:.0f} events/s); {exact}; "
        f"main-path launches {launches}; check launches {check_launches}; "
        f"device busy {busy}; engine split {split}; {scrub_line_s}; root {root.hex()}; "
        f"checks passed"
    )
    return launches, check_launches


def profiled_busy(name, setup, timed, account_capacity, transfer_capacity, engine, replies,
                  n_timed) -> str:
    """The phase's profiled run: its device busy time and share, and how
    many of the run's K4 launches its trace holds (a trace short of them
    undercounts the busy time)."""
    prof_sm, prof_replies, prof_elapsed, prof_launches, trace = run_stream(
        setup, timed, account_capacity, transfer_capacity, False, engine, profile=True,
        named=("apply_deltas",))
    check(prof_replies == replies, f"{name}: replies differ in the profiled run")
    del prof_sm
    torch.cuda.empty_cache()
    held = trace[3]["apply_deltas"] if trace is not None else 0
    k4 = f"the trace holds {held} of its {prof_launches['apply_deltas']} K4 launches"
    if trace is None:
        return f"not measured (no device activity in the trace; {k4})"
    busy_ms, top = trace[:2]
    return (f"{busy_ms:.3f} ms of the profiled run's {prof_elapsed:.3f} s "
            f"(busy share {busy_ms / 1e3 / prof_elapsed:.6f}; "
            f"{n_timed / prof_elapsed:.0f} events/s under the profiler; {k4}); top {top}")


def wave_counters(sm) -> str:
    """The wave routing counters of a phase: host wave batches, window
    wave/speculative batches, declines and the speculative counters."""
    out = (f"wave batches {sm.stat_wave_batches} (steps {sm.stat_wave_steps}, events "
           f"{sm.stat_wave_events}, parallel {sm.stat_wave_parallel_events}); dev_wave batches "
           f"{sm.stat_dev_wave_batches} (declined {sm.stat_dev_wave_declined} "
           f"{sm.stat_dev_wave_decline_reasons}, steps {sm.stat_dev_wave_steps}, events "
           f"{sm.stat_dev_wave_events}, plan_s {sm.stat_dev_wave_plan_s:.3f})")
    if sm.engine == "device":
        st = sm._dev.spec_stats
        out += "; spec " + " ".join(
            f"{k}={v:.3f}" if k.endswith("_s") else f"{k}={v}" for k, v in st.items())
    return out


@contextlib.contextmanager
def knobs(**values):
    """Environment knobs for a control run, restored after it (None:
    the knob unset)."""
    saved = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def control_run(name, setup, timed, account_capacity, sm, replies, engine, **values):
    """The same stream under other routing knobs (the scan control):
    replies and state root must be equal.  Returns its events/s."""
    transfer_capacity = transfer_events(setup + timed) + 1024
    with knobs(**values):
        ctl, ctl_replies, elapsed, _, _ = run_stream(
            setup, timed, account_capacity, transfer_capacity, False, engine)
    check(ctl_replies == replies, f"{name}: replies differ from the {values} run")
    check(ctl.state_root() == sm.state_root(), f"{name}: root differs from the {values} run")
    rate = transfer_events(timed) / elapsed
    print(f"  {name} control {values}: {rate:.0f} events/s; exact batches "
          f"{ctl.stat_exact_batches}; {wave_counters(ctl)}; {native_counters(ctl)}; "
          f"replies and root equal")
    del ctl
    torch.cuda.empty_cache()
    return rate


def native_arm(name, setup, timed, account_capacity, sm, replies, engine, extra=None):
    """The same stream with the native library on (the default route),
    beside a phase whose main-path run is under TB_FASTPATH_DISABLE=1
    to keep its kernels on the host path: replies and root equal that
    run's, the device mirror's tripwire passes and the device digest
    (host engine: of the device table) equals the root.
    `extra(arm, launches)` adds checks.  Returns its events/s."""
    transfer_capacity = transfer_events(setup + timed) + 1024
    with knobs(TB_FASTPATH_DISABLE=None):
        arm, arm_replies, elapsed, launches, _ = run_stream(
            setup, timed, account_capacity, transfer_capacity, False, engine)
    check(arm._native is not None, f"{name}: the native-on arm has no native library")
    check(arm_replies == replies, f"{name}: replies differ from the native-on arm")
    root = sm.state_root()
    check(arm.state_root() == root, f"{name}: root differs from the native-on arm")
    if extra is not None:
        extra(arm, launches)
    arm.verify_device_mirror()
    if engine == "device":
        pair = arm._dev.commit_probe()
        check(cm.root_bytes(pair[0]) == root and cm.root_bytes(pair[1]) == root,
              f"{name}: the native-on arm's device digest != host root")
    else:
        check(cm.root_bytes(host_digest(arm)) == root,
              f"{name}: the native-on arm's device table digest != host root")
    rate = transfer_events(timed) / elapsed
    print(f"  {name} native-on arm: {rate:.0f} events/s; exact batches {arm.stat_exact_batches}; "
          f"fallback batches {getattr(arm._dev, 'stat_fallback_batches', 0)} (events "
          f"{arm.stat_fallback_events}); {native_counters(arm)}; launches "
          f"{ {k: v for k, v in launches.items() if v} }; replies, root, tripwire and digest "
          f"equal")
    del arm
    torch.cuda.empty_cache()
    return rate


def reply_codes(reply: bytes) -> set:
    return set(np.frombuffer(reply, "<u4")[1::2].tolist())


# ---------------------------------------------------------------------------
# Hot/cold tiering: bench's run_tiering_compare shape at the card's scale.

TIER_ACCOUNTS = 10 * (1 << 20)  # 10,485,760: 10x the hot set, as bench's 640 over 64
TIER_HOT = 1 << 20
TIER_HEAD = 786_432            # 75 % of the hot set (bench: 48 of 64)
TIER_TAIL = 0.008
TIER_WARM = 48                 # one sweep over the head
TIER_TIMED = 64


def tier_accounts():
    """create_accounts ops for the tiered phases, made as they are
    submitted (10.5M accounts are 1.3 GB of wire bytes)."""
    for at in range(0, TIER_ACCOUNTS, workload.BATCH):
        ids = range(at + 1, min(at + workload.BATCH, TIER_ACCOUNTS) + 1)
        yield Operation.create_accounts, workload.accounts_bytes(ids)


def head_sweep(n_batches: int, batch: int, head: int, tid0: int):
    """Warm-up: transfers between consecutive head accounts (2k+1 ->
    2k+2), one sweep, so the head is resident before the timed batches."""
    k = np.arange(n_batches * batch, dtype=np.uint64)
    dr = (np.uint64(2) * k) % np.uint64(head) + np.uint64(1)
    return workload.batched(
        {"ids": np.uint64(tid0) + k, "dr": dr, "cr": dr + np.uint64(1),
         "amount": np.ones(len(k), np.uint64)},
        batch,
    )


def tiering_arm(engine, hot, plain, warm, timed, profile=False, checkpoint=False):
    """One arm of a tiered phase: the accounts and the warm-up, then the
    tier counters reset (as bench's _run_tiering_arm does) and the timed
    batches submitted one at a time, synchronously, for a per-batch
    latency.  The launch counts are set to 0 before the machine is built
    and read after the timed batches' barrier (and, with `checkpoint`,
    the checkpoint tripwire verify_device_mirror, which a replica runs at
    every checkpoint).  Returns (machine, replies, stats, launches,
    device trace or None)."""
    cap, _ = workload._sizing(TIER_ACCOUNTS, 0)
    tcap = (len(warm) + len(timed)) * workload.BATCH + 1024
    with knobs(TB_HOT_CAPACITY=str(hot or 0)):  # 0: all-resident
        kernels.reset_launches()
        sm = TorchStateMachine(account_capacity=cap, transfer_capacity=tcap, plain=plain,
                               engine=engine)
    check((sm._dev.hot is None) == (hot is None), "tiering knob not taken")
    h = SingleNodeHarness(sm)
    t_setup = time.perf_counter()
    replies = [h.submit(op, body) for op, body in tier_accounts()]
    t_warm = time.perf_counter()
    replies += [h.submit(op, body) for op, body in warm]
    t_warm = time.perf_counter() - t_warm
    t_setup = time.perf_counter() - t_setup
    tier = sm._dev.hot
    if tier is not None:
        tier.hits = tier.misses = tier.evicts = 0
        tier.prefetch_stall_us = 0.0
    punts0 = sm.stat_tier_punts
    torch.cuda.synchronize()
    prof = device_profiler() if profile else contextlib.nullcontext()
    lat = []
    with prof:
        t0 = time.perf_counter()
        for op, body in timed:
            t1 = time.perf_counter()
            replies.append(h.submit(op, body))
            lat.append(time.perf_counter() - t1)
        if engine == "device":
            sm._dev.drain()
        sm._dev.flush()
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    if checkpoint:
        sm.verify_device_mirror()
    launches = dict(kernels.launches)
    lat_ms = 1e3 * np.asarray(lat)
    n_events = transfer_events(timed)
    st = dict(events_per_s=n_events / elapsed, step_p50_ms=float(np.percentile(lat_ms, 50)),
              step_p99_ms=float(np.percentile(lat_ms, 99)), setup_s=t_setup, warm_s=t_warm,
              punts=sm.stat_tier_punts - punts0)
    if tier is not None:
        total = tier.hits + tier.misses
        st.update(hit_rate=tier.hits / total if total else None, hits=tier.hits,
                  misses=tier.misses, evicts=tier.evicts,
                  stall_us_per_batch=tier.prefetch_stall_us / len(timed),
                  prefetches=tier.prefetches)
    return sm, replies, st, launches, (device_busy(prof) if profile else None)


def _arm_line(st) -> str:
    out = (f"{st['events_per_s']:.0f} events/s, step p50 {st['step_p50_ms']:.3f} ms "
           f"p99 {st['step_p99_ms']:.3f} ms (setup {st['setup_s']:.1f} s)")
    if "hit_rate" in st:
        out += (f", hit rate {st['hit_rate']:.6f} ({st['hits']} hits, {st['misses']} misses), "
                f"evicts {st['evicts']}, prefetch stall {st['stall_us_per_batch']:.1f} us/batch, "
                f"punts {st['punts']}")
    return out


def run_tiering_phase(name, engine, warm, timed, must):
    """A tiered phase: TB_HOT_CAPACITY=2^20 under 10,485,760 accounts on
    bench's Zipf-head stream.  The main-path run (kernels, counted), the
    plain-version run and the all-resident control (TB_HOT_CAPACITY
    unset) must give the same replies and root; each passes the
    checkpoint tripwire; the hit rate holds bench's 0.90 gate; a fourth
    run under torch.profiler gives the device busy share.  Returns
    (main-path launches, check launches)."""
    n_transfers = transfer_events(warm + timed)
    host = engine == "host"
    sm, replies, st, launches, _ = tiering_arm(engine, TIER_HOT, False, warm, timed,
                                               checkpoint=host)
    for kname in must:
        check(launches[kname] > 0, f"{name}: {kname} was not launched")
    check_link_quiet(name, sm, launches)
    check(launches["exact_scan"] == sm.stat_exact_batches,
          f"{name}: {launches['exact_scan']} K3 launches != {sm.stat_exact_batches} exact batches")
    resolved = sm.stat_device_semantic_events + sm.stat_host_semantic_events
    check(resolved == n_transfers, f"{name}: {resolved} events resolved != {n_transfers}")
    check(sm.stat_fallback_events == 0, f"{name}: unexpected fallback")
    check(st["hit_rate"] is not None and st["hit_rate"] >= 0.90,
          f"{name}: hit rate {st['hit_rate']} below 0.90")
    if not host:
        check(sm.stat_dev_wave_batches == 0, f"{name}: a wave record ran under tiering")
    else:
        check(sm._native is not None, f"{name}: the native library is off")
    kernels.reset_launches()
    if not host:
        sm.verify_device_mirror()
        pair = sm._dev.commit_probe()
        want = sm._dev.twin_expected_digest()
        check((pair[0] == want).all() and (pair[1] == want).all(),
              f"{name}: device digest != the host twin's hot partial")
    check_launches = dict(kernels.launches)
    root = sm.state_root()
    tables = tables_of(sm)
    counters = (f"exact batches {sm.stat_exact_batches}; wave declines "
                f"{sm.stat_dev_wave_decline_reasons}; {native_counters(sm)}")
    del sm
    torch.cuda.empty_cache()

    ref, ref_replies, ref_st, ref_launches, _ = tiering_arm(engine, TIER_HOT, True, warm, timed)
    check(ref_replies == replies, f"{name}: replies differ from the plain-version run")
    check(ref.state_root() == root, f"{name}: root differs from the plain-version run")
    check(all((a == b).all() for a, b in zip(tables, tables_of(ref))),
          f"{name}: device tables differ from the plain-version run")
    check(all(ref_launches[k] == 0 for k in ("tier_set_rows", "commit_admit", "checksum")),
          f"{name}: the plain-version run launched a kernel")
    ref.verify_device_mirror()
    del ref
    torch.cuda.empty_cache()

    ctl, ctl_replies, ctl_st, _, _ = tiering_arm(engine, None, False, warm, timed)
    check(ctl_replies == replies, f"{name}: replies differ from the all-resident run")
    check(ctl.state_root() == root, f"{name}: root differs from the all-resident run")
    ctl.verify_device_mirror()
    del ctl
    torch.cuda.empty_cache()
    native_ctl = ""
    if host:
        # The Python lanes under TB_FASTPATH_DISABLE=1 (tiered).
        with knobs(TB_FASTPATH_DISABLE="1"):
            py, py_replies, py_st, _, _ = tiering_arm(engine, TIER_HOT, False, warm, timed)
        check(py._native is None, f"{name}: TB_FASTPATH_DISABLE=1 left the library on")
        check(py_replies == replies, f"{name}: replies differ from the TB_FASTPATH_DISABLE=1 run")
        check(py.state_root() == root, f"{name}: root differs from the TB_FASTPATH_DISABLE=1 run")
        native_ctl = f"; TB_FASTPATH_DISABLE=1 control {_arm_line(py_st)} ({native_counters(py)})"
        del py
        torch.cuda.empty_cache()

    prof_sm, prof_replies, prof_st, _, trace = tiering_arm(engine, TIER_HOT, False, warm, timed,
                                                           profile=True)
    check(prof_replies == replies, f"{name}: replies differ in the profiled run")
    del prof_sm
    torch.cuda.empty_cache()
    busy = "not measured (no device activity in the trace)"
    if trace is not None:
        busy_ms, top = trace
        prof_s = transfer_events(timed) / prof_st["events_per_s"]
        busy = (f"{busy_ms:.3f} ms of the profiled timed run's {prof_s:.3f} s "
                f"(busy share {busy_ms / 1e3 / prof_s:.6f}); top {top}")
    print(
        f"phase {name} ({engine} engine, TB_HOT_CAPACITY={TIER_HOT}, {TIER_ACCOUNTS} accounts, "
        f"{len(timed)} timed batches after {len(warm)} warm-up batches): tiered "
        f"{_arm_line(st)}; plain-version run {_arm_line(ref_st)}; all-resident control "
        f"{_arm_line(ctl_st)}{native_ctl}; {counters}; main-path launches {launches}; check launches "
        f"{check_launches}; device busy {busy}; root {root.hex()}; checks passed"
    )
    return launches, check_launches


# ---------------------------------------------------------------------------
# The row-sharded engines: the state machine's tables split in SHARDS over
# a ("shard",) mesh of the one card (devices=[cuda:0] * SHARDS).

SHARDED_RUNS = 3       # timed runs of each sharded stream
PV_HISTORY = (7, 23)   # batches with a pending between history accounts
CARD = torch.device("cuda", 0)  # the card every shard lies on


def sharded_stream(name, setup, timed, capacity, engine, must, extra=None, disabled_exact=None):
    """One stream on the row-sharded engine: SHARDED_RUNS timed runs (the
    first is the main path's, its launch counts read after the drain, and
    after the checkpoint tripwire on the host engine), the checks, an
    unsharded control run (profiled) and a plain-version sharded run
    (replies, root, tables and the K11 table digest equal), and a
    profiled sharded run (busy share, K14 device time per window).
    `disabled_exact`, when given, is the number of batches that drain to
    the host path: a sharded run under TB_FASTPATH_DISABLE=1 then takes
    each through K3 on the joined table and write_back onto the shards
    (its launch counts set to 0 before it and read after it, and added
    to the main path's), with replies, root, tables and K11 digest equal
    the main-path run's.  Returns (main-path launches, check launches)."""
    devices = [CARD] * SHARDS
    tc = transfer_events(setup + timed) + 1024
    n_timed = transfer_events(timed)
    rates, main = [], None
    for _ in range(SHARDED_RUNS):
        sm, replies, elapsed, launches, _ = run_stream(
            setup, timed, capacity, tc, False, engine, devices=devices,
            checkpoint=engine == "host")
        rates.append(n_timed / elapsed)
        if main is None:
            main = (sm, replies, launches)
        else:
            check(replies == main[1], f"{name}: a timed run's replies differ from the first's")
            del sm
            torch.cuda.empty_cache()
    sm, replies, launches = main
    del main
    dev = sm._dev
    check(isinstance(dev.balances, sharded.ShardedTable) and len(dev.balances.shards) == SHARDS,
          f"{name}: the table is not split in {SHARDS} shards")
    for kname in must + ("shard_gather", "shard_scatter"):
        check(launches[kname] > 0, f"{name}: {kname} was not launched")
    check(launches["exact_scan"] == sm.stat_exact_batches,
          f"{name}: {launches['exact_scan']} K3 launches != {sm.stat_exact_batches}")
    check(launches["exact_init"] == launches["exact_finalize"]
          == sm.stat_wave_batches + sm.stat_dev_wave_batches,
          f"{name}: K3 init / finalize launches != wave executions")
    resolved = sm.stat_device_semantic_events + sm.stat_host_semantic_events
    check(resolved == transfer_events(setup + timed), f"{name}: {resolved} events resolved")
    check(sm.stat_fallback_events == 0, f"{name}: unexpected fallback")
    check_link_quiet(name, sm, launches)
    if engine == "device":
        check(launches["spec_conflicts"] == 0 and not any(dev.spec_stats.values()),
              f"{name}: a sharded engine speculated")
    if extra is not None:
        extra(sm, launches)
    kernels.reset_launches()
    sm.verify_device_mirror()
    root = sm.state_root()
    if engine == "device":
        pair = dev.commit_probe()
        check(cm.root_bytes(pair[0]) == root and cm.root_bytes(pair[1]) == root,
              f"{name}: device digest != host root")
        digest = dev.checksum()
    else:
        digest = dev.device_checksum()
    check((digest == sm._mirror.checksum8(dev.capacity)).all(),
          f"{name}: the shards' K11 digest != the mirror's")
    tables = tables_of(sm)
    check_launches = dict(kernels.launches)
    windows = dev.stat_windows if engine == "device" else dev.stat_flushes
    split = engine_split(dev)
    routed = semantic_routed(sm)
    counters = (f"K3 batches {sm.stat_exact_batches}; K5 batches {routed['linked']}; "
                f"K6 batches {routed['two_phase']}; {wave_counters(sm)}; "
                f"stat_wave_sharded {getattr(dev, 'stat_wave_sharded', 0)}; {native_counters(sm)}")
    del sm, dev
    torch.cuda.empty_cache()
    if disabled_exact is not None:
        with knobs(TB_FASTPATH_DISABLE="1"):
            arm, arm_replies, arm_s, arm_launches, _ = run_stream(
                setup, timed, capacity, tc, False, engine, devices=devices,
                checkpoint=engine == "host")
        check(arm._native is None and isinstance(arm._dev.balances, sharded.ShardedTable),
              f"{name}: the TB_FASTPATH_DISABLE=1 arm is not the sharded engine without the "
              f"library")
        check(arm_launches["exact_scan"] == arm.stat_exact_batches == disabled_exact,
              f"{name}: TB_FASTPATH_DISABLE=1 arm: {arm_launches['exact_scan']} K3 launches, "
              f"{arm.stat_exact_batches} exact batches, want {disabled_exact}")
        check(arm_replies == replies, f"{name}: replies differ from the TB_FASTPATH_DISABLE=1 arm")
        check(arm.state_root() == root, f"{name}: root differs from the TB_FASTPATH_DISABLE=1 arm")
        arm_digest = arm._dev.checksum() if engine == "device" else arm._dev.device_checksum()
        check((arm_digest == digest).all(),
              f"{name}: K11 digest differs from the TB_FASTPATH_DISABLE=1 arm's")
        check(all((a == b).all() for a, b in zip(tables, tables_of(arm))),
              f"{name}: tables differ from the TB_FASTPATH_DISABLE=1 arm's")
        counters += (f"; TB_FASTPATH_DISABLE=1 arm {n_timed / arm_s:.0f} events/s, K3 "
                     f"{arm_launches['exact_scan']} launches, {wave_counters(arm)}, launches "
                     f"{ {k: v for k, v in arm_launches.items() if v} }")
        launches = {k: launches[k] + arm_launches[k] for k in launches}
        del arm
        torch.cuda.empty_cache()

    ctl, ctl_replies, ctl_s, _, ctl_trace = run_stream(
        setup, timed, capacity, tc, False, engine, profile=True, devices=devices[:1],
        checkpoint=engine == "host")
    check(ctl._dev.sharding is None, f"{name}: the control run is sharded")
    check(ctl_replies == replies, f"{name}: replies differ from the unsharded engine's")
    check(ctl.state_root() == root, f"{name}: root differs from the unsharded engine's")
    check(all((a == b).all() for a, b in zip(tables, tables_of(ctl))),
          f"{name}: tables differ from the unsharded engine's")
    ctl_digest = ctl._dev.checksum() if engine == "device" else ctl._dev.device_checksum()
    check((ctl_digest == digest).all(), f"{name}: K11 digest differs from the unsharded one")
    ctl_split = engine_split(ctl._dev)
    del ctl
    torch.cuda.empty_cache()

    ref, ref_replies, ref_s, ref_launches, _ = run_stream(
        setup, timed, capacity, tc, True, engine, devices=devices)
    check(ref_launches["shard_gather"] == ref_launches["shard_scatter"] == 0,
          f"{name}: the plain-version run launched K14")
    check(ref_replies == replies, f"{name}: replies differ from the plain-version run")
    check(ref.state_root() == root, f"{name}: root differs from the plain-version run")
    check(all((a == b).all() for a, b in zip(tables, tables_of(ref))),
          f"{name}: tables differ from the plain-version run")
    del ref
    torch.cuda.empty_cache()

    prof_sm, prof_replies, prof_s, _, trace = run_stream(
        setup, timed, capacity, tc, False, engine, profile=True, devices=devices,
        named=("shard_gather", "shard_scatter"))
    check(prof_replies == replies, f"{name}: replies differ in the profiled run")
    del prof_sm
    torch.cuda.empty_cache()
    k14 = "not measured (no device activity in the trace)"
    if trace is not None:
        named = trace[2]
        k14 = (f"gather {named['shard_gather'] * 1e3 / max(windows, 1):.1f} us, scatter "
               f"{named['shard_scatter'] * 1e3 / max(windows, 1):.1f} us per "
               f"{'window' if engine == 'device' else 'flush'} ({windows}; device time, "
               f"profiled run)")
        trace = trace[:2]
    ordered = sorted(rates)
    print(f"phase {name} ({engine} engine, {capacity} rows in {SHARDS} shards of one card): "
          f"{n_timed} timed events; {SHARDED_RUNS} runs "
          f"{', '.join(f'{r:.0f}' for r in rates)} events/s (median "
          f"{ordered[len(ordered) // 2]:.0f}, min {ordered[0]:.0f}, max {ordered[-1]:.0f}); "
          f"device busy {_busy_line(trace, prof_s)}; K14 {k14}; engine split {split}; "
          f"unsharded control {n_timed / ctl_s:.0f} events/s under the profiler, device busy "
          f"{_busy_line(ctl_trace, ctl_s)}, engine split {ctl_split}; plain-version sharded run "
          f"{n_timed / ref_s:.0f} events/s; {counters}; main-path launches {launches}; "
          f"check launches {check_launches}; root {root.hex()}; replies, root, tables and "
          f"K11 digest equal the unsharded engine's and the plain run's; checks passed")
    return launches, check_launches


def engine_split(dev) -> str:
    """The device engine's host wall-clock split over the timed batches
    (upload, of which sharded the units' rows and the remap; launch
    enqueue; ring fetch; bookkeeping); the host engine's flush count."""
    if not hasattr(dev, "stat_t_h2d"):
        return f"flushes={dev.stat_flushes}"
    return " ".join(f"{t[7:]}={getattr(dev, t):.3f}s" for t in ENGINE_TIMERS)


def _sum_launches(parts):
    return {k: sum(p[k] for p in parts) for k in parts[0]}


def run_sharded_engine_phase():
    """Phase sharded_engine: the device engine over 4 shards of a 2^20-row
    table.  Two streams: gen_simple's 1,000,000 transfers (K1 windows on
    compact rows, K2 update on compact rows) and 32 full batches of
    (pending, post) pairs with balancing riders under TB_DEV_WAVES=1
    (wave records through the sharded executor; the PV_HISTORY batches
    name history accounts, so their plans need a scan segment and
    decline "shard_plan")."""
    setup, timed, sizing = workload.gen_simple(N_TRANSFERS, n_accounts=N_ACCOUNTS)
    check(sizing[0] == A_ROWS, "sharded_engine: table is not 2^20 rows")
    simple = sharded_stream("sharded_engine/simple", setup, timed, A_ROWS, "device",
                            must=("orderfree", "commit_update", "commit_rebuild"))
    setup, timed = shard_cases.pv_balancing_stream(2060, WAVE_BATCHES, workload.BATCH,
                                                   N_ACCOUNTS, PV_HISTORY)

    def routed(sm, launches):
        waved = WAVE_BATCHES - len(PV_HISTORY)
        check(sm.stat_dev_wave_decline_reasons == {"shard_plan": len(PV_HISTORY)},
              f"sharded_engine/pv: declines {sm.stat_dev_wave_decline_reasons}, want "
              f"shard_plan exactly at the {len(PV_HISTORY)} history batches")
        check(sm.stat_dev_wave_batches == sm._dev.stat_wave_sharded == waved,
              f"sharded_engine/pv: {sm._dev.stat_wave_sharded} sharded wave records of {waved}")

    # The declined batches drain to the host path: the native serial
    # exact engine by default; the TB_FASTPATH_DISABLE=1 arm takes them
    # through K3 on the joined sharded table.
    with knobs(TB_DEV_WAVES="1"):
        pv = sharded_stream("sharded_engine/pv", setup, timed, A_ROWS, "device",
                            must=("wave_step",), extra=routed, disabled_exact=len(PV_HISTORY))
    return _sum_launches([simple[0], pv[0]]), _sum_launches([simple[1], pv[1]])


def linked_exact_batch(n_accounts, tid0):
    """One create_transfers batch of 2,730 three-member linked chains
    between random accounts, each opened by a pending transfer (which
    keeps the batch off the host's linked and two-phase lanes): the host
    engine's exact path (read, a wave plan or K3 on the joined table,
    write_back)."""
    rng = np.random.default_rng(2061)
    B = workload.BATCH
    dr = rng.integers(1, n_accounts + 1, B).astype(np.uint64)
    cr = dr % np.uint64(n_accounts) + np.uint64(1)
    pos = np.arange(B) % 3
    flags = (np.where(pos < 2, int(TransferFlags.linked), 0)
             | np.where(pos == 0, int(TransferFlags.pending), 0)).astype(np.uint16)
    return (Operation.create_transfers, workload.transfers_bytes(
        np.arange(tid0, tid0 + B, dtype=np.uint64), dr, cr,
        rng.integers(1, 100, B).astype(np.uint64), flags=flags))


def run_sharded_host_phase():
    """Phase sharded_host: the host engine over 4 shards of a 2^20-row
    table, gen_simple's stream (K4 flushes on compact rows) and one
    linked batch (the exact path through read / write_back), ending with
    the checkpoint tripwire (K11 per shard)."""
    setup, timed, sizing = workload.gen_simple(N_TRANSFERS, n_accounts=N_ACCOUNTS)
    timed = timed + [linked_exact_batch(N_ACCOUNTS, workload.TID0 + N_TRANSFERS)]

    def exact_ran(sm, launches):
        check(sm.stat_exact_batches + sm.stat_wave_batches == 1,
              "sharded_host: the linked batch did not take the exact path")
        check(launches["checksum"] == SHARDS, f"sharded_host: {launches['checksum']} K11 "
                                              f"launches at the checkpoint, want {SHARDS}")

    # TB_FASTPATH_DISABLE=1: the native linked lane would take the linked
    # batch off the exact path on the joined table.
    with knobs(TB_FASTPATH_DISABLE="1"):
        return sharded_stream("sharded_host", setup, timed, sizing[0], "host",
                              must=("apply_deltas", "checksum"), extra=exact_ran)


GRAFT_MUST = ("exact_scan", "shard_accumulate", "shard_admit", "shard_apply", "shard_gather",
              "shard_scatter")


def run_graft_entry_phase():
    """Phase graft_entry: the graft entry's step (K3 on the reference's
    example) on the card, held to its plain run on the CPU; then
    dryrun_multichip(SHARDS) on SHARDS cards, or the first card SHARDS
    times (the sharded apply step, the linked batch through K3 on a
    row-sharded table, the sharded device engine and its wave dispatch,
    each against the CPU oracle).  Returns (main-path launches, check
    launches)."""
    from tigerbeetle_tpu_torch import graft_entry as ge

    kernels.reset_launches()
    t0 = time.perf_counter()
    fn, args = ge.entry()
    table, packed = fn(*args)
    torch.cuda.synchronize()
    entry_s = time.perf_counter() - t0
    devs = ge.mesh_devices(SHARDS)
    ge.dryrun_multichip(SHARDS)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(kernels.launches)
    for name in GRAFT_MUST:
        check(launches[name] > 0, f"graft_entry: {name} was not launched")
    codes = k3.unpack_outputs(to_u64(packed))["results"][:8]
    check(not codes.any(), f"graft_entry: entry codes {codes.tolist()}")
    kernels.reset_launches()
    cfn, cargs = ge.entry(device="cpu")
    c_table, c_packed = cfn(*cargs)
    check(torch.equal(table.cpu(), c_table) and torch.equal(packed.cpu(), c_packed),
          "graft_entry: entry's outputs differ from its plain run")
    check_launches = dict(kernels.launches)
    print(f"phase graft_entry: entry (K3, 8 of 32 events, (64, 8) table) {entry_s * 1e3:.1f} ms, "
          f"codes 0, table and outputs equal the plain run; dryrun_multichip({SHARDS}) on "
          f"{sorted({str(d) for d in devs})} x {SHARDS // len(set(devs))}: sharded apply, "
          f"linked batch on the row-sharded table, sharded device engine and wave dispatch "
          f"equal the CPU oracle; {elapsed:.1f} s; main-path launches "
          f"{ {k: v for k, v in launches.items() if v} }; checks passed")
    return launches, check_launches


PROBES = ("scan_kinds_probe", "scan_resident_probe", "scan_probe", "stage_sweep",
          "staged_prod_probe", "kernel_time_probe", "kernel_time_probe2")


def run_probes_phase(dev):
    """Phase probes: each ported probe's run at 2^20 rows and its own
    repetitions (its lines printed as it goes), the launch counts read
    as it returns; then its final check, the same launches replayed one
    batch per call (check launches).  Returns (main-path launches, check
    launches)."""
    from tigerbeetle_tpu_torch.experiments import common

    launches = dict.fromkeys(kernels.launches, 0)
    check_launches = dict.fromkeys(kernels.launches, 0)
    t0 = time.perf_counter()
    for name in PROBES:
        mod = importlib.import_module(f"tigerbeetle_tpu_torch.experiments.{name}")
        args = common.parser(mod.__doc__, mod.REPS).parse_args(["--rows", str(A_ROWS)])
        print(f"probe {name} (--rows {A_ROWS} --reps {args.reps}):", flush=True)
        kernels.reset_launches()
        tapes = mod.run(args, dev)
        torch.cuda.synchronize()
        for k, v in kernels.launches.items():
            launches[k] += v
        kernels.reset_launches()
        print(common.verify(tapes), flush=True)
        for k, v in kernels.launches.items():
            check_launches[k] += v
        del tapes
        torch.cuda.empty_cache()
    elapsed = time.perf_counter() - t0
    for name in ("scan_of", "staged"):
        check(launches[name] > 0, f"probes: {name} was not launched")
    others = {k: v for k, v in launches.items() if v and k not in ("scan_of", "staged")}
    check(not others, f"probes: launches outside the launchers {others}")
    print(f"phase probes ({len(PROBES)} probes, {A_ROWS} rows): {elapsed:.1f} s; main-path "
          f"launches scan_of {launches['scan_of']}, staged {launches['staged']}; every probe's "
          f"table and ring equal a batch-by-batch run; checks passed")
    return launches, check_launches

def batches_with(ops, flags) -> tuple[int, int]:
    """(create_transfers batches holding an event with any of `flags`,
    their events)."""
    n_batches = n_events = 0
    for item in ops:
        if item[0] != Operation.create_transfers:
            continue
        ev = np.frombuffer(item[1], TRANSFER_DTYPE)
        if (ev["flags"] & np.uint16(flags)).any():
            n_batches += 1
            n_events += len(ev)
    return n_batches, n_events


def run_native_host_phase(name, setup, timed, rows, routed):
    """A host-engine phase on the native library's lanes (the
    reference's default route): no batch reaches K3 or a wave plan, K4
    flushes the deltas; `routed(sm)` checks the lane counters; replies
    and root equal a TB_FASTPATH_DISABLE=1 run (the Python lanes and the
    exact path on the card) and a TB_WAVES=scan run (K3 for every
    batch)."""
    def extra(sm, replies):
        check(sm._native is not None, f"{name}: the native library is off")
        check(sm.stat_exact_batches == sm.stat_wave_batches == 0,
              f"{name}: a batch reached K3 or a wave plan")
        check(sm.stat_device_events + sm.stat_exact_events == transfer_events(setup + timed),
              f"{name}: an event took no lane")
        routed(sm)
        control_run(name, setup, timed, rows, sm, replies, "host", TB_FASTPATH_DISABLE="1")
        control_run(name, setup, timed, rows, sm, replies, "host", TB_WAVES="scan")

    return run_phase(name, setup, timed, rows, engine="host", must=("apply_deltas",),
                     extra=extra)


# ---------------------------------------------------------------------------
# The device engine's lifecycle, the queries and checkpoint snapshot /
# restore, on one stream held to the port's oracle.

# More than 2^19 accounts, so that restore, which sizes the table from
# the account count as the reference does, rebuilds a 2^20-row table.
SERVICE_ACCOUNTS = 600_000
SERVICE_BATCHES = 24
HISTORY_EVERY = 4096        # every 4096th account keeps history (146 of them)
# Batches per window in the lifecycle phase (the chaos tests' 4): with
# the default 96 the whole stream fits one window and no record would
# be in flight at the kill.
LIFECYCLE_WINDOW = 4
SERVICE_HOT = 1 << 16       # the snapshot phase's tiered arm: 65,536 hot rows


def service_stream(n_batches=SERVICE_BATCHES, n_accounts=SERVICE_ACCOUNTS):
    """Accounts 1..n_accounts (every HISTORY_EVERY-th with the history
    flag), then full batches in a cycle of six: three of random
    transfers between plain accounts (K1), one of pendings (K1), one
    posting 70 % and voiding the rest of them (K6), and one whose every
    16th event debits a history account (the host path, history rows)."""
    rng = np.random.default_rng(2027)
    B = workload.BATCH
    ids = np.arange(1, n_accounts + 1, dtype=np.uint64)
    aflags = np.where(ids % HISTORY_EVERY == 0, int(AccountFlags.history), 0).astype(np.uint16)
    setup = [(Operation.create_accounts,
              workload.accounts_bytes(ids[at:at + B], flags=aflags[at:at + B]))
             for at in range(0, n_accounts, B)]
    hist = ids[ids % HISTORY_EVERY == 0]
    plain = ids[ids % HISTORY_EVERY != 0]
    timed = []
    tid = workload.TID0
    pend = None
    for k in range(n_batches):
        new = np.arange(tid, tid + B, dtype=np.uint64)
        tid += B
        zero = np.zeros(B, np.uint64)
        if k % 6 == 4:
            flags = np.where(rng.random(B) < 0.7, int(TransferFlags.post_pending_transfer),
                             int(TransferFlags.void_pending_transfer)).astype(np.uint16)
            body = workload.transfers_bytes(new, zero, zero, zero, flags=flags, pending_id=pend)
        else:
            i = rng.integers(0, len(plain), B)
            dr = plain[i]
            cr = plain[(i + 1 + rng.integers(0, 1000, B)) % len(plain)]
            if k % 6 == 5:
                dr[::16] = rng.choice(hist, len(dr[::16]))
            flags = None
            if k % 6 == 3:
                flags = np.full(B, int(TransferFlags.pending), np.uint16)
                pend = new
            body = workload.transfers_bytes(new, dr, cr, rng.integers(1, 100, B), flags=flags)
        timed.append((Operation.create_transfers, body))
    return setup, timed


def service_machine(engine, link=None, hot=None, window=None):
    with knobs(TB_HOT_CAPACITY=str(hot) if hot else None):
        sm = TorchStateMachine(account_capacity=A_ROWS,
                               transfer_capacity=SERVICE_BATCHES * workload.BATCH + 1024,
                               engine=engine, device_link=link)
    check((sm._dev.hot is not None) == bool(hot), "service stream: tiering knob not taken")
    if window is not None:
        sm._dev.window = window
    return sm


def service_run(setup, timed, engine):
    """The whole stream on a fresh machine, pipelined; (machine,
    replies, harness)."""
    sm = service_machine(engine)
    h = SingleNodeHarness(sm)
    replies = [h.submit(op, body) for op, body in setup]
    futs = [h.submit_async(op, body) for op, body in timed]
    replies += [f.result() for f in futs]
    if engine == "device":
        sm._dev.drain()
    sm._dev.flush()
    torch.cuda.synchronize()
    return sm, replies, h


def oracle_run(ops):
    """The port's oracle (per-event Python, on the CPU) over `ops`."""
    sm = CpuStateMachine()
    h = SingleNodeHarness(sm)
    return sm, [h.submit(op, body) for op, body in ops], h


def run_lifecycle_phase(setup, timed, oracle_replies, oracle_root):
    """Phase lifecycle (device engine, 2^20-row table, the service
    stream, LIFECYCLE_WINDOW batches a window): a third of the stream
    healthy, then ChaosLink.kill() with a launched window in flight, a
    third served degraded (the next ring fetch fails, the engine demotes
    and replays the window on the host), heal(), and the last third,
    during which tick re-promotes.  Replies and root equal the oracle's
    (the queries phase runs the stream without chaos on the device
    engine); no launch on the card between kill and heal; one demotion, one re-promotion, no future left unresolved.
    Then the scrub arm: one wrong word written into the card's balance
    table, scrub names the row and heals it, the root unchanged."""
    root = oracle_root
    link = ChaosLink()
    kernels.reset_launches()
    sm = service_machine("device", link=link, window=LIFECYCLE_WINDOW)
    dev = sm._dev
    h = SingleNodeHarness(sm)
    replies = [h.submit(op, body) for op, body in setup]
    third = len(timed) // 3
    t0 = time.perf_counter()
    futs = [h.submit_async(op, body) for op, body in timed[:third]]
    inflight = len(dev._launched)
    check(inflight > 0, "lifecycle: no window in flight at the kill")
    at_kill = dict(kernels.launches)
    link.kill()
    futs += [h.submit_async(op, body) for op, body in timed[third:2 * third]]
    check(dev.state is EngineState.degraded and dev.stat_demotions == 1,
          f"lifecycle: state {dev.state}, {dev.stat_demotions} demotions after the kill")
    check(dict(kernels.launches) == at_kill, "lifecycle: a kernel launched while degraded")
    degraded_events = dev.stat_degraded_events
    link.heal()
    futs += [h.submit_async(op, body) for op, body in timed[2 * third:]]
    replies += [f.result() for f in futs]
    dev.drain()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    check(all(f.done() for f in futs), "lifecycle: a future was left unresolved")
    check(dev.state is EngineState.healthy and dev.stat_demotions == 1
          and dev.stat_repromotions == 1,
          f"lifecycle: state {dev.state}, {dev.stat_demotions} demotions, "
          f"{dev.stat_repromotions} re-promotions")
    check(replies == oracle_replies, "lifecycle: replies under chaos differ from the oracle")
    check(sm.state_root() == root, "lifecycle: root under chaos differs from the oracle")
    replay_s, rp = dev.last_demotion_replay_s, dev.last_repromotion
    main = dict(kernels.launches)
    check(main["commit_probe"] == dev.stat_scrub_cheap,
          f"lifecycle: {main['commit_probe']} K2 probe launches != {dev.stat_scrub_cheap} scrubs")

    # The scrub arm: a clean scrub's cost, then a seeded wrong word.
    kernels.reset_launches()
    t1 = time.perf_counter()
    check(dev.scrub(), "lifecycle: a scrub of clean tables healed")
    clean_ms = 1e3 * (time.perf_counter() - t1)
    row = int(np.frombuffer(timed[0][1], TRANSFER_DTYPE)["debit_account_id_lo"][0]) - 1
    dev.balances[row, 2] += 1
    check(list(dev._localize_divergence()) == [row], "lifecycle: the wrong row was not named")
    heals = dev.stat_scrub_heals
    t1 = time.perf_counter()
    check(not dev.scrub(), "lifecycle: the scrub missed the wrong row")
    heal_ms = 1e3 * (time.perf_counter() - t1)
    for k, v in kernels.launches.items():
        main[k] += v
    check(dev.stat_scrub_heals == heals + 1 == 1, "lifecycle: the scrub did not heal once")
    check(sm.state_root() == root, "lifecycle: the heal moved the root")
    sm.verify_device_mirror()
    pair = dev.commit_probe()
    check(cm.root_bytes(pair[0]) == root and cm.root_bytes(pair[1]) == root,
          "lifecycle: device digest != host root after the heal")
    print(f"phase lifecycle (device engine, 2^20-row table, {SERVICE_ACCOUNTS} accounts, "
          f"{len(timed)} batches of {workload.BATCH}, {LIFECYCLE_WINDOW} a window): "
          f"{transfer_events(timed)} events in {elapsed:.3f} s; killed after {third} batches "
          f"with {inflight} in flight; "
          f"degraded events {degraded_events}; demotion replay {1e3 * replay_s:.1f} ms; "
          f"re-promotion probe {1e3 * rp['probe_s']:.2f} ms, upload {1e3 * rp['upload_s']:.2f} ms, "
          f"K2 rebuild {1e3 * rp['rebuild_s']:.2f} ms, handshake fetch "
          f"{1e3 * rp['handshake_s']:.2f} ms; probe failures {dev.stat_probe_failures}; "
          f"card launches between kill and heal 0; {scrub_line(sm)}; scrub of clean tables "
          f"{clean_ms:.2f} ms, scrub that named row {row} and healed {heal_ms:.2f} ms; replies "
          f"and root equal the oracle; main-path launches "
          f"{ {k: v for k, v in main.items() if v} }; checks passed")
    return main, dict.fromkeys(main, 0)


def query_ops(hist, plain):
    """get_account_transfers and get_account_balances over history and
    plain accounts and a missing id: both directions, each alone,
    reversed, limits, a timestamp window."""
    FF = AccountFilterFlags
    ops = []
    for acct in [int(a) for a in hist[:3]] + [int(a) for a in plain[:3]] + [10 ** 9]:
        for flags in (FF.debits | FF.credits, FF.debits, FF.credits,
                      FF.debits | FF.credits | FF.reversed, FF.credits | FF.reversed):
            for limit in (8190, 5):
                row = np.zeros(1, ACCOUNT_FILTER_DTYPE)[0]
                row["account_id_lo"] = acct
                row["limit"] = limit
                row["flags"] = flags
                ops.append((Operation.get_account_transfers, row.tobytes()))
                ops.append((Operation.get_account_balances, row.tobytes()))
        row = np.zeros(1, ACCOUNT_FILTER_DTYPE)[0]
        row["account_id_lo"] = acct
        row["limit"] = 8190
        row["flags"] = FF.debits | FF.credits
        row["timestamp_min"] = 2 * SERVICE_ACCOUNTS
        row["timestamp_max"] = 2 * SERVICE_ACCOUNTS + 8 * workload.BATCH
        ops.append((Operation.get_account_transfers, row.tobytes()))
        ops.append((Operation.get_account_balances, row.tobytes()))
    return ops


def run_queries_phase(setup, timed, oracle, oracle_h):
    """Phase queries: after the service stream, the query batch on the
    device engine and the host engine (each its own run of the stream),
    every reply byte-equal to the oracle's."""
    ids = np.arange(1, SERVICE_ACCOUNTS + 1)
    qs = query_ops(ids[ids % HISTORY_EVERY == 0], ids[ids % HISTORY_EVERY != 0])
    want = [oracle_h.submit(op, body) for op, body in qs]
    check(sum(len(r) for r in want[1::2]) > 0, "queries: no history row in the oracle's replies")
    totals = {}
    main = collections.Counter()
    for engine in ("device", "host"):
        kernels.reset_launches()
        sm, replies, h = service_run(setup, timed, engine)
        t0 = time.perf_counter()
        got = [h.submit(op, body) for op, body in qs]
        q_ms = 1e3 * (time.perf_counter() - t0)
        main.update(kernels.launches)
        check(got == want, f"queries ({engine} engine): replies differ from the oracle")
        check(sm.state_root() == oracle.state_root(), f"queries ({engine}): root differs")
        check_link_quiet(f"queries/{engine}", sm, kernels.launches)
        totals[engine] = q_ms
        del sm
        torch.cuda.empty_cache()
    rows = sum(len(r) // 128 for r in want)
    print(f"phase queries ({len(qs)} queries after {len(timed)} batches, {SERVICE_ACCOUNTS} "
          f"accounts, 2^20-row table): {rows} rows of replies; device engine "
          f"{totals['device']:.1f} ms, host engine {totals['host']:.1f} ms for the batch; "
          f"byte-equal to the oracle on both engines; checks passed")
    return dict(main), dict.fromkeys(main, 0)


def run_snapshot_phase(setup, timed, oracle_replies, oracle_root):
    """Phase snapshot: half the service stream, snapshot, restore into a
    fresh machine on the card (its table sized from the account count,
    as the reference's restore does), the rest: replies and root equal
    the oracle's, on the device engine, the host engine and the device
    engine under TB_HOT_CAPACITY (an empty hot set after the restore,
    refilled by admissions)."""
    half = len(timed) // 2
    main = collections.Counter()
    parts = []
    for engine, hot in (("device", None), ("host", None), ("device", SERVICE_HOT)):
        name = engine + ("/tiered" if hot else "")
        kernels.reset_launches()
        first = service_machine(engine, hot=hot)
        h = SingleNodeHarness(first)
        replies = [h.submit(op, body) for op, body in setup]
        futs = [h.submit_async(op, body) for op, body in timed[:half]]
        replies += [f.result() for f in futs]
        t0 = time.perf_counter()
        blob = first.snapshot()  # the device engine's runs the tripwire (K2 probe)
        snap_s = time.perf_counter() - t0
        restored = service_machine(engine, hot=hot)
        # The restore builds a new engine, which reads TB_HOT_CAPACITY.
        with knobs(TB_HOT_CAPACITY=str(hot) if hot else None):
            t0 = time.perf_counter()
            restored.restore(blob)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
        rows = restored._dev.capacity
        check(rows == A_ROWS, f"snapshot/{name}: restored onto {rows} rows, not 2^20")
        check((restored._dev.hot is not None) == bool(hot),
              f"snapshot/{name}: the restored engine's tiering differs")
        # The restored machine's own blob (its tripwire: the second K2 probe).
        check(restored.snapshot() == blob, f"snapshot/{name}: a restored machine's blob differs")
        h2 = SingleNodeHarness(restored)
        h2.realtime = h.realtime
        futs = [h2.submit_async(op, body) for op, body in timed[half:]]
        replies += [f.result() for f in futs]
        if engine == "device":
            restored._dev.drain()
        restored._dev.flush()
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        main.update(launches)
        if engine == "device":
            for m in (first, restored):
                check(m._dev.stat_demotions == 0 and m._dev.stat_link_errors == 0,
                      f"snapshot/{name}: a demotion or link error")
            want = first._dev.stat_scrub_cheap + restored._dev.stat_scrub_cheap + 2
        else:
            want = 0
        check(launches["commit_probe"] == want,
              f"snapshot/{name}: {launches['commit_probe']} K2 probe launches != {want}")
        check(replies == oracle_replies, f"snapshot/{name}: replies differ from the oracle")
        check(restored.state_root() == oracle_root, f"snapshot/{name}: root differs from the oracle")
        restored.verify_device_mirror()
        del first
        hot_rows = "" if restored._dev.hot is None else f", {restored._dev.hot.hot_rows} hot"
        parts.append(f"{name}: snapshot {1e3 * snap_s:.1f} ms ({len(blob)} bytes), restore "
                     f"{1e3 * restore_s:.1f} ms onto {rows} rows{hot_rows}")
        del restored
        torch.cuda.empty_cache()
    print(f"phase snapshot (half of {len(timed)} batches, snapshot, restore, the rest; "
          f"{SERVICE_ACCOUNTS} accounts, 2^20-row table): {'; '.join(parts)}; replies and root "
          f"equal the oracle's; checks passed")
    return dict(main), dict.fromkeys(main, 0)


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
    t0 = time.perf_counter()
    fastpath.load()  # the host engine's native library (g++, csrc/host/)
    info = fastpath.build_info
    print(f"native library {info['path']} (digest {info['digest']}): compiled in "
          f"{info['seconds']:.1f} s (0.0: found built), loaded in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(2026)

    report: dict[str, dict] = {}
    check_orderfree(rng, dev, report)
    check_commitment(rng, dev, report)
    l2_ns = l2_hit_ns(dev)
    print(f"one dependent L2 hit: {l2_ns:.1f} ns (2^20-step chase over 4 MiB)")
    check_exact(dev, report, l2_ns)
    check_apply(dev, report)
    check_semantic(dev, report, "linked", LINKED_CHECKS, semantic_cases.linked_case, l2_ns)
    check_semantic(dev, report, "two_phase", TWO_PHASE_CHECKS, semantic_cases.two_phase_case)
    check_waves(dev, report, l2_ns)
    check_tier_kernels(dev, report)
    check_shard_kernels(dev, report)
    check_launchers(dev, report)

    phases = {}
    # K7's lanes per wave on the main path: every K7 launch records its
    # width; the first launches of a phase are its main-path run's.
    wave_lanes = []
    launch_k7 = kernels.wave_step

    def recording(table, events, idx, *args, **kw):
        wave_lanes.append(idx.shape[0])
        return launch_k7(table, events, idx, *args, **kw)

    kernels.wave_step = recording
    setup, timed, sizing = workload.gen_simple(N_TRANSFERS, n_accounts=N_ACCOUNTS)
    check(sizing[0] == A_ROWS, "simple phase: table is not 2^20 rows")
    phases["simple"] = run_phase("simple", setup, timed, sizing[0], must=("orderfree",))
    setup, timed, sizing = workload.gen_zipf(N_TRANSFERS)
    phases["zipf"] = run_phase("zipf", setup, timed, sizing[0], must=("orderfree",))

    setup, timed = failure_stream(24, workload.BATCH)

    def overflow_ranked(sm, replies):
        check(reply_codes(replies[-1]) & {47, 48, 49, 50, 51, 52},
              "failures: the overflow batch's re-execution ranked no overflow code")

        # The default route: every flagged window's exact recovery
        # re-executes in the native lanes, the mirror changed in place
        # while enqueue is suppressed, then the re-upload.
        def same_recovery(arm, launches):
            check(arm._dev.stat_fallback_batches == sm._dev.stat_fallback_batches
                  and arm.stat_fallback_events == sm.stat_fallback_events,
                  f"failures: the native-on arm flagged {arm._dev.stat_fallback_batches} "
                  f"batches ({arm.stat_fallback_events} events), the main path "
                  f"{sm._dev.stat_fallback_batches} ({sm.stat_fallback_events})")
            check(arm.stat_exact_batches == launches["exact_scan"] == 0,
                  "failures: the native-on arm's recovery reached K3")

        native_arm("failures", setup, timed, A_ROWS, sm, replies, "device", same_recovery)

    # TB_FASTPATH_DISABLE=1 here and below where a phase's kernels run on
    # the host path: the native lanes would take that work to C++.
    with knobs(TB_FASTPATH_DISABLE="1"):
        phases["failures"] = run_phase(
            "failures", setup, timed, A_ROWS, must=("orderfree", "exact_scan"),
            expect_fallbacks=True, extra=overflow_ranked,
        )
    setup, timed, sizing = workload.gen_linked(N_EXACT)
    phases["linked"] = run_phase("linked", setup, timed, sizing[0], must=("linked",))
    setup, timed, sizing = workload.gen_two_phase(N_EXACT, n_accounts=N_ACCOUNTS)
    phases["two_phase"] = run_phase("two_phase", setup, timed, sizing[0], must=("two_phase",))
    # Bench's gen_offkernel at 1,000,001 accounts (odd, as bench's 1,001,
    # which cannot hold a full batch of disjoint chains): a 2^20-row table.
    setup, timed, sizing = workload.gen_offkernel(WAVE_BATCHES * workload.BATCH,
                                                  n_accounts=OFFKERNEL_ACCOUNTS)
    check(sizing[0] <= A_ROWS, "offkernel phase: accounts exceed the 2^20-row table")

    def offkernel_routed(sm, replies):
        check(sm.stat_dev_wave_declined == 0, "offkernel: the wave router declined a batch")
        check(sm.stat_dev_wave_batches == WAVE_BATCHES,
              f"offkernel: {sm.stat_dev_wave_batches} of {WAVE_BATCHES} batches dispatched")
        # Drained to the host path, which plans waves there; and the
        # whole scan K3 for every batch (TB_WAVES=scan too).
        control_run("offkernel", setup, timed, A_ROWS, sm, replies, "device",
                    TB_DEV_WAVES="0", TB_FASTPATH_DISABLE="1")
        # The same drain with the native library on: the serial exact
        # engine takes every batch (balancing riders keep them off the
        # resolvers).
        control_run("offkernel", setup, timed, A_ROWS, sm, replies, "device",
                    TB_DEV_WAVES="0")
        control_run("offkernel", setup, timed, A_ROWS, sm, replies, "device",
                    TB_DEV_WAVES="0", TB_WAVES="scan", TB_FASTPATH_DISABLE="1")

    wave_lanes.clear()
    phases["offkernel"] = run_phase(
        "offkernel", setup, timed, A_ROWS,
        must=("wave_step", "chain_wave", "spec_conflicts"), extra=offkernel_routed)
    main_lanes = {"offkernel": wave_lanes[:phases["offkernel"][0]["wave_step"]]}
    check(phases["offkernel"][0]["linked"] == phases["offkernel"][0]["two_phase"] == 0,
          "offkernel: a batch outside K5's and K6's classes launched one of them")

    def all_released(sm, replies):
        bal = to_u64(sm._dev.read())
        check(not bal[:, [0, 1, 4, 5]].any(), "expiry: a pending balance is not 0")
        n_exp = int((sm._store.col("status") == 4).sum())
        check(n_exp == 8 * workload.BATCH, f"expiry: {n_exp} pendings expired")

    setup, timed = expiry_stream(8, workload.BATCH, N_ACCOUNTS)
    phases["expiry"] = run_phase("expiry", setup, timed, A_ROWS,
                                 must=("orderfree", "apply_deltas"), extra=all_released)
    setup, timed, sizing = workload.gen_simple(N_TRANSFERS, n_accounts=N_ACCOUNTS)
    n_simple = sum(1 for op, _ in setup + timed if op == Operation.create_transfers)

    def simple_native(sm, replies):
        check(sm._native is not None, "simple_host: the native library is off")
        check(sm.stat_hot_tail_batches == n_simple,
              f"simple_host: {sm.stat_hot_tail_batches} hot-tail batches of {n_simple}")
        control_run("simple_host", setup, timed, sizing[0], sm, replies, "host",
                    TB_FASTPATH_DISABLE="1")

    phases["simple_host"] = run_phase("simple_host", setup, timed, sizing[0], engine="host",
                                      must=("apply_deltas",), extra=simple_native)
    setup, timed, sizing = workload.gen_waves_host(WAVE_BATCHES * workload.BATCH,
                                                   n_accounts=N_ACCOUNTS)
    check(sizing[0] == A_ROWS, "waves_host phase: table is not 2^20 rows")
    n_exact = sum(1 for op, _ in setup + timed if op == Operation.create_transfers)

    def every_batch_waved(sm, replies):
        check(sm.stat_exact_batches == 0 and sm.stat_wave_batches == n_exact,
              f"waves_host: {sm.stat_wave_batches} wave batches of {n_exact} exact-path batches")
        control_run("waves_host", setup, timed, sizing[0], sm, replies, "host", TB_WAVES="scan")

    wave_lanes.clear()
    # TB_WAVES=exact: the Python linked lane would take these batches
    # under auto; exact keeps the plans' admission and profitability
    # gates (tests/test_torch_waves_host.py runs the stream so too).
    with knobs(TB_FASTPATH_DISABLE="1", TB_WAVES="exact"):
        phases["waves_host"] = run_phase("waves_host", setup, timed, sizing[0], engine="host",
                                         must=("wave_step", "exact_segment"),
                                         extra=every_batch_waved)
    main_lanes["waves_host"] = wave_lanes[:phases["waves_host"][0]["wave_step"]]
    kernels.wave_step = launch_k7
    k7_lanes(dev, report, main_lanes)
    # The host engine's native lanes at full size.
    setup, timed, sizing = workload.gen_linked(N_EXACT)
    n_linked, _ = batches_with(setup + timed, TransferFlags.linked)
    n_batches = sum(1 for op, _ in setup + timed if op == Operation.create_transfers)

    def linked_routed(sm):
        # Every batch took the order-free or the linked lane (each ends in
        # one of the two native tails), every chain batch the linked one.
        tails = sm.stat_hot_tail_batches + sm.stat_slow_tail_batches
        check(tails == n_batches and sm.stat_linked_batches >= n_linked
              and sm.stat_exact_events == 0,
              f"linked_host: {sm.stat_linked_batches} linked-lane batches ({n_linked} chain "
              f"batches), {tails} native tails of {n_batches}, {sm.stat_exact_events} exact events")

    phases["linked_host"] = run_native_host_phase("linked_host", setup, timed, sizing[0],
                                                  linked_routed)
    setup, timed, sizing = workload.gen_two_phase(N_EXACT, n_accounts=N_ACCOUNTS)
    n_pv, _ = batches_with(setup + timed, TransferFlags.post_pending_transfer
                           | TransferFlags.void_pending_transfer)

    def two_phase_routed(sm):
        check(sm.stat_two_phase_batches == n_pv and sm.stat_exact_events == 0,
              f"two_phase_host: {sm.stat_two_phase_batches} two-phase-lane batches of {n_pv}, "
              f"{sm.stat_exact_events} exact events")

    phases["two_phase_host"] = run_native_host_phase("two_phase_host", setup, timed, sizing[0],
                                                     two_phase_routed)
    # Balancing riders keep every offkernel batch off the resolvers: the
    # serial exact engine takes them.
    setup, timed, _ = workload.gen_offkernel(WAVE_BATCHES * workload.BATCH,
                                             n_accounts=OFFKERNEL_ACCOUNTS)
    n_bal, _ = batches_with(timed, TransferFlags.balancing_debit | TransferFlags.balancing_credit)

    def exact_routed(sm):
        check(n_bal > 0 and sm.stat_exact_events == transfer_events(timed),
              f"exact_host: {sm.stat_exact_events} exact events, want every timed one "
              f"({n_bal} timed batches hold balancing riders)")

    phases["exact_host"] = run_native_host_phase("exact_host", setup, timed, A_ROWS,
                                                 exact_routed)
    # Hot/cold tiering: one stream for both engines.
    warm = head_sweep(TIER_WARM, workload.BATCH, TIER_HEAD, workload.WARM0)
    timed = workload.gen_tiering(TIER_TIMED, workload.BATCH, TIER_ACCOUNTS, TIER_HEAD,
                                 TIER_TAIL, workload.TID0)
    # K2 admit's slots per launch on the tiered phase's main path (the
    # census): every launch records its k; the phase's first launches are
    # its main-path run's.
    admit_k = []
    launch_k2a = kernels.commit_admit

    def recording_admit(row_hash, digest, slots, *args):
        admit_k.append(slots.shape[0])
        return launch_k2a(row_hash, digest, slots, *args)

    kernels.commit_admit = recording_admit
    phases["tiered"] = run_tiering_phase(
        "tiered", "device", warm, timed, must=("orderfree", "tier_set_rows", "commit_admit"))
    kernels.commit_admit = launch_k2a
    census = admit_k[:phases["tiered"][0]["commit_admit"]]
    report["commit_admit"]["census"] = {
        "launches": len(census), "k_by_launch": census,
        "k_counts": {str(k): n for k, n in sorted(collections.Counter(census).items())}}
    print(f"K2 admit census (tiered phase, main-path run): {len(census)} launches, slots per "
          f"launch {report['commit_admit']['census']['k_counts']}")
    phases["tiered_host"] = run_tiering_phase(
        "tiered_host", "host", warm, timed, must=("apply_deltas", "tier_set_rows", "checksum"))
    phases["sharded_apply"] = run_sharded_apply_phase(dev)
    phases["sharded_waves"] = run_sharded_waves_phase(dev)
    phases["sharded_engine"] = run_sharded_engine_phase()
    phases["sharded_host"] = run_sharded_host_phase()
    phases["graft_entry"] = run_graft_entry_phase()
    phases["probes"] = run_probes_phase(dev)
    setup, timed = service_stream()
    t0 = time.perf_counter()
    oracle, oracle_replies, oracle_h = oracle_run(setup + timed)
    print(f"service stream: {len(setup)} account batches, {len(timed)} transfer batches; the "
          f"oracle's run {time.perf_counter() - t0:.1f} s")
    phases["lifecycle"] = run_lifecycle_phase(setup, timed, oracle_replies, oracle.state_root())
    phases["queries"] = run_queries_phase(setup, timed, oracle, oracle_h)
    phases["snapshot"] = run_snapshot_phase(setup, timed, oracle_replies, oracle.state_root())
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
        "exact_scan": ("tigerbeetle_tpu_torch/csrc/exact_scan.cu",
                       "tigerbeetle_tpu/state_machine/kernel.py:738"),
        "apply_deltas": ("tigerbeetle_tpu_torch/csrc/apply_deltas.cu",
                         "tigerbeetle_tpu/state_machine/device_kernels.py:1003"),
        "linked": ("tigerbeetle_tpu_torch/csrc/linked.cu",
                   "tigerbeetle_tpu/state_machine/device_kernels.py:473"),
        "two_phase": ("tigerbeetle_tpu_torch/csrc/two_phase.cu",
                      "tigerbeetle_tpu/state_machine/device_kernels.py:770"),
        "exact_init": ("tigerbeetle_tpu_torch/csrc/exact_scan.cu",
                       "tigerbeetle_tpu/state_machine/waves.py:1633"),
        "exact_segment": ("tigerbeetle_tpu_torch/csrc/exact_scan.cu",
                          "tigerbeetle_tpu/state_machine/kernel.py:748"),
        "exact_finalize": ("tigerbeetle_tpu_torch/csrc/exact_scan.cu",
                           "tigerbeetle_tpu/state_machine/waves.py:1642"),
        "wave_step": ("tigerbeetle_tpu_torch/csrc/wave_step.cu",
                      "tigerbeetle_tpu/state_machine/waves.py:1010"),
        "chain_wave": ("tigerbeetle_tpu_torch/csrc/chain_wave.cu",
                       "tigerbeetle_tpu/state_machine/waves.py:1354"),
        "spec_conflicts": ("tigerbeetle_tpu_torch/csrc/spec_conflicts.cu",
                           "tigerbeetle_tpu/state_machine/waves.py:1971"),
        "tier_set_rows": ("tigerbeetle_tpu_torch/csrc/tier.cu",
                          "tigerbeetle_tpu/state_machine/device_engine.py:364"),
        "commit_admit": ("tigerbeetle_tpu_torch/csrc/commitment.cu",
                         "tigerbeetle_tpu/state_machine/commitment.py:358"),
        "checksum": ("tigerbeetle_tpu_torch/csrc/checksum.cu",
                     "tigerbeetle_tpu/state_machine/device_kernels.py:1036"),
        "shard_accumulate": ("tigerbeetle_tpu_torch/csrc/shard_apply.cu",
                             "tigerbeetle_tpu/parallel/sharded.py:135"),
        "shard_admit": ("tigerbeetle_tpu_torch/csrc/shard_apply.cu",
                        "tigerbeetle_tpu/parallel/sharded.py:185"),
        "shard_apply": ("tigerbeetle_tpu_torch/csrc/shard_apply.cu",
                        "tigerbeetle_tpu/parallel/sharded.py:203"),
        "shard_gather": ("tigerbeetle_tpu_torch/csrc/shard_rows.cu",
                         "tigerbeetle_tpu/parallel/sharded.py:107"),
        "shard_scatter": ("tigerbeetle_tpu_torch/csrc/shard_rows.cu",
                          "tigerbeetle_tpu/state_machine/waves.py:976"),
        # Host launchers of K1 / K5 / K6 (csrc/orderfree.cu, linked.cu,
        # two_phase.cu): no source of their own.
        "scan_of": ("tigerbeetle_tpu_torch/state_machine/device_kernels.py",
                    "tigerbeetle_tpu/state_machine/device_kernels.py:1066"),
        "staged": ("tigerbeetle_tpu_torch/state_machine/device_kernels.py",
                   "tigerbeetle_tpu/state_machine/device_kernels.py:1172"),
    }
    rows = []
    for name, (source, replaces) in meta.items():
        r = report[name]
        row = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "on_main_path": name in MAIN_PATH,
            "launches": sum(p[0][name] for p in phases.values()),
            "launches_by_phase": {ph: p[0][name] for ph, p in phases.items()},
            "check_launches": sum(p[1][name] for p in phases.values()),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "device_ms": r["device_ms"],
            "host_ms": r["host_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r.get("library_ms"), "verified": True,
        }
        for key in ("serial_floor_ms", "barrier_floor_ms", "barriers", "sweep",
                    "plain_on", "iters", "timed_case", "k128", "meta",
                    "library_device_ms", "library_host_ms", "widths", "window_unit", "row0",
                    "us_per_batch", "host_split", "library_full", "k80", "census",
                    "geometry", "empty_device_ms",
                    "by_kind", "cases", "phase_slice", "yardstick"):
            if key in r:
                row[key] = r[key]
        rows.append(row)
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

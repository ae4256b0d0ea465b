"""The redesigned kernels' floors and times on the card: K8's barrier,
K8 over its chain shapes, K3 over its segment lengths, where one K3
event's time goes; K5, K7, K1, K13 admit, K6, K3 finalize and init,
K14 gather, K4, K9 and K2 admit and update beside an earlier tree's.

    python -m tigerbeetle_tpu_torch.tools.serial_probes [--out FILE] [--parts k8,k3]
        [--parent DIR] [--k7-lanes K,...] [--phases NAME,...]

Needs a CUDA card.  Builds ``tools/serial_probes.cu`` (probes, not
kernels of the port) and drives the port's own wrappers:

* ``barrier``: one ``cluster.sync()`` in a cluster of 2, 8 and 16 blocks
  and one cooperative ``grid.sync()`` over one block per SM, each the
  CUDA-event time of 2000 barriers less that of none, over 2000; and
  how many 16-block clusters the card holds at once.
* ``k8``: ``waves.chain_wave`` on ``wave_cases.chain_case`` batches of
  40, 1000 and 4096 chains of 2..2 and 2..7 members (4096 x 7 does not
  fit a batch) over a 2^20-row table, device microseconds per call
  (torch.profiler, the ``chain_wave`` kernel only, the table's rows
  and the carry restored between calls).
* ``k3``: ``kernel.scan_segment`` over events [0, L) of a linked-class
  batch from a fresh carry, L = 1, 8, 59, 512, and the whole scan
  (``run_create_transfers``, 8190 events); a least-squares line through
  the segments gives K3's fixed cost and its cost per event.
* ``split`` (``main`` only): ``tb_walk_split``, K3's walk as it was
  before its redesign, and ``tb_walk_split_new``, the walk of
  ``exact_scan.cu``, each with ``clock64()`` stamps between its stages,
  on the first 59 and on all 8190 events of the same batch: cycles per
  event in each stage and in all (the stamps' own cycles included; the
  plain walk's time is the ``k3`` part), and the events of each class.

* ``k5``: K5 on two batches — ``chip_smoke.py``'s timed case
  (``linked_small`` on the "limits" scenario over 1,000 accounts spread
  over 2^20 rows) and the first timed batch of its ``linked`` phase
  (captured from the state machine's own launch): device microseconds
  and the fixpoint's iterations, and the cycles of each stage from
  ``clock64()`` stamps in a stamped launch (``stamps=``).
* ``k7``: K7 at K lanes of one ``wave_cases.wide_case`` wave, K in
  ``K7_LANES`` and any ``--k7-lanes``: device microseconds per wave at
  the kernel's own launch and at every shape of ``k7_shapes(K)``
  (clusters and cooperative grids, 8-256 lanes a block).

* ``k1``: K1 on its three timed cases (``k1_cases``: the tight batch of
  ``chip_smoke.py``'s shape, gen_zipf's skew, a compact 2^18-row table):
  device microseconds and kernels per call (the profiler, over every
  kernel the call launches), the bits against the plain version, the
  cycles of each stage from ``clock64()`` stamps in a stamped launch
  (each block's thread 0: block 0's, and the most and least over the
  blocks).
* ``k13``: K13 admit on chip_smoke.py's 8190-event slice and on the
  sharded_apply phase's 4095-event slice: device microseconds per call.
* ``k6``: K6 on three of chip_smoke.py's batches (``K6_CASES``: its
  timed case, ``two_phase_lo`` on "mixed", and the "races" and
  "durable" scenarios, 8192 events on 2^20 rows): device microseconds
  and kernels per call, the split over the kernels a call launches (the
  seven of the multi-launch design by their names), the bits against
  the plain version.
* ``fin``: K3 finalize at B = 8192 on ``finalize_case`` (chip_smoke.py's
  carry) with its hist_fix, with none and with every row fixed: device
  microseconds and kernels per call, the bits against the plain
  version.
* ``init``: K3 init on ``INIT_CASES`` (B = 8192, 8190, an odd B, and
  8192 on a carry one word off 16-byte alignment): device microseconds
  per call in turns with ``zero_()`` of the same words (a yardstick: the
  same bytes stored, not the same function), the bits against
  ``make_carry``, the word past the carry left as it was.
* ``k14``: K14 gather at W = 8, 2 and 1 on chip_smoke.py's two shapes
  (``k14_cases``: a wave batch's 16,380 slots, a window unit's rows):
  device microseconds per call in turns with index_select + where and,
  where the source chooses its store kind by size, with this tree's
  gather built (``variant_lib``) with streaming stores and with default
  ones at every size, and at the launch shapes of ``K14_SHAPES``; the
  bits against the plain version.
* ``k4``: K4 on ``k4_cases`` (chip_smoke.py's timed call, the same on
  a table one word off 16-byte alignment, a simple_host flush's first
  and last launches on a 2^20-row table and a sharded_host flush's on
  its compact table; ``testing/flush_cases.py``): device microseconds
  per call in turns with ``index_select`` of the same live cells (one
  dependent random trip over the same reads: a yardstick, not the same
  function), and cold (L2 flushed before each call, as the main path
  finds a 2^20-row table) beside the parent; the bits against the plain
  version.
* ``k9``: K9 on ``k9_cases`` (chip_smoke.py's timed "mixed" batch, a
  batch whose slots, groups and targets are all distinct, the offkernel
  phase's first speculative batch captured from the state machine's own
  launch): device microseconds per call, warm and cold, in turns with
  the parent; the conflicted lanes and the bits against the plain
  version.
* ``k2a``: K2 admit on ``k2a_cases`` (the tiered phase's census shapes,
  80 and 16,380 slots, chip_smoke.py's 16,384, the same one word off
  16-byte alignment, a ``pad_slots``-padded call with -1 lanes, a call
  that holds row H-1 with and without 1,000 slots past the table, on a
  2^20-row hash table): device microseconds per call, warm and cold, in
  turns with an empty kernel of the same launch shape and the parent;
  the bits against the plain version and the parent's.
* ``k2u``: K2 update at chip_smoke.py's window shape (792,201 touched
  rows of a 2^20-row table in 2^20 padded slots): device microseconds
  per call in turns with the parent; the bits against the plain version
  and the parent's, and of a call with slots past the table.
* ``turns`` (needs ``--parent``): chip_smoke.py's own K1, K2, K10, K11
  and K12-K14 checks from the parent's tree and from this one, in turns
  (parent, change, change, parent), one process each: what each tree's
  checks measure (µs/call, device µs, host µs, plain µs, bound).
* ``phases`` (needs ``--parent``): chip_smoke.py's streams (``--phases``,
  default every one of ``PHASES``) from either tree in the same turns:
  events/s, launches, windows or flushes, the profiled run's busy share
  and top items, the device ms of K6, K3 init and finalize, K14, K4 and
  K9, and the entries of every K4 launch of the main-path run.

``--parent DIR`` (a checkout of an earlier tree, say one unpacked with
``git archive`` under ``build/``) adds, in the same process and on the
same inputs, that tree's K1, K5, K7, K13 admit, K6, K3 finalize and
init, K14 gather, K4, K9 and K2 admit and update (built from its
``csrc``; its K5 also built with stamps patched in between its stages)
to ``k1``, ``k5``, ``k7``, ``k13``, ``k6``, ``fin``, ``init``, ``k14``,
``k4``, ``k9``, ``k2a`` and ``k2u``; for K1 and K6, the split of its
time over the kernels it launches.  ``k6``, ``fin``, ``init``, ``k14``,
``k4``, ``k9``, ``k2a`` and ``k2u`` take the two trees' device times
in turns (parent, change, change, parent), and all but ``k2u`` their
CUDA-event times per call alternating (``paired_event_us``).

``main`` prints one JSON object of the parts asked for (``--parts``;
``k8``, ``k3``, ``k5``, ``k7``, ``k13``, ``k6``, ``fin`` and ``init`` build nothing of their own
but the parent's, so they run on any tree with the wrappers, and
``k14`` builds its variants only from a source that has their
constants);
``chip_smoke.py`` prints the barrier, k8, k3, k5, k7, k1 and k13 parts.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import sys
from pathlib import Path

import numpy as np
import torch

from tigerbeetle_tpu_torch import kernels, workload
from tigerbeetle_tpu_torch.kernels import build
from tigerbeetle_tpu_torch.state_machine import device_kernels as dk
from tigerbeetle_tpu_torch.state_machine import kernel as k3
from tigerbeetle_tpu_torch.state_machine import waves
from tigerbeetle_tpu_torch.testing import orderfree_cases, scan_cases, semantic_cases, wave_cases

LIB = "serial_probes"
A_ROWS = 1 << 20
B = 8192
BARRIER_ITERS = 2000
K8_SHAPES = ((40, 2), (40, 7), (1000, 2), (1000, 7), (4096, 2))
K3_LENGTHS = (1, 8, 59, 512)
STAGES = ("event", "directory", "rows", "normal_verdict", "pv_lookup", "pv_verdict",
          "rows_again", "stores")
STAGES_NEW = ("head", "fetch_now", "fetch_ahead", "plan", "verdict", "record", "stores",
              "chain", "next")
CLASSES = ("normal", "durable_pv", "inbatch_pv", "rollback")

_P, _I, _I64, _U64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint64
_SIGNATURES = {
    "tb_cluster_sync_probe": [_I, _I, _I, _P, _P],
    "tb_grid_sync_probe": [_I, _I, _I, _P, _P],
    "tb_max_active_clusters": [_I, _I, _P],
    "tb_walk_split": [_P, _I64, _P, _I, _P, _I, _I, _U64, _P, _P, _P],
    "tb_walk_split_new": [_P, _I64, _P, _I, _P, _I, _I, _U64, _P, _P, _P],
    "tb_walk_split_stages": [],
    "tb_walk_split_new_stages": [],
    "tb_sm_clock_khz": [],
    "tb_error_string": [_I],
}


def _lib():
    lib = build.load(LIB, build.TOOLS)
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_char_p if name == "tb_error_string" else _I
    return lib


def _call(lib, name, *args):
    rc = getattr(lib, name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} ({lib.tb_error_string(rc).decode()})")


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _event_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def device_split(fn, reset=None, names=(), reps: int = 20) -> dict:
    """Per device function whose name holds one of `names`: its
    microseconds and launches per call of `fn` (the profiler's CUDA
    kernel time over `reps` calls, `reset()` before each, its copies
    not counted)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if reset is not None:
        reset()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if reset is not None:
                reset()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and any(k in e.key for k in names):
            us = getattr(e, "self_device_time_total", None) or getattr(
                e, "self_cuda_time_total", 0.0)
            out[e.key] = {"us": us / reps, "launches": e.count / reps,
                          "us_launch": us / max(e.count, 1)}
    return out


def device_us(fn, reset=None, names=(), reps: int = 20) -> float | None:
    """Device microseconds per call of `fn`: device_split's times summed
    (None when the profiler saw none)."""
    total = sum(v["us"] for v in device_split(fn, reset, names, reps).values())
    return total if total > 0 else None


def barrier_sweep(dev) -> dict:
    """Microseconds per barrier: cluster.sync() in clusters of 2, 8 and
    16 blocks of 256 threads, grid.sync() over one block of 256 threads
    per SM (cooperative launch); and the 16-block clusters the card
    holds at once."""
    lib = _lib()
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    cases = [("cluster", g) for g in (2, 8, 16)] + [("grid", sms)]
    for kind, blocks in cases:
        name = f"tb_{kind}_sync_probe"

        def run(iters, name=name, blocks=blocks):
            _call(lib, name, blocks, 256, iters, sink.data_ptr(), _stream())

        run(BARRIER_ITERS)
        torch.cuda.synchronize()
        full = float(np.median([_event_ms(lambda: run(BARRIER_ITERS)) for _ in range(5)]))
        empty = float(np.median([_event_ms(lambda: run(0)) for _ in range(5)]))
        out[f"{kind}_{blocks}_us"] = (full - empty) * 1e3 / BARRIER_ITERS
    count = ctypes.c_int(0)
    _call(lib, "tb_max_active_clusters", 16, 256, ctypes.addressof(count))
    out["max_active_clusters_16x256"] = count.value
    return out


def _pair(dev, table, ev, dstat):
    t = torch.from_numpy(table.view(np.int64).copy()).to(dev)
    pk = torch.from_numpy(k3.pack_events(ev).view(np.int64)).to(dev)
    ds = torch.from_numpy(dstat.view(np.int32)).to(dev)
    w = torch.empty(k3.scratch_words(pk.shape[0]), dtype=torch.int64, device=dev)
    k3.exact_init(w, ds)
    return t, pk, ds, w


def _rows(ev, n, dev):
    cols = [np.asarray(ev[c][:n], np.int64) for c in ("dr_slot", "cr_slot", "p_dr_slot",
                                                       "p_cr_slot")]
    s = np.concatenate(cols)
    return torch.from_numpy(np.unique(s[s >= 0])).to(dev)


def _resetter(t, w, rows):
    saved_rows, saved_w = t[rows].clone(), w.clone()
    return lambda: (t.index_copy_(0, rows, saved_rows), w.copy_(saved_w))


def _pool():
    rng = np.random.default_rng(2030)
    return np.sort(rng.choice(A_ROWS, 200_000, replace=False))


def k8_sweep(dev) -> list:
    """K8's device microseconds per chain wave at each (chains, longest
    chain) of K8_SHAPES; P is the plane's position count."""
    pool = _pool()
    out = []
    for n_chains, max_len in K8_SHAPES:
        table, ev, dstat, n, ts_base, plan = wave_cases.chain_case(
            2032 + max_len, n_chains, B, A=A_ROWS, rows=pool, max_len=max_len)
        P = plan.chain_steps[0]
        plane = torch.from_numpy(waves._chain_plane(ev["flags"], plan.segments[0][1], P,
                                                    B)).to(dev)
        t, pk, _ds, w = _pair(dev, table, ev, dstat)
        us = device_us(lambda: waves.chain_wave(t, pk, w, plane, n, ts_base),
                       reset=_resetter(t, w, _rows(ev, n, dev)), names=("chain_wave",))
        out.append(dict(chains=n_chains, max_len=max_len, P=P, events=n, device_us=us))
    return out


def _linked_case():
    pool = _pool()
    return wave_cases.plan_case(2034, B, "linked", A=A_ROWS, rows=pool[:B], n=8190)


def k3_sweep(dev) -> dict:
    """K3 segments over events [0, L) of a linked-class batch from a
    fresh carry, and the whole scan: device microseconds per call, and
    the least-squares fixed cost and cost per event of the segments."""
    table, ev, dstat, n, ts_base, _plan = _linked_case()
    t, pk, ds, w = _pair(dev, table, ev, dstat)
    reset = _resetter(t, w, _rows(ev, n, dev))
    seg = {}
    for L in K3_LENGTHS:
        rows = torch.arange(L, dtype=torch.int32, device=dev)
        seg[L] = device_us(lambda: k3.scan_segment(t, pk, w, rows, n, ts_base), reset=reset,
                           names=("segment_kernel",))
    Ls = np.array(K3_LENGTHS, float)
    us = np.array([seg[L] for L in K3_LENGTHS], float)
    per_event, fixed = np.polyfit(Ls, us, 1)
    scratch = k3.ExactScratch(B, dev)
    t2 = torch.from_numpy(table.view(np.int64).copy()).to(dev)
    saved = t2.clone()
    whole = device_us(lambda: k3.run_create_transfers(t2, pk, ds, n, ts_base, scratch=scratch),
                      reset=lambda: t2.copy_(saved), names=("exact_scan",), reps=5)
    return dict(segment_us={str(L): seg[L] for L in K3_LENGTHS}, fixed_us=float(fixed),
                per_event_us=float(per_event), scan_events=n, scan_us=whole,
                scan_per_event_us=None if whole is None else whole / n)


def walk_split(dev) -> dict:
    """Both stamped walks over the first 59 and all 8190 events of the
    linked-class batch: cycles per event per stage and in all."""
    lib = _lib()
    table, ev, dstat, n, ts_base, _plan = _linked_case()
    khz = lib.tb_sm_clock_khz()
    out = {"sm_clock_khz": khz}
    for name, stages, extra in (("old", STAGES, ()), ("new", STAGES_NEW, CLASSES)):
        symbol = "tb_walk_split" if name == "old" else "tb_walk_split_new"
        for L in (59, n):
            t, pk, _ds, w = _pair(dev, table, ev, dstat)
            rows = torch.arange(L, dtype=torch.int32, device=dev)
            res = torch.zeros(len(stages) + 1 + len(extra), dtype=torch.int64, device=dev)
            _call(lib, symbol, t.data_ptr(), t.shape[0], pk.data_ptr(), pk.shape[0],
                  rows.data_ptr(), L, n, ts_base & ((1 << 64) - 1), w.data_ptr(),
                  res.data_ptr(), _stream())
            cyc = res.cpu().numpy().astype(np.float64)
            whole = cyc[len(stages)]
            out[f"{name}_{L}"] = dict(
                cycles_per_event={s: cyc[k] / L for k, s in enumerate(stages)},
                stamped_cycles_per_event=whole / L,
                stamped_ns_per_event=whole / L / khz * 1e6,
                **{f"{c}_events": int(cyc[len(stages) + 1 + k]) for k, c in enumerate(extra)})
    return out


# ---- K5 and K7, the change against an earlier tree's kernels.

K5_STAGES = ("events", "sort", "merge", "entries", "fixpoint", "results", "admit")
# The stamp buffer after the stages' clocks: the merge's parts (clocks)
# and the fixpoint's parts (cycles summed over its iterations; "seg",
# the entries' segment starts and chain boundaries, in the first only).
K5_MERGE = ("totals", "copy", "rank")
K5_ITERATION = ("scan", "barrier_a", "totals_a", "seg", "chain", "barrier_chain", "lanes",
                "barrier_b", "totals_b", "verdict", "barrier_c", "update")
# The stages of the K5 before its redesign (one block of 1024 threads),
# each ending at the barrier before the comment the stamp goes in front
# of in that source.
K5_OLD_STAGES = (("step0", "  // 1. Chain bounds"), ("chain_bounds", "  // 2. Sort the entry keys"),
                 ("sort", "  const int V = n_valid;"), ("entries", "  // 4. The fixpoint"),
                 ("fixpoint", "  // 5. Result codes."), ("results", "  // 6b. Low-limb sums"),
                 ("admit_apply", "  // 7. The summary row."),
                 ("summary", "\n}\n\n}  // namespace"))
K7_LANES = (1, 32, 64, 256, 1024, 2048, 4096, 8190)


def k7_shapes(K):
    """The launch shapes K7 is also timed at for a K-lane wave: clusters
    of 2-16 blocks and cooperative grids of 2 blocks or more, each at
    8-256 lanes a block."""
    out = [(lanes, False) for lanes in (8, 16, 32, 64, 128, 256) if 1 < -(-K // lanes) <= 16]
    return out + [(lanes, True) for lanes in (32, 64, 128) if -(-K // lanes) > 1]


def _parent_csrc(parent) -> Path:
    return Path(parent).resolve() / "tigerbeetle_tpu_torch" / "csrc"


def _parent_lib(parent, name):
    """The earlier tree's library `name`, built from its own sources."""
    src = _parent_csrc(parent)
    build.build_all((name,), src)
    lib = ctypes.CDLL(str(build.library_path(name, src)))
    lib.tb_error_string.argtypes = [_I]
    lib.tb_error_string.restype = ctypes.c_char_p
    return lib


def _stamped_parent_k5(parent):
    """The earlier tree's K5 with clock64() stamps (thread 0, after each
    stage's block barrier) into a device array, read back by
    tb_linked_stamp_read: the source patched in front of each stage's
    closing comment, built beside it."""
    src = _parent_csrc(parent)
    text = (src / "linked.cu").read_text()
    text = text.replace('#include "tb_common.cuh"\n', '#include "tb_common.cuh"\n'
                        "__device__ unsigned long long tb_stamp_buf[16];\n"
                        "#define TB_STAMP(k) do { if (threadIdx.x == 0) "
                        "tb_stamp_buf[k] = clock64(); } while (0)\n", 1)
    text = re.sub(r"(  const int M = 2 \* B;\n)", r"\1  TB_STAMP(0);\n", text, count=1)
    for k, (_stage, anchor) in enumerate(K5_OLD_STAGES, start=1):
        if anchor.startswith("\n"):
            at = text.index(anchor)
            text = text[:at] + f"\n  TB_STAMP({k});" + text[at:]
        else:
            if text.count(anchor) != 1:
                raise ValueError(f"{src / 'linked.cu'}: no single stage anchor {anchor!r}")
            text = text.replace(anchor, f"  TB_STAMP({k});\n" + anchor)
    text += ('\nextern "C" int tb_linked_stamp_read(void* out) {\n'
             "  return (int)cudaMemcpyFromSymbol(out, tb_stamp_buf, sizeof(tb_stamp_buf));\n}\n")
    (src / "linked_stamped.cu").write_text(text)
    lib = _parent_lib(parent, "linked_stamped")
    lib.tb_linked_stamp_read.argtypes = [_P]
    lib.tb_linked_stamp_read.restype = _I
    return lib


def _old_linked(lib, table, meta, ring_row, pk, n, small, scratch, stream):
    fn = lib.tb_linked
    fn.argtypes = [_P, _P, _I64, _P, _P, _I, _I, _I, _P, _P, _P]
    rc = fn(table.data_ptr(), meta.data_ptr(), table.shape[0], ring_row, pk.data_ptr(), n,
            pk.shape[0], int(small), scratch[0].data_ptr(), scratch[1].data_ptr(), stream)
    if rc:
        raise RuntimeError(f"parent tb_linked: {lib.tb_error_string(rc).decode()}")


def linked_phase_batch(dev):
    """(table, meta, pk, n, small) of the K5 launch of the first timed
    batch of chip_smoke.py's linked phase (workload.gen_linked), as the
    device engine launched it: the engine's table as it stood then."""
    setup, timed, sizing = workload.gen_linked(4 * workload.BATCH)
    from tigerbeetle_tpu_torch.state_machine.gpu import TorchStateMachine
    from tigerbeetle_tpu_torch.testing.harness import SingleNodeHarness

    seen = []
    launch = kernels.linked

    def capture(table, meta, ring_row, pk, n, small, scratch, *a, **kw):
        seen.append((table.clone(), meta.clone(), pk.clone(), n, small))
        return launch(table, meta, ring_row, pk, n, small, scratch, *a, **kw)

    kernels.linked = capture
    try:
        sm = TorchStateMachine(account_capacity=sizing[0],
                               transfer_capacity=sizing[1],
                               engine="device", devices=[dev])
        h = SingleNodeHarness(sm)
        for op, body in setup:
            h.submit(op, body)
        sm._dev.drain()
        before = len(seen)
        h.submit(*timed[0][:2])
        sm._dev.drain()
        torch.cuda.synchronize()
    finally:
        kernels.linked = launch
    if len(seen) <= before:
        raise RuntimeError("the linked phase's first timed batch launched no K5")
    return seen[before]


def timed_case(dev):
    """chip_smoke.py's timed K5 case on the card: (table, meta, pk, n,
    small)."""
    rows = np.sort(np.random.default_rng(2029).choice(A_ROWS, B, replace=False))
    table, meta, pk, n = semantic_cases.linked_case(900, B, "limits", A=A_ROWS, rows=rows,
                                                    pool=1000)
    to = lambda a, dt: torch.from_numpy(a.view(dt).copy()).to(dev)  # noqa: E731
    return to(table, np.int64), to(meta, np.int32), to(pk, np.int64), n, True


def k5_sweep(dev, parent=None) -> dict:
    """K5 on the timed case and on a linked-phase batch: device
    microseconds per launch (the table's touched rows restored between
    calls), iterations, and cycles per stage of a stamped launch; with
    `parent`, the same for that tree's K5."""
    khz = _lib().tb_sm_clock_khz()
    old = stamped = None
    if parent is not None:
        old = _parent_lib(parent, "linked")
        stamped = _stamped_parent_k5(parent)
    out = {"sm_clock_khz": khz}
    for name, (table, meta, pk, n, small) in (("timed", timed_case(dev)),
                                              ("linked_phase", linked_phase_batch(dev))):
        ring = torch.zeros((4, dk.SUMMARY_WORDS), dtype=torch.int64, device=dev)
        saved = table.clone()
        reset = lambda t=table, s=saved: t.copy_(s)  # noqa: E731
        scratch = dk.WordScratch("linked", table.shape[0], pk.shape[0], dev)
        row = {"events": n, "B": pk.shape[0], "small": small,
               "geometry": kernels.linked_geometry(pk.shape[0])}
        run = lambda: kernels.linked(table, meta, ring[1].data_ptr(), pk, n, small,  # noqa: E731
                                     scratch, count_as=None)
        row["device_us"] = device_us(run, reset=reset, names=("linked_kernel",))
        row["iters"] = int(dk.unpack_summary(ring[1].cpu().numpy().view(np.uint64))["iters"])
        st = torch.zeros(kernels.linked_stamps(), dtype=torch.int64, device=dev)
        reset()
        kernels.linked(table, meta, ring[1].data_ptr(), pk, n, small, scratch, count_as=None,
                       stamps=st)
        c = st.cpu().numpy().astype(np.float64)
        ns = len(K5_STAGES) + 1
        row["stage_cycles"] = {s: c[k + 1] - c[k] for k, s in enumerate(K5_STAGES)}
        merge = [c[2]] + list(c[ns:ns + len(K5_MERGE)]) + [c[3]]
        row["merge_cycles"] = {s: merge[k + 1] - merge[k]
                               for k, s in enumerate(K5_MERGE + ("barrier",))}
        it = c[ns + len(K5_MERGE):]
        row["iteration_cycles"] = {s: it[k] / max(row["iters"], 1)
                                   for k, s in enumerate(K5_ITERATION)}
        row["stamped_us"] = (c[ns - 1] - c[0]) / khz * 1e3
        if old is not None:
            olds = (torch.full((table.shape[0],), -1, dtype=torch.int32, device=dev),
                    torch.zeros(old_words(old, pk.shape[0]), dtype=torch.int64, device=dev))
            orun = lambda lib=old: _old_linked(lib, table, meta, ring[2].data_ptr(),  # noqa: E731
                                               pk, n, small, olds, _stream())
            row["parent_device_us"] = device_us(orun, reset=reset, names=("linked_kernel",))
            reset()
            orun()
            torch.cuda.synchronize()
            row["parent_ring_equal"] = bool(torch.equal(ring[1], ring[2]))
            reset()
            orun(stamped)
            buf = (ctypes.c_uint64 * 16)()
            torch.cuda.synchronize()
            stamped.tb_linked_stamp_read(ctypes.addressof(buf))
            oc = np.array(buf[:len(K5_OLD_STAGES) + 1], np.float64)
            row["parent_stage_cycles"] = {s: oc[k + 1] - oc[k]
                                          for k, (s, _a) in enumerate(K5_OLD_STAGES)}
            row["parent_stamped_us"] = (oc[-1] - oc[0]) / khz * 1e3
        reset()
        out[name] = row
    return out


def old_words(lib, B) -> int:
    fn = lib.tb_linked_scratch_words
    fn.argtypes = [_I]
    fn.restype = _I64
    return int(fn(B))


def _old_wave(lib, t, pk, idx, n, ts_base, w, lanes):
    fn = lib.tb_wave_step
    fn.argtypes = [_P, _I64, _P, _I, _P, _I, _P, _I, _U64, _P, _P, _P]
    rc = fn(t.data_ptr(), t.shape[0], pk.data_ptr(), pk.shape[0], idx.data_ptr(),
            idx.shape[0], None, n, ts_base, w.data_ptr(), lanes.data_ptr(), _stream())
    if rc:
        raise RuntimeError(f"parent tb_wave_step: {lib.tb_error_string(rc).decode()}")


def k7_sweep(dev, lanes=K7_LANES, parent=None) -> list:
    """K7's device microseconds per wave at each K of `lanes` (the
    kernel's own launch and each shape of k7_shapes(K));
    with `parent`, that tree's two-launch K7 on the same inputs."""
    old = _parent_lib(parent, "wave_step") if parent is not None else None
    pool = _pool()
    out = []
    for K in lanes:
        table, ev, dstat, n, ts_base, plan = wave_cases.wide_case(31, B, A_ROWS, rows=pool, n=K)
        t, pk, _ds, w = _pair(dev, table, ev, dstat)
        idx = torch.from_numpy(np.asarray(plan.segments[0][1], np.int32)).to(dev)
        reset = _resetter(t, w, _rows(ev, n, dev))
        ts = ts_base & ((1 << 64) - 1)
        row = {"K": K, "geometry": kernels.wave_step_geometry(K)}
        row["device_us"] = device_us(
            lambda: kernels.wave_step(t, pk, idx, None, n, ts, w), reset=reset,
            names=("wave_",))
        for shape in k7_shapes(K):
            row[f"{'grid' if shape[1] else 'cluster'}_{shape[0]}_us"] = device_us(
                lambda shape=shape: kernels.wave_step(t, pk, idx, None, n, ts, w, shape=shape),
                reset=reset, names=("wave_",))
        if old is not None:
            buf = torch.empty(K * 48, dtype=torch.int64, device=dev)
            row["parent_device_us"] = device_us(
                lambda: _old_wave(old, t, pk, idx, n, ts, w, buf), reset=reset,
                names=("wave_",))
        reset()
        out.append(row)
    return out


# ---- K1 and K13 admit, the change against an earlier tree's kernels.

K1_STAGES = ("ladder", "combine", "probe", "claim", "sync_claim", "totals", "admit",
             "sync_admit", "apply")
# The five launches of K1's multi-launch design, and its one cooperative
# launch.
K1_PARENT = ("of_ladder", "of_accum", "of_admit", "apply_rows_kernel", "summary_kernel",
             "orderfree_kernel")
K1_EVENTS = workload.BATCH


def k1_cases():
    """K1's timed cases as numpy (name, table, meta, pk, n), all in the
    tight format at B = 8192: "tight" (chip_smoke.py's shape: uniform
    debit rows of 1,000,000 accounts on 2^20 rows, credit = debit + 1,
    100 failures), "skewed" (gen_zipf's 100 accounts on 2^20 rows) and
    "compact" (a compact table of one 2^18-row shard)."""
    rng = np.random.default_rng(2060)
    table, meta = orderfree_cases.tables(rng, A_ROWS)
    pk, meta = orderfree_cases.tight(rng, B, K1_EVENTS, 1_000_000, meta)
    yield "tight", table, meta, pk, K1_EVENTS
    yield ("skewed",) + orderfree_cases.skewed(2061, B, K1_EVENTS, A_ROWS)
    yield ("compact",) + orderfree_cases.compact(2062, B, K1_EVENTS)


def _cooperative(lib) -> bool:
    """Whether an earlier tree's K1 is the one cooperative launch (its
    library reports a geometry), not the multi-launch design."""
    return hasattr(lib, "tb_orderfree_geometry")


def _old_orderfree(lib, t, m, ring_row, pk, mode, n, ts, olds):
    fn = lib.tb_orderfree
    if _cooperative(lib):
        fn.argtypes = [_P, _P, _I64, _P, _P, _I, _I, _I, _U64, _P, _I, _P, _P]
        rc = fn(t.data_ptr(), m.data_ptr(), t.shape[0], ring_row, pk.data_ptr(), mode, n,
                pk.shape[0], ts, olds[0].data_ptr(), pk.shape[0], None, _stream())
    else:
        fn.argtypes = [_P, _P, _I64, _P, _P, _I, _I, _I, _U64, _P, _P, _P, _P, _P, _P, _P]
        rc = fn(t.data_ptr(), m.data_ptr(), t.shape[0], ring_row, pk.data_ptr(), mode, n,
                pk.shape[0], ts, *(x.data_ptr() for x in olds), _stream())
    if rc:
        raise RuntimeError(f"parent tb_orderfree: {lib.tb_error_string(rc).decode()}")


def _old_orderfree_scratch(lib, A, B, dev):
    """The parent's K1 scratch: for the cooperative K1 its zeroed word
    buffer; for the multi-launch one the per-slot index (resting at -1),
    codes, touched list, limb accumulators, candidate rows, two
    counters."""
    i32, i64 = torch.int32, torch.int64
    if _cooperative(lib):
        fn = lib.tb_orderfree_scratch_words
        fn.argtypes = [_I]
        fn.restype = _I64
        return (torch.zeros(int(fn(B)), dtype=i64, device=dev),)
    return (torch.full((A,), -1, dtype=i32, device=dev), torch.empty(B, dtype=i32, device=dev),
            torch.empty(2 * B, dtype=i32, device=dev),
            torch.empty((2 * B, 16), dtype=i64, device=dev),
            torch.empty((2 * B, 8), dtype=i64, device=dev), torch.zeros(2, dtype=i32, device=dev))


def k1_sweep(dev, parent=None) -> dict:
    """K1 on each of k1_cases: device microseconds and kernel launches
    per call (the profiler, over every kernel the call launches; the
    table restored between calls), the bits against the plain version,
    and the cycles per stage of a stamped launch; with `parent`, that
    tree's K1 on the same inputs: its time, its split into its five
    launches, and its bits against the change's."""
    khz = _lib().tb_sm_clock_khz()
    old = _parent_lib(parent, "orderfree") if parent is not None else None
    out = {"sm_clock_khz": khz, "geometry": kernels.orderfree_geometry(B)}
    blocks = out["geometry"][0]
    mode, ts = dk.MODE_TIGHT, 1 << 40
    for name, table, meta, pk, n in k1_cases():
        t = torch.from_numpy(table.view(np.int64)).to(dev)
        m = torch.from_numpy(meta.view(np.int32)).to(dev)
        p = torch.from_numpy(pk.view(np.int32)).to(dev)
        saved = t.clone()
        reset = lambda t=t, s=saved: t.copy_(s)  # noqa: E731
        ring = torch.zeros((4, dk.SUMMARY_WORDS), dtype=torch.int64, device=dev)
        scratch = dk.OrderfreeScratch(B, dev)
        run = lambda: kernels.orderfree(t, m, ring[1].data_ptr(), p, mode, n, ts,  # noqa: E731
                                        scratch, count_as=None)
        split = device_split(run, reset, names=("orderfree_kernel",))
        row = {"events": n, "rows": t.shape[0], "device_us": sum(v["us"] for v in split.values()),
               "kernels_per_call": sum(v["launches"] for v in split.values())}
        reset()
        run()
        t_new = t.clone()
        t_p, r_p = saved.clone(), torch.zeros_like(ring)
        dk.orderfree_plain(t_p, m, r_p, 1, p, n, ts, mode=mode)
        row["plain_equal"] = bool(torch.equal(t_new, t_p) and torch.equal(ring[1], r_p[1]))
        st = torch.zeros(kernels.orderfree_stamps(), dtype=torch.int64, device=dev)
        reset()
        kernels.orderfree(t, m, ring[1].data_ptr(), p, mode, n, ts, scratch, count_as=None,
                          stamps=st)
        c = st.cpu().numpy().astype(np.float64).reshape(-1, len(K1_STAGES) + 1)[:blocks]
        d = np.diff(c, axis=1)  # (blocks, stages): each block's thread 0
        row["stage_cycles"] = {s: d[0, k] for k, s in enumerate(K1_STAGES)}
        row["stage_cycles_max"] = {s: d[:, k].max() for k, s in enumerate(K1_STAGES)}
        row["stage_cycles_min"] = {s: d[:, k].min() for k, s in enumerate(K1_STAGES)}
        row["stage_cycles_p50"] = {s: float(np.median(d[:, k])) for k, s in enumerate(K1_STAGES)}
        row["stage_cycles_p90"] = {s: float(np.percentile(d[:, k], 90))
                                   for k, s in enumerate(K1_STAGES)}
        row["stamped_us"] = (c[0, -1] - c[0, 0]) / khz * 1e3
        if old is not None:
            olds = _old_orderfree_scratch(old, t.shape[0], B, dev)
            orun = lambda: _old_orderfree(old, t, m, ring[2].data_ptr(), p, mode, n, ts,  # noqa: E731
                                          olds)
            psplit = device_split(orun, reset, names=K1_PARENT)
            row["parent_device_us"] = sum(v["us"] for v in psplit.values())
            row["parent_kernels_per_call"] = sum(v["launches"] for v in psplit.values())
            row["parent_split_us"] = {next((k for k in K1_PARENT if k in key), key): v["us"]
                                      for key, v in psplit.items()}
            turns = _split_in_turns(run, orun, reset, K1_PARENT)
            row["device_us_turns"] = [_sum_us([s]) for s in turns["change"]]
            row["parent_device_us_turns"] = [_sum_us([s]) for s in turns["parent"]]
            if _cooperative(old):
                # The parent on the change's own scratch (the same layout):
                # the hash table's address held equal.
                same = lambda: _old_orderfree(old, t, m, ring[2].data_ptr(), p, mode,  # noqa: E731
                                              n, ts, (scratch.words,))
                turns = _split_in_turns(run, same, reset, K1_PARENT)
                row["same_scratch_device_us_turns"] = [_sum_us([s]) for s in turns["change"]]
                row["same_scratch_parent_device_us_turns"] = [_sum_us([s])
                                                              for s in turns["parent"]]
            reset()
            orun()
            torch.cuda.synchronize()
            row["parent_equal"] = bool(torch.equal(t, t_new) and torch.equal(ring[2], ring[1]))
        reset()
        out[name] = row
    return out


def k13_cases(dev):
    """K13 admit's timed cases on the card, (name, local table, acc,
    row0, dr, cr): chip_smoke.py's (an 8190-event slice onto shard 1 of
    a 2^20-row table split in 4, 64 rows within 2^40 of 2^128) and the
    sharded_apply phase's slice (4095 events, the dp half of a batch,
    onto shard 1 of 2; the same seeded rows)."""
    from tigerbeetle_tpu_torch.parallel import sharded
    from tigerbeetle_tpu_torch.testing import shard_cases

    balances, *events = shard_cases.apply_events(2040, A_ROWS, workload.BATCH, near_ceiling=64)
    for name, shards, dp in (("slice_8190", 4, 1), ("phase_slice", 2, 2)):
        mesh = sharded.make_mesh([dev] * (shards * dp), dp=dp)
        ev = [x[0] for x in sharded.shard_events(mesh, *events)]
        local = A_ROWS // shards
        table = sharded.shard_balances(sharded.make_row_mesh([dev] * shards), balances)[1]
        acc = sharded.accumulate(local, local, *ev)
        yield name, table, acc, local, ev[0], ev[1]


def k13_sweep(dev, parent=None) -> dict:
    """K13 admit on each of k13_cases: device microseconds per call,
    the events and the rejects; with `parent`, that tree's K13 admit on
    the same inputs, and whether its reject bytes equal the change's."""
    old = _parent_lib(parent, "shard_apply") if parent is not None else None
    out = {}
    for name, table, acc, row0, dr, cr in k13_cases(dev):
        E = dr.shape[0]
        rej = torch.empty(E, dtype=torch.uint8, device=dev)
        run = lambda: kernels.shard_admit(table, acc, row0, dr, cr, rej)  # noqa: E731
        row = {"events": E, "local_rows": table.shape[0],
               "device_us": device_us(run, names=("shard_admit",))}
        run()
        torch.cuda.synchronize()
        row["rejected"] = int(rej.sum())
        if old is not None:
            fn = old.tb_shard_admit
            fn.argtypes = [_P, _P, _I64, _I64, _P, _P, _I64, _P, _P]
            orej = torch.empty_like(rej)
            orun = lambda: fn(table.data_ptr(), acc.data_ptr(), table.shape[0],  # noqa: E731
                              row0, dr.data_ptr(), cr.data_ptr(), E, orej.data_ptr(), _stream())
            row["parent_device_us"] = device_us(orun, names=("shard_admit",))
            orun()
            torch.cuda.synchronize()
            row["parent_equal"] = bool(torch.equal(orej, rej))
        out[name] = row
    return out


# One tree's chip_smoke.py K1, K2, tiering and shard-kernel checks, run
# from its root; the report's entries of TURN_KERNELS on one line.
TURN_KERNELS = ("orderfree", "commit_rebuild", "commit_update", "commit_probe", "tier_set_rows",
                "commit_admit", "checksum", "shard_accumulate", "shard_admit", "shard_apply",
                "shard_gather", "shard_scatter")
_TURN = """
import json, sys
import numpy as np, torch
sys.path.insert(0, ".")
import chip_smoke as c
from tigerbeetle_tpu_torch.kernels import build
build.build_all()
rep = {}
dev = torch.device("cuda", 0)
c.check_orderfree(np.random.default_rng(2026), dev, rep)
c.check_commitment(np.random.default_rng(2026), dev, rep)
c.check_tier_kernels(dev, rep)
c.check_shard_kernels(dev, rep)
print("TURN " + json.dumps({k: rep[k] for k in %r}, default=float))
""" % (TURN_KERNELS,)


def turns(dev, parent=None) -> dict:
    """chip_smoke.py's own K1, K2, K10, K11 and K12-K14 checks from
    `parent`'s tree and from this one, in turns (parent, change, change,
    parent), each in a process of its own: every TURN_KERNELS entry's
    µs/call, device µs and host µs as that tree's chip_smoke.py measures
    them."""
    return _in_turns(_TURN, parent, 600)


# ---- K6 and K3 finalize, the change against an earlier tree's kernels.

# The device functions of K6 in either design: the seven launches of the
# multi-launch design (tp_static, tp_ladder, tp_winner, tp_accum,
# tp_admit, apply_rows_kernel, summary_kernel) and the one cooperative
# launch.
K6_NAMES = ("tp_", "apply_rows_kernel", "summary_kernel", "two_phase_kernel")
K6_SPLIT = ("tp_static", "tp_ladder", "tp_winner", "tp_accum", "tp_admit", "apply_rows_kernel",
            "summary_kernel", "two_phase_kernel")
FIN_NAMES = ("finalize_kernel",)
# chip_smoke.py's TWO_PHASE_CHECKS cases timed here: (scenario, kind,
# seed); the first is chip_smoke.py's timed case.
K6_CASES = (("mixed", "two_phase_lo", 900), ("races", "two_phase", 904),
            ("durable", "two_phase_lo", 903))
TURN_REPS = 50  # CUDA-event calls of each tree in paired_event_us


def paired_event_us(fns, reset) -> list:
    """Median CUDA-event microseconds per call of each of `fns`, taken in
    turns (fns[0], fns[1], ..., then again; TURN_REPS calls each),
    `reset()` before every call, outside the timed events."""
    for f in fns:
        reset()
        f()
    times = [[] for _ in fns]
    for _ in range(TURN_REPS):
        for k, f in enumerate(fns):
            reset()
            times[k].append(_event_ms(f) * 1e3)
    return [float(np.median(t)) for t in times]


def _split_in_turns(run, orun, reset, names):
    """device_split of the change (`run`) and the parent (`orun`) in
    turns: parent, change, change, parent."""
    out = {"change": [], "parent": []}
    for who in ("parent", "change", "change", "parent"):
        out[who].append(device_split(run if who == "change" else orun, reset, names))
    return out


def _sum_us(splits) -> float:
    """Device microseconds of a call that launches each kernel once: the
    kernels' times per launch summed (the profiler may miss a launch of
    the window), averaged over the splits."""
    return float(np.mean([sum(v["us_launch"] for v in s.values()) for s in splits]))


def _named(splits, names) -> dict:
    """Each kernel's microseconds per launch, averaged over the splits."""
    keys = {k for s in splits for k in s}
    return {next((n for n in names if n in k), k):
            float(np.mean([s[k]["us_launch"] for s in splits if k in s])) for k in keys}


def k6_case(dev, scenario, kind, seed):
    """chip_smoke.check_semantic's K6 batch `scenario` on the card:
    (table, meta, pk, n, lo_only, the rows it names)."""
    rows = np.sort(np.random.default_rng(2029).choice(A_ROWS, B, replace=False))
    table, meta, pk, n = semantic_cases.two_phase_case(seed, dk.B, scenario, A=A_ROWS, rows=rows)
    w = pk[:n, [dk.COL_SLOTS, dk.COL_TP_SLOTS]].reshape(-1)
    s = np.concatenate([(w & np.uint64(0xFFFFFFFF)).astype(np.int64),
                        (w >> np.uint64(32)).astype(np.int64)]) - 1
    to = lambda a, dt: torch.from_numpy(a.view(dt).copy()).to(dev)  # noqa: E731
    return (to(table, np.int64), to(meta, np.int32), to(pk, np.int64), n,
            kind == "two_phase_lo", torch.from_numpy(np.unique(s[s >= 0])).to(dev))


def _old_two_phase(lib, table, meta, ring_row, pk, n, lo_only, olds):
    """The multi-launch K6: seven launches over a per-slot index and a word
    scratch."""
    fn = lib.tb_two_phase
    fn.argtypes = [_P, _P, _I64, _P, _P, _I, _I, _I, _P, _P, _P]
    rc = fn(table.data_ptr(), meta.data_ptr(), table.shape[0], ring_row, pk.data_ptr(), n,
            pk.shape[0], int(lo_only), olds[0].data_ptr(), olds[1].data_ptr(), _stream())
    if rc:
        raise RuntimeError(f"parent tb_two_phase: {lib.tb_error_string(rc).decode()}")


def _old_two_phase_scratch(lib, A, Bn, dev):
    fn = lib.tb_two_phase_scratch_words
    fn.argtypes = [_I]
    fn.restype = _I64
    return (torch.full((A,), -1, dtype=torch.int32, device=dev),
            torch.zeros(int(fn(Bn)), dtype=torch.int64, device=dev))


def k6_sweep(dev, parent=None) -> dict:
    """K6 on K6_CASES: device microseconds and kernels per call (the
    profiler; the batch's rows restored between calls), the split over
    the kernels a call launches, and the bits against the plain version;
    with `parent`, that tree's K6 on the same inputs, in turns with the
    change (device time: parent, change, change, parent; CUDA-event time
    per call alternating), and its bits against the change's."""
    old = _parent_lib(parent, "two_phase") if parent is not None else None
    out = {}
    for scenario, kind, seed in K6_CASES:
        t, m, p, n, lo, rows = k6_case(dev, scenario, kind, seed)
        saved = t[rows].clone()
        t0 = t.clone()
        reset = lambda t=t, rows=rows, s=saved: t.index_copy_(0, rows, s)  # noqa: E731
        ring = torch.zeros((4, dk.SUMMARY_WORDS), dtype=torch.int64, device=dev)
        scratch = dk.new_scratch("two_phase", t.shape[0], dev)
        run = lambda: dk.two_phase(t, m, ring, 1, p, n, 1 << 40, lo_only=lo,  # noqa: E731
                                   scratch=scratch, count_as=None)
        row = {"case": f"{kind}[{scenario}]", "events": n, "rows": int(rows.numel())}
        reset()
        run()
        t_new = t.clone()
        t_p, r_p = t0.clone(), torch.zeros_like(ring)
        dk.two_phase_plain(t_p, m, r_p, 1, p, n, 1 << 40, lo_only=lo)
        row["plain_equal"] = bool(torch.equal(t_new, t_p) and torch.equal(ring[1], r_p[1]))
        if old is None:
            split = [device_split(run, reset, K6_NAMES)]
        else:
            olds = _old_two_phase_scratch(old, t.shape[0], dk.B, dev)
            orun = lambda: _old_two_phase(old, t, m, ring[2].data_ptr(), p, n, lo,  # noqa: E731
                                          olds)
            turns = _split_in_turns(run, orun, reset, K6_NAMES)
            split = turns["change"]
            row["parent_device_us"] = _sum_us(turns["parent"])
            row["parent_device_us_turns"] = [_sum_us([s]) for s in turns["parent"]]
            row["device_us_turns"] = [_sum_us([s]) for s in turns["change"]]
            row["parent_kernels_per_call"] = sum(v["launches"] for v in turns["parent"][0].values())
            row["parent_split_us"] = _named(turns["parent"], K6_SPLIT)
            bind = lambda: kernels.two_phase(t, m, ring[1].data_ptr(), p, n, lo,  # noqa: E731
                                             scratch, count_as=None)
            row["us_per_call"], row["parent_us_per_call"] = paired_event_us((bind, orun), reset)
            reset()
            orun()
            torch.cuda.synchronize()
            row["parent_equal"] = bool(torch.equal(t, t_new) and torch.equal(ring[2], ring[1]))
        row["device_us"] = _sum_us(split)
        row["kernels_per_call"] = sum(v["launches"] for v in split[0].values())
        row["split_us"] = _named(split, K6_SPLIT)
        reset()
        out[scenario] = row
    return out


def finalize_case(dev):
    """chip_smoke.check_waves' finalize input: the linked-class batch's
    plan run on the card up to and through its longest scan segment
    after the first wave, (table, carry words, B, the wave mask as
    hist_fix)."""
    table, ev, dstat, n, ts_base, plan = _linked_case()
    t, pk, _ds, w = _pair(dev, table, ev, dstat)
    first_wave = next(k for k, (kind, _) in enumerate(plan.segments) if kind == "wave")
    seg_at = max((k for k, (kind, _) in enumerate(plan.segments)
                  if kind == "scan" and k > first_wave),
                 key=lambda k: len(plan.segments[k][1]))
    for kind, ix in plan.segments[:seg_at + 1]:
        ixt = torch.from_numpy(np.asarray(ix, np.int32)).to(dev)
        if kind == "wave":
            waves.wave_step(t, pk, w, ixt, n, ts_base)
        else:
            k3.scan_segment(t, pk, w, ixt, n, ts_base)
    fix = torch.zeros(B, dtype=torch.uint8)
    fix[:n] = torch.from_numpy(plan.wave_mask.astype(np.uint8))
    return t, w, B, fix.to(dev)


def fin_sweep(dev, parent=None) -> dict:
    """K3 finalize at B = 8192 with chip_smoke.py's hist_fix, with none
    and with every row fixed: device microseconds and kernels per call,
    and the bits against the plain version; with `parent`, that tree's
    finalize in turns with the change, and its bits against the
    change's."""
    old = _parent_lib(parent, "exact_scan") if parent is not None else None
    t, w, Bn, fix = finalize_case(dev)
    out = {}
    for name, hf in (("chip_smoke", fix), ("none", None),
                     ("all", torch.ones(Bn, dtype=torch.uint8, device=dev))):
        run = lambda hf=hf: k3.finalize(t, w, Bn, hf)  # noqa: E731
        res = k3.carry_views(w, Bn)["results"]
        row = {"fixed": 0 if hf is None else int(hf.sum()),
               "rewritten": 0 if hf is None else int(((hf != 0) & (res == 0)).sum())}
        got = run()
        row["plain_equal"] = bool(torch.equal(got, k3.finalize_plain(t, w, Bn, hf)))
        if old is None:
            split = [device_split(run, None, FIN_NAMES)]
        else:
            fn = old.tb_exact_finalize
            fn.argtypes = [_P, _I64, _I, _P, _P, _P, _P]
            o_out = torch.empty_like(got)

            def orun(hf=hf):
                rc = fn(t.data_ptr(), t.shape[0], Bn, w.data_ptr(),
                        None if hf is None else hf.data_ptr(), o_out.data_ptr(), _stream())
                if rc:
                    raise RuntimeError(f"parent tb_exact_finalize: "
                                       f"{old.tb_error_string(rc).decode()}")
            turns = _split_in_turns(run, orun, None, FIN_NAMES)
            split = turns["change"]
            row["parent_device_us"] = _sum_us(turns["parent"])
            row["parent_device_us_turns"] = [_sum_us([s]) for s in turns["parent"]]
            row["device_us_turns"] = [_sum_us([s]) for s in turns["change"]]
            k_out = torch.empty_like(got)
            bind = lambda hf=hf: kernels.exact_finalize(t, Bn, w, hf, k_out)  # noqa: E731
            row["us_per_call"], row["parent_us_per_call"] = paired_event_us((bind, orun),
                                                                            lambda: None)
            orun()
            torch.cuda.synchronize()
            row["parent_equal"] = bool(torch.equal(o_out, got))
        row["device_us"] = _sum_us(split)
        row["kernels_per_call"] = sum(v["launches"] for v in split[0].values())
        out[name] = row
    return out


# ---- K3 init and K14 gather, the change against an earlier tree's kernels.

INIT_NAMES = ("init_kernel",)
# K3 init's cases: (B, the carry's offset in words past a 16-byte
# aligned pointer): the wave batch, an even B that is not a multiple of
# 256, an odd B and the wave batch one word off alignment (both 8-byte
# words).
INIT_CASES = ((8192, 0), (8190, 0), (4097, 0), (8192, 1))
SENTINEL = 0x5A5A5A5A5A5A5A5A
# Where variant_lib builds copies of this tree's sources with other
# compile-time constants (measurements, not kernels of the port).
VARIANT_DIR = build.BUILD_DIR.parent / "probe_src"


def variant_lib(name, tag, consts):
    """This tree's library `name` built with `consts` ({constant: C++
    value}) in place of the source's own ``constexpr <type> NAME = ...;``
    lines, in a directory of its own (VARIANT_DIR / tag) beside copies
    of the shared headers."""
    import shutil

    text = (build.CSRC / f"{name}.cu").read_text()
    for const, value in consts.items():
        text, hits = re.subn(rf"(constexpr [\w:]+ {const} = )[^;]+;", rf"\g<1>{value};", text)
        if hits != 1:
            raise ValueError(f"{name}.cu: no single constexpr {const}")
    src = VARIANT_DIR / tag
    src.mkdir(parents=True, exist_ok=True)
    for header in build.CSRC.glob("*.cuh"):
        shutil.copy(header, src / header.name)
    (src / f"{name}.cu").write_text(text)
    build.build_all((name,), src)
    lib = ctypes.CDLL(str(build.library_path(name, src)))
    lib.tb_error_string.argtypes = [_I]
    lib.tb_error_string.restype = ctypes.c_char_p
    return lib


def _raw(lib, symbol, argtypes, *args):
    """A call of `symbol` in `lib` on the current stream; raises on a
    CUDA status."""
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = _I

    def run():
        rc = fn(*args, _stream())
        if rc:
            raise RuntimeError(f"{symbol}: {lib.tb_error_string(rc).decode()}")
    return run


def device_turns(fns, names, reset=None) -> dict:
    """Device microseconds per call of each of `fns` ({who: fn}), the
    profiler's, taken in turns: every fn in order, then in the reverse
    order (parent, change, change, parent for two); `names[who]` the
    device functions counted (every one where `names` has no entry);
    `reset()` before every call."""
    order = list(fns) + list(fns)[::-1]
    out = {who: [] for who in fns}
    for who in order:
        split = {}
        for _ in range(3):  # a profile that saw none of the kernels is taken again
            split = device_split(fns[who], reset, names.get(who, ("",)))
            if split:
                break
        out[who].append(_sum_us([split]) if split else None)
    return out


def _turns_into(row, turns, prefix="") -> None:
    """device_turns' microseconds into `row`: each side's turns and
    their mean (None where the profiler saw no kernel), under keys that
    start with `prefix`."""
    for who, us in turns.items():
        seen = [u for u in us if u is not None]
        row[f"{prefix}{who}_device_us_turns"] = us
        row[f"{prefix}{who}_device_us"] = float(np.mean(seen)) if seen else None
    print(json.dumps(row), file=sys.stderr)


def l2_flusher(dev):
    """A reset that leaves nothing of a call's data in the card's 50 MB
    L2: 128 MiB stored over (its kernel is not counted where device
    functions are named)."""
    scrub = torch.empty(1 << 24, dtype=torch.int64, device=dev)
    return scrub.zero_


def init_sweep(dev, parent=None) -> dict:
    """K3 init on INIT_CASES: device microseconds per call in turns with
    `w.zero_()` over the same 57 * B + 4 words (a store pass of that
    size, not the same function) and, with `parent`, that tree's K3
    init; CUDA-event microseconds per call alternating; the bits against
    make_carry and the parent's, and the word past the carry left as it
    was."""
    old = _parent_lib(parent, "exact_scan") if parent is not None else None
    rng = np.random.default_rng(2070)
    out = {}
    for Bn, off in INIT_CASES:
        n = k3.scratch_words(Bn)
        ds = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, Bn, dtype=np.int64)
                              .astype(np.int32)).to(dev)
        base = torch.full((n + off + 1,), SENTINEL, dtype=torch.int64, device=dev)
        w = base[off:off + n]
        run = lambda w=w, ds=ds: kernels.exact_init(w, ds)  # noqa: E731
        fns = {"change": run, "zero_": w.zero_}
        if old is not None:
            fns["parent"] = _raw(old, "tb_exact_init", [_P, _I, _P, _P], w.data_ptr(), Bn,
                                 ds.data_ptr())
        run()
        torch.cuda.synchronize()
        row = {"B": Bn, "offset_words": off, "words": n, "bytes": n * 8 + Bn * 4,
               "bound_us": (n * 8 + Bn * 4) / 3.35e12 * 1e6,
               "plain_equal": bool(torch.equal(w, k3.make_carry(torch.empty_like(w), ds))),
               "sentinel_kept": int(base[off + n]) == SENTINEL}
        got = w.clone()
        if old is not None:
            w.fill_(-7)
            fns["parent"]()
            torch.cuda.synchronize()
            row["parent_equal"] = bool(torch.equal(w, got))
            row["us_per_call"], row["parent_us_per_call"] = paired_event_us(
                (run, fns["parent"]), lambda: None)
        _turns_into(row, device_turns(fns, {"change": INIT_NAMES, "parent": INIT_NAMES}))
        out[f"B={Bn},offset={off}"] = row
    return out


K14_SHARDS, K14_SHARD = 4, 1
K14_BATCH_K = 16_380  # a wave batch's debit and credit slots
K14_NAMES = ("shard_gather",)
# The gather's store kind, measured both ways at every shape: streaming
# stores (st.global.cs) at every size, and at none.
K14_STORES = {"streaming": {"STREAM_FROM_BYTES": "0"},
              "default": {"STREAM_FROM_BYTES": "INT64_MAX"}}
# Launch shapes beside the source's own: (blocks an SM, pieces a thread
# keeps in flight, threads a block), stores chosen as the source chooses.
K14_SHAPES = {"b8u2": {"GATHER_BLOCKS_PER_SM": "8", "GATHER_UNROLL": "2"},
              "b8u4": {"GATHER_BLOCKS_PER_SM": "8", "GATHER_UNROLL": "4"},
              "b2u8": {"GATHER_BLOCKS_PER_SM": "2", "GATHER_UNROLL": "8"},
              "t128b8u4": {"THREADS": "128", "GATHER_BLOCKS_PER_SM": "8",
                           "GATHER_UNROLL": "4"},
              "m2": {"GATHER_MIN_PIECES": "2"}, "m4": {"GATHER_MIN_PIECES": "4"}}


def window_unit_rows(rng) -> np.ndarray:
    """The rows one window unit of sharded_engine/simple gathers: the
    compact rows (sharded.compact_rows) of a window of gen_simple
    batches on the 2^20-row table, each event debiting a uniform account
    d of chip_smoke.py's 1,000,000 and crediting d % 1,000,000 + 1
    (~780,000 rows at the default window of 96 batches)."""
    from tigerbeetle_tpu_torch import envcheck
    from tigerbeetle_tpu_torch.parallel import sharded

    n_accounts = 1_000_000
    d = rng.integers(0, n_accounts, envcheck.dev_window() * workload.BATCH)
    return sharded.compact_rows(np.concatenate([d, (d + 1) % n_accounts]), A_ROWS)


def k14_cases(dev, table=None):
    """chip_smoke.py's K14 inputs: [(shape, W, shard table, global
    slots)] for shard K14_SHARD of a 2^20-row table split in
    K14_SHARDS, at W = 8, 2 and 1, on a wave batch's K14_BATCH_K sorted
    distinct slots and on a window unit's rows.  `table`: the W = 8
    shard table (default: the balances of chip_smoke.py's K12 case)."""
    from tigerbeetle_tpu_torch.parallel import sharded
    from tigerbeetle_tpu_torch.testing import shard_cases

    local = A_ROWS // K14_SHARDS
    if table is None:
        balances = shard_cases.apply_events(2040, A_ROWS, workload.BATCH, near_ceiling=64)[0]
        table = sharded.shard_balances(sharded.make_row_mesh([dev] * K14_SHARDS),
                                       balances)[K14_SHARD]
    rng = np.random.default_rng(2041)
    batch = np.sort(rng.choice(A_ROWS, K14_BATCH_K, replace=False))
    shapes = (("widths", batch), ("window_unit", window_unit_rows(rng)))
    out = []
    for key, slots in shapes:
        for W in (8, 2, 1):
            t = table if W == 8 else torch.from_numpy(
                rng.integers(-(1 << 63), (1 << 63) - 1, (local, W))).to(dev)
            out.append((key, W, t, torch.from_numpy(slots).to(dev)))
    return out


def k14_sweep(dev, parent=None) -> dict:
    """K14 gather on k14_cases: device microseconds per call in turns
    with index_select + where (the same function in PyTorch, from
    own_rows' mask and clipped indices), with this tree's gather built
    with streaming stores and with default ones at every size and at
    the launch shapes of K14_SHAPES (where the source chooses its
    stores), and with `parent`'s gather;
    CUDA-event microseconds per call of the change and the parent
    alternating; the bits against the plain version and the others'."""
    from tigerbeetle_tpu_torch.parallel import sharded

    old = _parent_lib(parent, "shard_rows") if parent is not None else None
    stores = {}
    if "STREAM_FROM_BYTES" in (build.CSRC / "shard_rows.cu").read_text():
        stores = {kind: variant_lib("shard_rows", f"k14_{kind}", c)
                  for kind, c in {**K14_STORES, **K14_SHAPES}.items()}
    args = [_P, _I64, _I64, _P, _I64, _I64, _P, _P]  # ..., out, stream
    out = {}
    for key, W, t, slots in k14_cases(dev):
        local, K = t.shape[0], slots.shape[0]
        row0 = K14_SHARD * local
        own, rel = sharded.own_rows(slots, local, K14_SHARD)
        owned = int(own.sum())
        got = torch.empty((K, W), dtype=torch.int64, device=dev)
        run = lambda t=t, s=slots, got=got: kernels.shard_gather(t, row0, s, got)  # noqa: E731
        run()
        n_bytes = K * 8 + owned * 8 * W + K * 8 * W
        row = {"K": K, "owned": owned, "W": W, "bound_us": n_bytes / 3.35e12 * 1e6,
               "plain_equal": bool(torch.equal(
                   got, sharded.gather_part_plain(t, slots, K14_SHARD)))}
        own2 = own[:, None]
        fns = {"change": run,
               "library": lambda t=t, own2=own2, rel=rel: torch.where(
                   own2, t.index_select(0, rel), 0)}
        others = {}
        for who, lib in ([("parent", old)] if old is not None else []) + list(stores.items()):
            o = torch.empty_like(got)
            fns[who] = _raw(lib, "tb_shard_gather", args, t.data_ptr(), local, row0,
                            slots.data_ptr(), K, W, o.data_ptr())
            others[who] = o
        for who, o in others.items():
            o.fill_(-7)
            fns[who]()
            torch.cuda.synchronize()
            row[f"{who}_equal"] = bool(torch.equal(o, got))
        if old is not None:
            row["us_per_call"], row["parent_us_per_call"] = paired_event_us(
                (run, fns["parent"]), lambda: None)
        _turns_into(row, device_turns(fns, {who: K14_NAMES for who in fns if who != "library"}))
        out[f"{key},W={W}"] = row
    return out


# ---- K4 and K9, the change against an earlier tree's kernels.

K4_NAMES = ("apply_deltas",)
def k4_cases():
    """[(name, table (R, 8) int64, packed (4, k) int64, offset words)]:
    chip_smoke.py's timed call, the same one word off 16-byte alignment
    (the 8-byte path), and a simple_host and a sharded_host flush's
    first (32,768 entries) and last launches, on a 2^20-row table and on
    the compact table of the flushed rows."""
    from tigerbeetle_tpu_torch.testing import flush_cases

    table, packed = flush_cases.timed_case(A_ROWS)
    out = [("chip_smoke", table, packed, 0), ("chip_smoke_unaligned", table, packed, 1)]
    for name, compact in (("simple_host", False), ("sharded_host", True)):
        t, chunks = flush_cases.flush_case(2029, A_ROWS, 1_000_000, compact=compact)
        out += [(f"{name}_first", t, chunks[0], 0), (f"{name}_last", t, chunks[-1], 0)]
    return out


def k4_sweep(dev, parent=None) -> dict:
    """K4 on k4_cases: device microseconds per call in turns with the
    yardstick ``index_select`` of the same live cells from
    ``table.view(-1, 2)`` (one dependent random trip, the same reads: not
    the same function) and with `parent`'s; CUDA-event microseconds per call of the change and
    the parent alternating; the bits against the plain version and the
    others'."""
    old = _parent_lib(parent, "apply_deltas") if parent is not None else None
    args = [_P, _I64, _P, _I64, _I64, _P]  # table, A, packed, k, stride, stream
    flush = l2_flusher(dev)
    out = {}
    for name, table, packed, off in k4_cases():
        R, k = table.shape[0], packed.shape[1]
        base = torch.empty(R * 8 + off, dtype=torch.int64, device=dev)
        t = base[off:].view(R, 8)
        t0 = torch.from_numpy(table).to(dev)
        pk = torch.from_numpy(packed).to(dev)
        live = (pk[0] >= 0) & (pk[0] < R)
        cells = (pk[0] * 4 + pk[1])[live]
        n_live = int(live.sum())
        t.copy_(t0)
        dk.apply_deltas(t, pk)
        torch.cuda.synchronize()
        got = t.clone()
        row = {"entries": k, "live": n_live, "rows": R, "offset_words": off,
               "bound_us": (k * 32 + n_live * 32) / 3.35e12 * 1e6,
               "plain_equal": bool(torch.equal(got, dk.apply_deltas_plain(t0.clone(), pk)))}
        if hasattr(kernels, "apply_deltas_geometry"):
            row["geometry"] = list(kernels.apply_deltas_geometry(k))
        fns = {"change": lambda t=t, pk=pk: dk.apply_deltas(t, pk),
               "index_select": lambda t=t, c=cells: t.view(-1, 2).index_select(0, c)}
        if old is not None:
            fns["parent"] = _raw(old, "tb_apply_deltas", args, t.data_ptr(), R, pk.data_ptr(),
                                 k, k)
            t.copy_(t0)
            fns["parent"]()
            torch.cuda.synchronize()
            row["parent_equal"] = bool(torch.equal(t, got))
            row["us_per_call"], row["parent_us_per_call"] = paired_event_us(
                (fns["change"], fns["parent"]), lambda: None)
        _turns_into(row, device_turns(fns, {who: K4_NAMES for who in fns
                                            if who != "index_select"}))
        # Cold, as the main path finds the table: L2 flushed before each
        # call (not on the compact table, which a flush's K14 gather has
        # just written).
        if not name.startswith("sharded"):
            cold = {who: fns[who] for who in ("change", "parent") if who in fns}
            _turns_into(row, device_turns(cold, {who: K4_NAMES for who in cold},
                                          reset=flush), prefix="cold_")
        out[name] = row
    return out


K9_NAMES = ("spec_",)


def offkernel_spec_batch(dev):
    """(events, idx, serial, n, A) of the K9 launch of the first
    speculative batch of chip_smoke.py's offkernel phase (gen_offkernel,
    1,000,001 accounts on the device engine), as the engine launched
    it."""
    from tigerbeetle_tpu_torch.state_machine.gpu import TorchStateMachine
    from tigerbeetle_tpu_torch.testing.harness import SingleNodeHarness

    setup, timed, sizing = workload.gen_offkernel(32 * workload.BATCH, n_accounts=1_000_001)
    seen = []
    launch = waves.spec_conflicts

    def capture(events, idx, serial, n, A, scratch=None):
        seen.append((events.clone(), idx.clone(), None if serial is None else serial.clone(),
                     n, A))
        return launch(events, idx, serial, n, A, scratch=scratch)

    waves.spec_conflicts = capture
    waves._KERNEL_FNS["spec"] = capture
    try:
        sm = TorchStateMachine(account_capacity=A_ROWS, transfer_capacity=sizing[1] + 1024,
                               engine="device", devices=[dev])
        h = SingleNodeHarness(sm)
        for op, body in setup:
            h.submit(op, body)
        sm._dev.drain()
        for op, body, *_ in timed:
            h.submit(op, body)
            if seen:
                break
        sm._dev.drain()
        torch.cuda.synchronize()
    finally:
        waves.spec_conflicts = launch
        waves._KERNEL_FNS["spec"] = launch
    if not seen:
        raise RuntimeError("the offkernel phase launched no K9")
    return seen[0]


def k9_cases(dev):
    """[(name, events, idx, serial, n, A)] on the card: chip_smoke.py's
    timed batch (8190 "mixed" events over 8192 rows of a 2^20-row
    table), a batch whose slots, groups and targets are all distinct,
    and the offkernel phase's first speculative batch."""
    from tigerbeetle_tpu_torch.state_machine import resolve

    pool = np.sort(np.random.default_rng(2030).choice(A_ROWS, 200_000, replace=False))
    out = []
    _t, ev, _d, n, _ts = scan_cases.make_case(2031, B, "mixed", A=A_ROWS, rows=pool[:B], n=8190)
    serial = resolve.spec_meta_from_events(ev, n, False)["chain_member"].astype(np.uint8)
    out.append(("chip_smoke", ev, serial, n))
    ev, n, serial = wave_cases.distinct_spec_case(2033, B, A_ROWS, n=8190)
    out.append(("distinct", ev, serial, n))
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    cases = [(name, to(k3.pack_events(ev).view(np.int64)),
              torch.arange(n, dtype=torch.int32, device=dev), to(serial[:n]), n, A_ROWS)
             for name, ev, serial, n in out]
    return cases + [("offkernel",) + offkernel_spec_batch(dev)]


def _old_spec_scratch(B_rows, A, dev):
    full = lambda m: torch.full((m,), (1 << 31) - 1, dtype=torch.int32,  # noqa: E731
                                device=dev)
    return full(B_rows), full(B_rows), full(A), full(A)


def k9_sweep(dev, parent=None) -> dict:
    """K9 on k9_cases: device microseconds per call (every kernel a call
    launches, the profiler's) in turns with `parent`'s three-launch K9
    on its own resting arrays; CUDA-event microseconds per call of the
    change and the parent alternating; the conflicted lanes and the bits
    against the plain version and the parent's."""
    old = _parent_lib(parent, "spec_conflicts") if parent is not None else None
    flush = l2_flusher(dev)
    out = {}
    for name, pk, idx, serial, n, A in k9_cases(dev):
        K, Bn = idx.shape[0], pk.shape[0]
        scratch = waves.WaveScratch(dev)
        got = waves.spec_conflicts(pk, idx, serial, n, A, scratch=scratch)
        want = waves.spec_conflicts_plain(pk, idx, serial, n, A).to(torch.uint8)
        torch.cuda.synchronize()
        row = {"lanes": K, "events": n, "rows": A, "conflicted": int(want.sum()),
               "bound_us": K * (12 * 8 + 4 + 1 + 1) / 3.35e12 * 1e6,
               "plain_equal": bool(torch.equal(got, want))}
        if hasattr(kernels, "spec_conflicts_geometry"):
            row["geometry"] = list(kernels.spec_conflicts_geometry(K))
        fns = {"change": lambda pk=pk, idx=idx, s=serial, n=n, A=A, sc=scratch:
               waves.spec_conflicts(pk, idx, s, n, A, scratch=sc)}
        if old is not None:
            o = torch.empty(K, dtype=torch.uint8, device=dev)
            arrays = _old_spec_scratch(max(Bn, B), A, dev)
            fns["parent"] = _raw(old, "tb_spec_conflicts",
                                 [_P, _I, _P, _I, _P, _I, _I64, _P, _P, _P, _P, _P, _P],
                                 pk.data_ptr(), Bn, idx.data_ptr(), K, serial.data_ptr(), n, A,
                                 *(a.data_ptr() for a in arrays), o.data_ptr())
            for _ in range(3):  # a few calls back to back, then the bits
                o.fill_(7)
                fns["parent"]()
            torch.cuda.synchronize()
            row["parent_equal"] = bool(torch.equal(o, got))
            row["us_per_call"], row["parent_us_per_call"] = paired_event_us(
                (fns["change"], fns["parent"]), lambda: None)
        names = {who: K9_NAMES for who in fns}
        _turns_into(row, device_turns(fns, names))
        _turns_into(row, device_turns(fns, names, reset=flush), prefix="cold_")
        out[name] = row
    return out


# ---- K2 admit, the change against an earlier tree's kernel.

K2A_NAMES = ("cm_admit",)
K2U_NAMES = ("cm_update",)

def k2a_cases():
    """[(name, H, slots, offset words)]: the tiered phase's census shapes
    on a 2^20-row hash table (a timed admission's 80 slots, the census
    median of 59-116, and a warm-up's 16,380), chip_smoke.py's 16,384,
    the same one word off 16-byte alignment, 80 slots padded by
    ``pad_slots`` to 256 with -1 lanes, and 16,384 slots that hold row
    H-1 with 1,000 slots past the table and without them."""
    from tigerbeetle_tpu_torch.state_machine import commitment as cm

    rng = np.random.default_rng(16)
    H = A_ROWS
    draw = lambda k: rng.choice(H - 1, k, replace=False).astype(np.int64)  # noqa: E731
    full = draw(16_384)
    past = np.concatenate([draw(15_383), [H - 1], H + rng.choice(H, 1_000, replace=False)])
    return [("timed_80", H, draw(80), 0), ("warm_16380", H, draw(16_380), 0),
            ("chip_smoke_16384", H, full, 0), ("unaligned_16384", H, full, 1),
            ("padded_80", H, cm.pad_slots(draw(80)), 0),
            ("last_row_16384", H, np.concatenate([draw(16_383), [H - 1]]), 0),
            ("past_16384", H, rng.permutation(past), 0)]


def k2a_sweep(dev, parent=None) -> dict:
    """K2 admit on k2a_cases: device microseconds per call in turns with
    an empty kernel of the same launch shape and with `parent`'s, warm
    and cold (L2 flushed before each call); CUDA-event microseconds per
    call of the change and the parent alternating; the bits against the
    plain version and the parent's."""
    from tigerbeetle_tpu_torch.ops.u128 import from_u64
    from tigerbeetle_tpu_torch.state_machine import commitment as cm
    from tigerbeetle_tpu_torch.testing import commit_cases

    args = [_P, _I64, _P, _P, _P, _P, _I64, _P]  # row_hash, H, digest, slots, lo, hi, k, stream
    libs = {} if parent is None else {"parent": _parent_lib(parent, "commitment")}
    flush = l2_flusher(dev)
    out = {}
    for name, H, slots, off in k2a_cases():
        k = len(slots)
        rh0, dg0, sl_np, lo_np, hi_np = commit_cases.admit_case(slots, H, k)
        base = torch.empty(H * 2 + off, dtype=torch.int64, device=dev)
        rh = base[off:].view(H, 2)
        rh_c, dg_c = from_u64(rh0), from_u64(dg0)
        sl = torch.from_numpy(sl_np).to(dev)
        lo, hi = from_u64(lo_np).to(dev), from_u64(hi_np).to(dev)
        want = cm.admit_plain(rh_c.clone(), dg_c.clone(), sl.cpu(), lo.cpu(), hi.cpu())
        dg = torch.empty(2, dtype=torch.int64, device=dev)

        def fresh():
            rh.copy_(rh_c)
            dg.copy_(dg_c)

        fresh()
        cm.admit(rh, dg, sl, lo, hi)
        torch.cuda.synchronize()
        live = int((sl >= 0).sum())
        G, T = kernels.commit_admit_geometry(k)
        row = {"slots": k, "live": live, "past": int((sl >= H).sum()), "rows": H,
               "offset_words": off, "geometry": [G, T],
               "bound_us": (k * 8 + live * 48 + 32) / 3.35e12 * 1e6,
               "plain_equal": bool(torch.equal(rh.cpu(), want[0])
                                   and torch.equal(dg.cpu(), want[1]))}
        # Both trees by raw bindings: the CUDA-event times compare launches,
        # not the wrapper's checks against none.
        fns = {"change": _raw(build.load("commitment"), "tb_commit_admit", args, rh.data_ptr(),
                              H, dg.data_ptr(), sl.data_ptr(), lo.data_ptr(), hi.data_ptr(), k),
               "empty": lambda G=G, T=T: kernels.commit_empty(dev.index, G, T)}
        for who, lib in libs.items():
            fns[who] = _raw(lib, "tb_commit_admit", args, rh.data_ptr(), H, dg.data_ptr(),
                            sl.data_ptr(), lo.data_ptr(), hi.data_ptr(), k)
            fresh()
            fns[who]()
            torch.cuda.synchronize()
            row[f"{who}_equal"] = bool(torch.equal(rh.cpu(), want[0])
                                       and torch.equal(dg.cpu(), want[1]))
        if "parent" in fns:
            row["us_per_call"], row["parent_us_per_call"] = paired_event_us(
                (fns["change"], fns["parent"]), lambda: None)
        names = {who: ("cm_empty",) if who == "empty" else K2A_NAMES for who in fns}
        _turns_into(row, device_turns(fns, names))
        cold = {who: fns[who] for who in ("change", "parent", "empty") if who in fns}
        _turns_into(row, device_turns(cold, names, reset=flush), prefix="cold_")
        out[name] = row
    return out


def k2u_sweep(dev, parent=None) -> dict:
    """K2 update at chip_smoke.py's window shape (the touched rows of 96
    batches x 2 x 8190 draws over 1,000,000 accounts of a 2^20-row table,
    padded with -1 to 2^20 slots): device microseconds per call in turns
    with `parent`'s; the bits against the plain version and the
    parent's, and of a call with slots past the table and the owner of
    row A-1 against the plain version."""
    from tigerbeetle_tpu_torch.ops.u128 import from_u64
    from tigerbeetle_tpu_torch.state_machine import commitment as cm
    from tigerbeetle_tpu_torch.testing import commit_cases

    rng = np.random.default_rng(2026)
    A = A_ROWS
    lo = rng.integers(-(1 << 63), (1 << 63) - 1, (A, 4), dtype=np.int64)
    hi = rng.integers(0, 1 << 40, (A, 4), dtype=np.int64)
    table = torch.from_numpy(np.stack([lo, hi], -1).reshape(A, 8)).to(dev)
    meta = torch.ones((A, 2), dtype=torch.int32, device=dev)
    rows = torch.arange(A, dtype=torch.int64, device=dev)
    rh0, dg0 = cm.rebuild(table, meta, rows)
    touched = np.unique(rng.integers(0, 1_000_000, 96 * 2 * 8190))
    slots = torch.from_numpy(cm.pad_slots(touched)).to(dev)
    t_idx = torch.from_numpy(touched).to(dev)
    table[t_idx, 3] += 12345
    want = cm.update_plain(table, meta, rh0.clone(), dg0.clone(), slots, slots)
    rh, dg = rh0.clone(), dg0.clone()

    def fresh():
        rh.copy_(rh0)
        dg.copy_(dg0)

    fns = {"change": lambda: cm.update(table, meta, rh, dg, slots, slots)}
    k = slots.shape[0]
    ptrs = (rh.data_ptr(), dg.data_ptr(), slots.data_ptr(), slots.data_ptr(), k)
    if parent is not None:  # the signature before the row count A
        fns["parent"] = _raw(_parent_lib(parent, "commitment"), "tb_commit_update",
                             [_P, _P, _P, _P, _P, _P, _I64, _P], table.data_ptr(),
                             meta.data_ptr(), *ptrs)
    row = {"slots": k, "live": len(touched), "rows": A}
    for who, fn in fns.items():
        fresh()
        fn()
        torch.cuda.synchronize()
        row[f"{who}_equal"] = bool(torch.equal(rh, want[0]) and torch.equal(dg, want[1]))
    _turns_into(row, device_turns(fns, {who: K2U_NAMES for who in fns}))
    # The bits of a call with slots past the table and the owner of row A-1.
    P = 100_003
    past = np.concatenate([rng.choice(P - 1, 20_000, replace=False), [P - 1],
                           P + rng.choice(P, 1_000, replace=False)])
    b_np, m_np, rh_np, dg_np, sl_np, r_np = commit_cases.update_case(rng.permutation(past), P, 7)
    b, rh_p, dg_p, r_p = (from_u64(a).to(dev) for a in (b_np, rh_np, dg_np, r_np))
    m = torch.from_numpy(np.ascontiguousarray(m_np).view(np.int32)).to(dev)
    sl_p = torch.from_numpy(sl_np).to(dev)
    want_p = cm.update_plain(b, m, rh_p.clone(), dg_p.clone(), sl_p, r_p)
    got = cm.update(b, m, rh_p.clone(), dg_p.clone(), sl_p, r_p)
    torch.cuda.synchronize()
    row["past_equal"] = bool(torch.equal(got[0], want_p[0]) and torch.equal(got[1], want_p[1]))
    return {"window": row}


# One tree's phases (chip_smoke.py's streams, named on the command line),
# run from its root: each phase's main-path run (events/s, launches,
# windows or flushes) and a profiled run (busy share, the top device
# items, the device ms of the NAMED kernels), on one line.
_PHASES = """
import contextlib, json, sys, time
import torch
sys.path.insert(0, ".")
import chip_smoke as c
from tigerbeetle_tpu_torch import kernels, workload
from tigerbeetle_tpu_torch.kernels import build
from tigerbeetle_tpu_torch.parallel import sharded
from tigerbeetle_tpu_torch.state_machine import waves
from tigerbeetle_tpu_torch.testing import shard_cases
build.build_all()
named = ("two_phase_kernel", "tp_", "apply_rows_kernel", "summary_kernel", "finalize_kernel",
         "init_kernel", "shard_gather", "shard_scatter", "apply_deltas", "spec_")
dev = torch.device("cuda", 0)
B = workload.BATCH
# The (slots, width) of every K14 gather launch and the entries of every
# K4 launch, by the wrappers' own arguments.
gathers = []
applies = []
launch_gather = kernels.shard_gather
launch_apply = kernels.apply_deltas


def recording(table, row0, slots, out):
    gathers.append((slots.shape[0], table.shape[1]))
    return launch_gather(table, row0, slots, out)


def recording_apply(table, packed):
    applies.append(packed.shape[1])
    return launch_apply(table, packed)


kernels.shard_gather = recording
kernels.apply_deltas = recording_apply


def stream(name):
    # (setup, timed, account capacity, engine, devices, knobs)
    shards = [c.CARD] * c.SHARDS
    if name == "two_phase":
        setup, timed, sizing = workload.gen_two_phase(c.N_EXACT, n_accounts=c.N_ACCOUNTS)
        return setup, timed, sizing[0], "device", None, {}
    if name == "waves_host":
        setup, timed, sizing = workload.gen_waves_host(c.WAVE_BATCHES * B,
                                                       n_accounts=c.N_ACCOUNTS)
        return setup, timed, sizing[0], "host", None, {}
    if name == "offkernel":
        setup, timed, _ = workload.gen_offkernel(c.WAVE_BATCHES * B,
                                                 n_accounts=c.OFFKERNEL_ACCOUNTS)
        return setup, timed, c.A_ROWS, "device", None, {}
    if name == "sharded_engine/simple":
        setup, timed, _ = workload.gen_simple(c.N_TRANSFERS, n_accounts=c.N_ACCOUNTS)
        return setup, timed, c.A_ROWS, "device", shards, {}
    if name == "sharded_engine/pv":
        setup, timed = shard_cases.pv_balancing_stream(2060, c.WAVE_BATCHES, B, c.N_ACCOUNTS,
                                                       c.PV_HISTORY)
        return setup, timed, c.A_ROWS, "device", shards, {"TB_DEV_WAVES": "1"}
    if name == "sharded_host":
        setup, timed, sizing = workload.gen_simple(c.N_TRANSFERS, n_accounts=c.N_ACCOUNTS)
        timed = timed + [c.linked_exact_batch(c.N_ACCOUNTS, workload.TID0 + c.N_TRANSFERS)]
        return setup, timed, sizing[0], "host", shards, {}
    if name == "simple_host":
        setup, timed, sizing = workload.gen_simple(c.N_TRANSFERS, n_accounts=c.N_ACCOUNTS)
        return setup, timed, sizing[0], "host", None, {}
    if name == "linked":
        setup, timed, sizing = workload.gen_linked(c.N_EXACT)
        return setup, timed, sizing[0], "device", None, {}
    if name == "expiry":
        setup, timed = c.expiry_stream(8, B, c.N_ACCOUNTS)
        return setup, timed, c.A_ROWS, "device", None, {}
    if name == "tiered_host":
        # chip_smoke.py's tiered_host arm: the accounts and the warm-up
        # sweep as setup, the timed batches asynchronously here.
        warm = c.head_sweep(c.TIER_WARM, B, c.TIER_HEAD, workload.WARM0)
        timed = workload.gen_tiering(c.TIER_TIMED, B, c.TIER_ACCOUNTS, c.TIER_HEAD, c.TIER_TAIL,
                                     workload.TID0)
        cap, _ = workload._sizing(c.TIER_ACCOUNTS, 0)
        return (list(c.tier_accounts()) + list(warm), list(timed), cap, "host", None,
                {"TB_HOT_CAPACITY": str(c.TIER_HOT)})
    raise SystemExit(f"no phase {name}")


def sharded_waves(profile):
    mesh = sharded.make_row_mesh([dev] * c.SHARDS)
    table, batches = shard_cases.wave_stream(c.WAVE_SHARD_SEED, c.WAVE_BATCHES, B, c.A_ROWS)
    fixes = [shard_cases.hist_fix(p, n, B) for _e, _d, n, _t, p in batches]
    scratch = waves.WaveScratch(dev)
    tables = sharded.shard_balances(mesh, table)
    outs = []
    kernels.reset_launches()
    torch.cuda.synchronize()
    prof = c.device_profiler() if profile else contextlib.nullcontext()
    with prof:
        t0 = time.perf_counter()
        for (ev, dstat, n, ts_base, plan), fix in zip(batches, fixes):
            tables, packed = waves._execute_plan_sharded(tables, ev, dstat, n, ts_base, plan,
                                                         fix, mesh, scratch=scratch)
            outs.append(packed)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    launches = dict(kernels.launches)
    trace = c.device_busy(prof) if profile else None
    if trace is not None:
        trace = trace + (c.device_named_ms(prof, named),)
    joined = torch.cat(tables).cpu()
    return (sum(n for _e, _d, n, _t, _p in batches), [joined] + [o.cpu() for o in outs],
            elapsed, launches, trace, len(batches))


out = {}
for name in sys.argv[1:]:
    gathers.clear()
    applies.clear()
    if name == "sharded_waves":
        events, res, elapsed, launches, _, units = sharded_waves(False)
        main_gathers, main_applies = list(gathers), list(applies)
        _, p_res, p_elapsed, _, trace, _ = sharded_waves(True)
        equal = all(torch.equal(a, b) for a, b in zip(res, p_res))
        root = None
    else:
        setup, timed, cap, engine, devices, env = stream(name)
        tc = c.transfer_events(setup + timed) + 1024
        events = c.transfer_events(timed)
        with c.knobs(**env):
            sm, replies, elapsed, launches, _ = c.run_stream(
                setup, timed, cap, tc, False, engine, devices=devices,
                checkpoint=engine == "host" and devices is not None)
            main_gathers = list(gathers)
            main_applies = list(applies)
            units = sm._dev.stat_windows if engine == "device" else sm._dev.stat_flushes
            root = sm.state_root().hex()
            del sm
            torch.cuda.empty_cache()
            p_sm, p_replies, p_elapsed, _, trace = c.run_stream(
                setup, timed, cap, tc, False, engine, profile=True, devices=devices,
                checkpoint=engine == "host" and devices is not None, named=named)
            equal = p_replies == replies and p_sm.state_root().hex() == root
            del p_sm
    torch.cuda.empty_cache()
    busy_ms, top, ms = trace if trace is not None else (None, None, {})
    share = None if busy_ms is None else busy_ms / 1e3 / p_elapsed
    counts = {}
    for k, w in main_gathers:
        counts[f"K={k},W={w}"] = counts.get(f"K={k},W={w}", 0) + 1
    out[name] = dict(events_per_s=events / elapsed, profiled_equal=equal, root=root,
                     busy_ms=busy_ms, busy_share=share,
                     top=top, named_ms=ms, windows_or_flushes=units,
                     launches={k: v for k, v in launches.items() if v}, gathers=counts,
                     apply_entries=main_applies)
print("TURN " + json.dumps(out, default=str))
"""
# The phases part's default phases.
PHASES = ("two_phase", "waves_host", "offkernel", "sharded_waves", "sharded_engine/simple",
          "sharded_engine/pv", "sharded_host", "simple_host", "tiered_host", "expiry", "linked")


def _in_turns(code, parent, timeout, argv=()) -> dict:
    """`code` run (with the arguments `argv`) from `parent`'s root and
    from this tree's, in turns (parent, change, change, parent), a
    process each; each run's TURN line."""
    import subprocess

    if parent is None:
        raise SystemExit("serial_probes: the turns and phases parts need --parent")
    here = Path(__file__).resolve().parents[2]
    out = {"parent": [], "change": []}
    for who in ("parent", "change", "change", "parent"):
        root = Path(parent).resolve() if who == "parent" else here
        run = subprocess.run([sys.executable, "-c", code, *argv], cwd=root, capture_output=True,
                             text=True, timeout=timeout)
        line = [ln for ln in run.stdout.splitlines() if ln.startswith("TURN ")]
        if run.returncode or not line:
            raise RuntimeError(f"turn in {root}: rc {run.returncode}\n{run.stderr[-3000:]}")
        out[who].append(json.loads(line[0][5:]))
    return out


def phases(dev, parent=None, names=PHASES) -> dict:
    """chip_smoke.py's streams `names` (of PHASES) from `parent`'s tree
    and from this one, in turns, each tree's in a process of its own:
    events/s of the main-path run, its launches and windows (device
    engine) or flushes (host engine), the profiled run's busy share, top
    items and the device ms of K6, K3 init and finalize and K14."""
    return _in_turns(_PHASES, parent, 1200, names)


# "turns" and "phases" run only when asked for.
PARTS = {"barrier": barrier_sweep, "k8": k8_sweep, "k3": k3_sweep, "split": walk_split,
         "k5": k5_sweep, "k7": k7_sweep, "k1": k1_sweep, "k13": k13_sweep, "k6": k6_sweep,
         "fin": fin_sweep, "init": init_sweep, "k14": k14_sweep, "k4": k4_sweep,
         "k9": k9_sweep, "k2a": k2a_sweep, "k2u": k2u_sweep, "turns": turns,
         "phases": phases}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the JSON object to this file")
    ap.add_argument("--parts", default=",".join(p for p in PARTS if p not in ("turns", "phases")),
                    help="comma-separated subset of " + ",".join(PARTS))
    ap.add_argument("--parent",
                    help="an earlier tree whose K1, K2 admit and update, K3 init and finalize, "
                         "K4, K5, K6, K7, K9, K13 admit and K14 gather run beside these")
    ap.add_argument("--k7-lanes", default="", help="more wave widths for the k7 part")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="the phases part's streams, a comma-separated subset of "
                         + ",".join(PHASES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("serial_probes: needs a CUDA card")
    dev = torch.device("cuda", 0)
    extra = {"k5": {"parent": args.parent}, "k1": {"parent": args.parent},
             "k13": {"parent": args.parent}, "turns": {"parent": args.parent},
             "k6": {"parent": args.parent}, "fin": {"parent": args.parent},
             "init": {"parent": args.parent}, "k14": {"parent": args.parent},
             "k4": {"parent": args.parent}, "k9": {"parent": args.parent},
             "k2a": {"parent": args.parent}, "k2u": {"parent": args.parent},
             "phases": {"parent": args.parent, "names": args.phases.split(",")},
             "k7": {"parent": args.parent,
                    "lanes": sorted(set(K7_LANES) | {int(k) for k in args.k7_lanes.split(",")
                                                    if k})}}
    res = {part: PARTS[part](dev, **extra.get(part, {})) for part in args.parts.split(",")}
    text = json.dumps(res)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

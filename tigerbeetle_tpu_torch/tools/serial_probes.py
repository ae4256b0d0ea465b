"""The serial kernels' floors and times on the card: K8's barrier, K8
over its chain shapes, K3 over its segment lengths, and where one K3
event's time goes.

    python -m tigerbeetle_tpu_torch.tools.serial_probes [--out FILE] [--parts k8,k3]

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

``main`` prints one JSON object of the parts asked for (``--parts``;
``k8`` and ``k3`` build nothing of their own, so they run on any tree
with the wrappers); ``chip_smoke.py`` prints the barrier, k8 and k3
parts.
"""

from __future__ import annotations

import argparse
import ctypes
import json

import numpy as np
import torch

from tigerbeetle_tpu_torch.kernels import build
from tigerbeetle_tpu_torch.state_machine import kernel as k3
from tigerbeetle_tpu_torch.state_machine import waves
from tigerbeetle_tpu_torch.testing import wave_cases

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


def device_us(fn, reset=None, names=(), reps: int = 20) -> float | None:
    """Device microseconds per call of `fn`: the profiler's CUDA kernel
    time of the kernels whose name holds one of `names`, over `reps`
    calls (`reset()` before each, its copies not counted)."""
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
    total = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and any(k in e.key for k in names):
            total += getattr(e, "self_device_time_total", None) or getattr(
                e, "self_cuda_time_total", 0.0)
    return total / reps if total > 0 else None


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


PARTS = {"barrier": barrier_sweep, "k8": k8_sweep, "k3": k3_sweep, "split": walk_split}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the JSON object to this file")
    ap.add_argument("--parts", default=",".join(PARTS),
                    help="comma-separated subset of " + ",".join(PARTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("serial_probes: needs a CUDA card")
    dev = torch.device("cuda", 0)
    res = {part: PARTS[part](dev) for part in args.parts.split(",")}
    text = json.dumps(res)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Host time of one K10 launch, split into its pieces, on the card.

    python -m tigerbeetle_tpu_torch.tools.launch_split [--rows 16384]

A wrapper call of ``device_kernels.tier_set_rows`` (K10) on the card
spends its host time in: the wrapper's checks, finding the tensors'
device, the device guard, the current stream's handle, the data
pointers, and the ctypes call into the library (which itself calls
``cudaLaunchKernel``).  This script times each piece alone on K10's
inputs (`--rows` distinct rows into a 2^20-row (H, 8) int64 balance
table), both as the generic launch path did it (a scan over the
arguments for the first tensor's ``device``, a ``torch.cuda.device``
context entered on every call, ``torch.cuda.current_stream(dev)
.cuda_stream``, ``data_ptr`` through an ``isinstance`` scan) and as the
direct path does (``get_device()``, a compare with the current device,
``torch._C._cuda_getCurrentRawStream``, the pointers named one by
one), then the whole wrapper and ``Tensor.index_copy_`` on the same
inputs.  Host-only pieces: ``time.perf_counter`` around many calls;
pieces that launch: many back-to-back calls and one
``torch.cuda.synchronize()``, over the count.  The ctypes call is timed
with the arguments the binding passes (recorded from one call), once
with k = 0 (the C function returns without launching: ctypes alone)
and once with k rows (ctypes + the launch).  Prints one JSON object of
microseconds per call; ``run(dev)`` returns it.  Needs a CUDA card.
"""
# tbcheck: allow-file(no-print): a command-line tool — the lines it
# prints on stdout are its output.

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from tigerbeetle_tpu_torch import kernels
from tigerbeetle_tpu_torch.state_machine import device_kernels as dk

TABLE_ROWS = 1 << 20
SYMBOL = "tb_tier_set_rows"


def _host_us(fn, reps: int) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e6


def _queued_us(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e6


def _recorded_call(call):
    """(the resolved ctypes function of K10, the arguments the binding
    passed it in `call`), without launching anything."""
    kernels._fn("tier", SYMBOL)
    fn = kernels._FNS[SYMBOL]
    seen = []
    kernels._FNS[SYMBOL] = lambda *args: seen.append(args) or 0
    try:
        call()
    finally:
        kernels._FNS[SYMBOL] = fn
    return fn, seen[0]


def run(dev, rows: int = 16_384, reps: int = 20_000, launch_reps: int = 2_000) -> dict:
    """Microseconds per call of each piece (see the module's doc)."""
    if dev.type != "cuda":
        raise ValueError("the launch split is measured on a CUDA card")
    rng = np.random.default_rng(7)
    table = torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, (TABLE_ROWS, 8))).to(dev)
    idx = torch.from_numpy(rng.choice(TABLE_ROWS, rows, replace=False).astype(np.int64)).to(dev)
    src = torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, (rows, 8))).to(dev)
    idx0, src0 = idx[:0], src[:0]
    args = (table, table.shape[0], table.shape[1], table.element_size(), idx, src, rows)
    index = table.get_device()
    raw_stream = torch._C._cuda_getCurrentRawStream
    current = torch._C._cuda_getDevice

    def generic_guard():
        with torch.cuda.device(dev):
            pass

    fn, live_args = _recorded_call(lambda: kernels.tier_set_rows(table, idx, src))
    _, noop_args = _recorded_call(lambda: kernels.tier_set_rows(table, idx0, src0))
    out = {
        "rows": rows,
        "checks": _host_us(lambda: dk.tier_set_rows(table, idx0, src0), reps),
        "generic": {
            "device": _host_us(
                lambda: next(a.device for a in args if isinstance(a, torch.Tensor)), reps),
            "guard": _host_us(generic_guard, reps),
            "stream": _host_us(lambda: torch.cuda.current_stream(dev).cuda_stream, reps),
            "ptrs": _host_us(
                lambda: [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args], reps),
        },
        "direct": {
            "device": _host_us(lambda: table.get_device(), reps),
            "guard": _host_us(lambda: current() == index, reps),
            "stream": _host_us(lambda: raw_stream(index), reps),
            "ptrs": _host_us(lambda: (table.data_ptr(), idx.data_ptr(), src.data_ptr()), reps),
        },
        "ctypes_args": len(live_args),
        "ctypes_no_launch": _host_us(lambda: fn(*noop_args), reps),
        "ctypes_launch": _queued_us(lambda: fn(*live_args), launch_reps),
        "wrapper": _queued_us(lambda: dk.tier_set_rows(table, idx, src), launch_reps),
        "index_copy_": _queued_us(lambda: table.index_copy_(0, idx, src), launch_reps),
    }
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=16_384)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("launch_split: no CUDA device")
    print(json.dumps(run(torch.device("cuda", 0), args.rows)))


if __name__ == "__main__":
    main()

"""An op-level profile of ``orderfree_lo`` and ``linked`` batches.

    python -m tigerbeetle_tpu_torch.experiments.xprof_probe [--device D] [--quick]

Counterpart of the reference's experiments/xprof_probe.py (the XLA
op-level profile of the order-free and linked kernels).  Each kind runs
a few batches under ``torch.profiler`` through ``tools/trace_capture.py``'s
profiler and trace summary: the device events, busy ms by kernel name,
the window's wall ms, and the busy share (busy ms over the window).
"""

from __future__ import annotations

import sys
import time

from tigerbeetle_tpu_torch.experiments import common
from tigerbeetle_tpu_torch.state_machine import device_kernels as dk
from tigerbeetle_tpu_torch.tools import trace_capture

KEYS = ("orderfree_lo", "linked")


def profile_kind(dev, kind: str, batches: int) -> dict:
    rows = common.link_rows(dev)
    stack = common.upload(common.probe_stack(kind, rows, 2), dev)
    table, meta, ring = common.tables(rows, dev)
    scratch = common.scratch_for(kind, rows, dev)
    launch = dk.KERNELS[kind]
    launch(table, meta, ring, 0, stack[0], common.N, 1 << 40, scratch=scratch)  # warm
    common.sync(dev)
    with trace_capture._profile() as prof:
        t_enter = time.perf_counter()
        for k in range(batches):
            launch(table, meta, ring, k % common.RING_ROWS, stack[k % 2], common.N, 1 << 40,
                   scratch=scratch)
        common.sync(dev)
        t_exit = time.perf_counter()
    out = trace_capture._summary(prof, t_enter, t_exit)
    busy = sum(out["ms_by_name"].values())
    out["busy_share"] = busy / out["window_ms"] if out["window_ms"] else None
    out["batches"] = batches
    return out


def run(dev, quick: bool = False) -> dict:
    batches = 4 if quick else 32
    return common.record("xprof", dev, orderfree_lo=profile_kind(dev, "orderfree_lo", batches),
                         linked=profile_kind(dev, "linked", batches))


main = common.link_main(__doc__, run)

if __name__ == "__main__":
    sys.exit(main())

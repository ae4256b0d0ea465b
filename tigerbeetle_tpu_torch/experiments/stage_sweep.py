"""Superbatch depth G (one pageable upload per G batches) against ring
fetch cadence R, with orderfree_lo_staged: µs per batch and events/s.

    python -m tigerbeetle_tpu_torch.experiments.stage_sweep [--device D] [--rows A] [--reps K]

Counterpart of the reference's experiments/stage_sweep.py: for (G, R)
in (8, 128), (16, 128), (32, 128), (64, 128), (32, 64), (64, 64), K R
timed batches on ring rows 0..R-1 in turn, the ring fetched to the host
after every R of them (and once at the end if a cycle is open).
"""
# tbcheck: allow-file(no-print): a command-line probe — the lines it
# prints on stdout are its output.

from __future__ import annotations

import sys

from tigerbeetle_tpu_torch.experiments import common
from tigerbeetle_tpu_torch.state_machine import device_kernels as dk

KIND = "orderfree_lo"
SWEEP = ((8, 128), (16, 128), (32, 128), (64, 128), (32, 64), (64, 64))


def staged_run(args, dev, G, R, label, drain_first=False):
    """K R staged batches, a fresh upload every G (after draining the
    stream first when `drain_first` and no fetch just drained it), the
    ring fetched every R.  Returns (seconds, batches, tape)."""
    buf = common.superbatch(KIND, args.rows, G)
    scratch = common.scratch_for(KIND, args.rows, dev)
    kern = dk.orderfree_lo_staged
    table, meta, ring = common.tables(args.rows, dev)
    tape = common.Tape(label, table, meta, ring)
    sup = common.upload(buf, dev)
    kern(table, meta, ring, 0, sup, 0, common.N, 1, scratch=scratch)
    tape.staged(KIND, 0, sup, 0, common.N, 1)
    K = args.reps * R
    ops = []
    with common.Clock(dev) as clock:
        k = 0
        for i in range(K):
            if i % G == 0:
                if drain_first and i % R != 0:
                    common.sync(dev)
                sup = common.upload(buf, dev)
            kern(table, meta, ring, k, sup, i % G, common.N, 1, scratch=scratch)
            ops.append((k, sup, i % G))
            k += 1
            if k == R:
                ring.cpu()
                k = 0
        if k:
            ring.cpu()
    for at, s, g in ops:
        tape.staged(KIND, at, s, g, common.N, 1)
    tape.close(table, ring)
    return clock.seconds, K, tape


def run(args, dev) -> list:
    tapes = []
    for G, R in SWEEP:
        seconds, K, tape = staged_run(args, dev, G, R, f"G={G} R={R}")
        print(common.rate(f"G={G:2d} R={R:3d}", seconds, K), flush=True)
        tapes.append(tape)
    return tapes


REPS = 2  # the reference probe's own count
main = common.main_of(__doc__, REPS, run)

if __name__ == "__main__":
    sys.exit(main())

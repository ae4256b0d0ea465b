"""One resident batch per launcher call for the non-staged kinds: µs
per batch and events/s, the host synced only at the end.

    python -m tigerbeetle_tpu_torch.experiments.kernel_time_probe2 \
        [--device D] [--rows A] [--reps K]

Counterpart of the reference's experiments/kernel_time_probe2.py
(orderfree_lo, linked, linked_small and two_phase_lo, one jitted call
per batch): ``scan_of(kind, 1)`` on the kind's probe batch (chains of 4
for the linked kinds), one warm-up call, then 32 K timed calls on ring
rows k % 256.
"""
# tbcheck: allow-file(no-print): a command-line probe — the lines it
# prints on stdout are its output.

from __future__ import annotations

import sys

import numpy as np

from tigerbeetle_tpu_torch.experiments import common
from tigerbeetle_tpu_torch.state_machine import device_kernels as dk

KINDS = ("orderfree_lo", "linked", "linked_small", "two_phase_lo")


def run(args, dev) -> list:
    tapes = []
    ns = np.full(1, common.N, np.int64)
    tsb = np.ones(1, np.uint64)
    for kind in KINDS:
        stack = common.upload(common.probe_stack(kind, args.rows, 1), dev)
        scratch = common.scratch_for(kind, args.rows, dev)
        one = dk.scan_of(kind, 1)
        table, meta, ring = common.tables(args.rows, dev)
        tape = common.Tape(kind, table, meta, ring)
        one(table, meta, ring, 0, stack, ns, tsb, scratch=scratch)
        tape.scan(kind, 0, stack, ns, tsb, 1)
        K = 32 * args.reps
        with common.Clock(dev) as clock:
            for k in range(K):
                one(table, meta, ring, k % 256, stack, ns, tsb, scratch=scratch)
        for k in range(K):
            tape.scan(kind, k % 256, stack, ns, tsb, 1)
        tape.close(table, ring)
        print(common.rate(f"{kind:14s}", clock.seconds, K), flush=True)
        tapes.append(tape)
    return tapes


REPS = 1  # the reference probe's own count
main = common.main_of(__doc__, REPS, run)

if __name__ == "__main__":
    sys.exit(main())

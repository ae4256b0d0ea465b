"""scan_of at G = 16 for three kinds: µs per batch and events/s.

    python -m tigerbeetle_tpu_torch.experiments.scan_kinds_probe [--device D] [--rows A] [--reps K]

Counterpart of the reference's experiments/scan_kinds_probe.py
(``scan_kernels[kind][16]`` for orderfree_lo, linked_small and
two_phase_lo): for each kind, one warm-up launcher call, then K timed
calls of 16 batches back to back from a resident (16, B, C) stack, with
no host sync between them; ring rows (k * 16) % 128 onward.
"""

from __future__ import annotations

import sys

import numpy as np

from tigerbeetle_tpu_torch.experiments import common
from tigerbeetle_tpu_torch.state_machine import device_kernels as dk

KINDS = ("orderfree_lo", "linked_small", "two_phase_lo")
G = 16


def run(args, dev) -> list:
    tapes = []
    for kind in KINDS:
        table, meta, ring = common.tables(args.rows, dev)
        stack = common.upload(common.probe_stack(kind, args.rows, G), dev)
        ns = np.full(G, common.N, np.int64)
        tsb = np.arange(G, dtype=np.uint64)
        scan = dk.scan_kernels[kind][G]
        scratch = common.scratch_for(kind, args.rows, dev)
        tape = common.Tape(f"{kind} scan{G}", table, meta, ring)
        scan(table, meta, ring, 0, stack, ns, tsb, scratch=scratch)
        tape.scan(kind, 0, stack, ns, tsb, G)
        with common.Clock(dev) as clock:
            for k in range(args.reps):
                scan(table, meta, ring, (k * G) % 128, stack, ns, tsb, scratch=scratch)
        for k in range(args.reps):
            tape.scan(kind, (k * G) % 128, stack, ns, tsb, G)
        tape.close(table, ring)
        print(common.rate(f"{kind:14s} scan{G}", clock.seconds, args.reps * G), flush=True)
        tapes.append(tape)
    return tapes


REPS = 4  # the reference probe's own count
main = common.main_of(__doc__, REPS, run)

if __name__ == "__main__":
    sys.exit(main())

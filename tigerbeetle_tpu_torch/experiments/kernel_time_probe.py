"""The staged launchers with a resident superbatch: µs per batch and
events/s for four kinds, the host synced only at the end.

    python -m tigerbeetle_tpu_torch.experiments.kernel_time_probe [--device D] [--rows A] [--reps K]

Counterpart of the reference's experiments/kernel_time_probe.py:
orderfree_lo_staged, orderfree_staged, linked_staged and
two_phase_lo_staged, each on its kind's probe batches (chains of 4 for
linked) in a G = 8 superbatch uploaded once; one warm-up call, then
32 K timed calls on batches k % 8 and ring rows k % 256.
"""

from __future__ import annotations

import sys

from tigerbeetle_tpu_torch.experiments import common
from tigerbeetle_tpu_torch.state_machine import device_kernels as dk

NAMES = ("orderfree_lo_staged", "orderfree_staged", "linked_staged", "two_phase_lo_staged")
G = 8


def run(args, dev) -> list:
    tapes = []
    for name in NAMES:
        kind = dk.STAGED[name]
        kern = getattr(dk, name)
        sup = common.upload(common.superbatch(kind, args.rows, G), dev)
        scratch = common.scratch_for(kind, args.rows, dev)
        table, meta, ring = common.tables(args.rows, dev)
        tape = common.Tape(name, table, meta, ring)
        kern(table, meta, ring, 0, sup, 0, common.N, 1, scratch=scratch)
        tape.staged(kind, 0, sup, 0, common.N, 1)
        K = 32 * args.reps
        with common.Clock(dev) as clock:
            for k in range(K):
                kern(table, meta, ring, k % 256, sup, k % G, common.N, 1, scratch=scratch)
        for k in range(K):
            tape.staged(kind, k % 256, sup, k % G, common.N, 1)
        tape.close(table, ring)
        print(common.rate(name, clock.seconds, K), flush=True)
        tapes.append(tape)
    return tapes


REPS = 1  # the reference probe's own count
main = common.main_of(__doc__, REPS, run)

if __name__ == "__main__":
    sys.exit(main())

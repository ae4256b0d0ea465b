"""Ring fetch cadence R at superbatch depth G = 8, with and without a
drain of the stream before each upload: µs per batch and events/s.

    python -m tigerbeetle_tpu_torch.experiments.staged_prod_probe [--device D] [--rows A] [--reps K]

Counterpart of the reference's experiments/staged_prod_probe.py: for
(R, drain first) in (64, no), (64, yes), (128, yes), (32, yes), K R
timed orderfree_lo_staged batches, as stage_sweep runs them.
"""
# tbcheck: allow-file(no-print): a command-line probe — the lines it
# prints on stdout are its output.

from __future__ import annotations

import sys

from tigerbeetle_tpu_torch.experiments import common
from tigerbeetle_tpu_torch.experiments.stage_sweep import staged_run

G = 8
CASES = ((64, False), (64, True), (128, True), (32, True))


def run(args, dev) -> list:
    tapes = []
    for R, drain_first in CASES:
        label = f"R={R} drain_first={drain_first}"
        seconds, K, tape = staged_run(args, dev, G, R, label, drain_first)
        print(common.rate(label, seconds, K), flush=True)
        tapes.append(tape)
    return tapes


REPS = 2  # the reference probe's own count
main = common.main_of(__doc__, REPS, run)

if __name__ == "__main__":
    sys.exit(main())

"""K1's cost by stage, from the stage stamps of one stamped launch.

    python -m tigerbeetle_tpu_torch.experiments.ablate_probe [--device D] [--quick]

Counterpart of the reference's experiments/ablate_probe.py, which timed
the order-free kernel with its ladder, accumulation and summary cut
out one at a time.  The port's K1 is one cooperative launch whose
stages are separated by grid barriers, and it carries ``clock64()``
stamps between them (``kernels.orderfree(..., stamps=)``); this probe
calls ``tools/serial_probes.py``'s K1 sweep (no second copy of it) on
its "tight" case (chip_smoke.py's shape; ``--quick``) or on all three:
cycles by stage (block 0 and the slowest block), device µs a call, the
kernels a call launches.  On the CPU there are no stamps: the record
names the stages and holds no figure.
"""

from __future__ import annotations

import itertools
import sys

from tigerbeetle_tpu_torch.experiments import common
from tigerbeetle_tpu_torch.tools import serial_probes

KEYS = ("stages", "cases")


def run(dev, quick: bool = False) -> dict:
    stages = list(serial_probes.K1_STAGES)
    if dev.type != "cuda":
        return common.record("ablate", dev, stages=stages, cases=None,
                             note="stage stamps need the card")
    cases = list(itertools.islice(serial_probes.k1_cases(), 1 if quick else 3))
    sweep = serial_probes.k1_sweep(dev, cases=cases)
    out = {}
    for name, *_ in cases:
        row = sweep[name]
        out[name] = {"device_us": row["device_us"], "kernels_per_call": row["kernels_per_call"],
                     "plain_equal": row["plain_equal"],
                     "stage_cycles": {s: float(v) for s, v in row["stage_cycles"].items()},
                     "stage_cycles_max": {s: float(v)
                                          for s, v in row["stage_cycles_max"].items()},
                     "stamped_us": float(row["stamped_us"])}
    return common.record("ablate", dev, stages=stages, cases=out,
                         sm_clock_khz=sweep["sm_clock_khz"])


main = common.link_main(__doc__, run)

if __name__ == "__main__":
    sys.exit(main())

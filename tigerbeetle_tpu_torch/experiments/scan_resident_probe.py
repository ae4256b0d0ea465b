"""scan_of at G = 8, 16, 32 from resident stacks, against one batch per
call with a sync after each: µs per batch and events/s.

    python -m tigerbeetle_tpu_torch.experiments.scan_resident_probe [--device D] [--rows A] [--reps K]

Counterpart of the reference's experiments/scan_resident_probe.py (its
inline ``lax.scan`` over ``_orderfree`` with lo_only): for each G, one
warm-up call, then max(2, 64 K / G) timed calls of G orderfree_lo
batches back to back (ts_base = g * n), no host sync between them;
then 64 K single-batch calls (``scan_of(kind, 1)``), each followed by a
sync, over the G = 8 stack.
"""

from __future__ import annotations

import sys

import numpy as np

from tigerbeetle_tpu_torch.experiments import common
from tigerbeetle_tpu_torch.state_machine import device_kernels as dk

KIND = "orderfree_lo"
SIZES = (8, 16, 32)


def run(args, dev) -> list:
    tapes, per = [], {}
    scratch = common.scratch_for(KIND, args.rows, dev)
    stacks = {}
    for G in SIZES:
        table, meta, ring = common.tables(args.rows, dev)
        stacks[G] = stack = common.upload(common.probe_stack(KIND, args.rows, G), dev)
        ns = np.full(G, common.N, np.int64)
        tsb = np.arange(G, dtype=np.uint64) * np.uint64(common.N)
        scan = dk.scan_of(KIND, G)
        tape = common.Tape(f"scan G={G}", table, meta, ring)
        scan(table, meta, ring, 0, stack, ns, tsb, scratch=scratch)
        tape.scan(KIND, 0, stack, ns, tsb, G)
        K = max(2, 64 * args.reps // G)
        with common.Clock(dev) as clock:
            for k in range(K):
                scan(table, meta, ring, (k * G) % 128, stack, ns, tsb, scratch=scratch)
        for k in range(K):
            tape.scan(KIND, (k * G) % 128, stack, ns, tsb, G)
        tape.close(table, ring)
        per[G] = clock.seconds / (K * G)
        print(common.rate(f"scan G={G:2d}", clock.seconds, K * G), flush=True)
        tapes.append(tape)

    G = SIZES[0]
    stack = stacks[G]
    ns = np.full(G, common.N, np.int64)
    tsb = np.arange(G, dtype=np.uint64) * np.uint64(common.N)
    table, meta, ring = common.tables(args.rows, dev)
    solo = dk.scan_of(KIND, 1)
    tape = common.Tape("solo + sync", table, meta, ring)
    K = 64 * args.reps
    with common.Clock(dev) as clock:
        for k in range(K):
            j = k % G
            solo(table, meta, ring, k % 256, stack[j:j + 1], ns[:1], tsb[j:j + 1],
                 scratch=scratch)
            common.sync(dev)
    for k in range(K):
        j = k % G
        tape.scan(KIND, k % 256, stack[j:j + 1], ns[:1], tsb[j:j + 1], 1)
    tape.close(table, ring)
    one = clock.seconds / K
    print(common.rate("solo + sync", clock.seconds, K), flush=True)
    print("scan saves per batch against solo + sync: "
          + ", ".join(f"G={g} {(one - p) * 1e6:.1f} us" for g, p in per.items()), flush=True)
    tapes.append(tape)
    return tapes


REPS = 1  # the reference probe's own count
main = common.main_of(__doc__, REPS, run)

if __name__ == "__main__":
    sys.exit(main())

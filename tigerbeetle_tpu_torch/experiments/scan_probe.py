"""(a) The engine pattern: one staged batch per call, a fresh pageable
upload of the superbatch every G batches; (b) scan_of over the
superbatch, G batches per call.  µs per batch and events/s.

    python -m tigerbeetle_tpu_torch.experiments.scan_probe [--device D] [--rows A] [--reps K]

Counterpart of the reference's experiments/scan_probe.py, at G = 8 and
64 K batches in each arm: (a) ``orderfree_lo_staged`` on ring rows
k % 256; (b) ``scan_of("orderfree_lo", 8)`` on the superbatch viewed
as a (G, B, C) stack (no copy), uploaded afresh before each call, ring
rows (k * G) % 128.  Each arm ends by fetching the ring to the host.
"""
# tbcheck: allow-file(no-print): a command-line probe — the lines it
# prints on stdout are its output.

from __future__ import annotations

import sys

import numpy as np

from tigerbeetle_tpu_torch.experiments import common
from tigerbeetle_tpu_torch.state_machine import device_kernels as dk

KIND = "orderfree_lo"
G = 8


def run(args, dev) -> list:
    buf = common.superbatch(KIND, args.rows, G)
    scratch = common.scratch_for(KIND, args.rows, dev)
    K = 64 * args.reps

    # (a) the engine pattern.
    table, meta, ring = common.tables(args.rows, dev)
    kern = dk.orderfree_lo_staged
    tape_a = common.Tape("engine pattern", table, meta, ring)
    sup = common.upload(buf, dev)
    kern(table, meta, ring, 0, sup, 0, common.N, 1, scratch=scratch)
    tape_a.staged(KIND, 0, sup, 0, common.N, 1)
    sups = []
    with common.Clock(dev) as clock:
        for k in range(K):
            if k % G == 0:
                sup = common.upload(buf, dev)
                sups.append(sup)
            kern(table, meta, ring, k % 256, sup, k % G, common.N, 1, scratch=scratch)
        ring.cpu()
    for k in range(K):
        tape_a.staged(KIND, k % 256, sups[k // G], k % G, common.N, 1)
    tape_a.close(table, ring)
    print(common.rate("engine pattern", clock.seconds, K), flush=True)

    # (b) G batches per call over the superbatch.
    table, meta, ring = common.tables(args.rows, dev)
    scan = dk.scan_of(KIND, G)
    ns = np.full(G, common.N, np.int64)
    tsb = np.arange(G, dtype=np.uint64)
    tape_b = common.Tape(f"scan-G={G}", table, meta, ring)
    sup = common.upload(buf, dev).view(G, -1, buf.shape[1])
    scan(table, meta, ring, 0, sup, ns, tsb, scratch=scratch)
    tape_b.scan(KIND, 0, sup, ns, tsb, G)
    sups = []
    with common.Clock(dev) as clock:
        for k in range(K // G):
            sup = common.upload(buf, dev).view(G, -1, buf.shape[1])
            sups.append(sup)
            scan(table, meta, ring, (k * G) % 128, sup, ns, tsb, scratch=scratch)
        ring.cpu()
    for k, sup in enumerate(sups):
        tape_b.scan(KIND, (k * G) % 128, sup, ns, tsb, G)
    tape_b.close(table, ring)
    print(common.rate(f"scan-G={G}", clock.seconds, K), flush=True)
    return [tape_a, tape_b]


REPS = 1  # the reference probe's own count
main = common.main_of(__doc__, REPS, run)

if __name__ == "__main__":
    sys.exit(main())

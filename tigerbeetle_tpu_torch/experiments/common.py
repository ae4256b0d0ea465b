"""What every probe shares: its arguments, the probe batch, the tables,
the timing, and the final check against a batch-by-batch run.

The probe batch is the reference probes' (``pack_base`` of B transfers
drawn from ``default_rng``, amounts in [1, 100), ids 1..n, ledger and
code 1), for each packed-input spec; its debit slots spread over the
whole table (the reference draws them from 1,000 rows of a 4,096-row
table), so a batch touches as many rows at 2^20 rows as the
device engine's simple stream does.  Batch g of a stack or superbatch
is drawn from seed + g, so a launch that read the wrong batch would
not pass the final check.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from tigerbeetle_tpu_torch.device import resolve_device
from tigerbeetle_tpu_torch.state_machine import device_kernels as dk

ROWS = 1 << 20  # the port's real table size (chip_smoke.A_ROWS)
RING_ROWS = 256
# Events per probe batch: the wire maximum, or the whole bucket below it.
N = min(dk.B, 8190)


def parser(doc: str, reps: int) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card; 'cpu' runs the "
                        "plain versions)")
    p.add_argument("--rows", type=int, default=ROWS, help="balance table rows")
    p.add_argument("--reps", type=int, default=reps, help="timed repetitions")
    return p


def device_of(args) -> torch.device:
    return resolve_device(args.device)


def card_line(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if dev.type != "cuda":
        return f"device {dev} (no card)"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         f"--id={dev.index}"],
        capture_output=True, text=True, timeout=30,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def probe_batch(kind: str, rows: int, seed: int = 0) -> np.ndarray:
    """One (B, C) host batch in `kind`'s packed layout (dk.PK_SPEC):
    transfers between slot d and d + 1; the linked kinds' chains are
    4 events long, as the reference's probes draw them."""
    if rows < 2:
        raise ValueError("a probe table needs at least 2 rows")
    rng = np.random.default_rng(seed)
    n = N
    dr = rng.integers(0, rows - 1, n)
    cr = dr + 1
    z64, z32 = np.zeros(n, np.uint64), np.zeros(n, np.uint32)
    amount = rng.integers(1, 100, n).astype(np.uint64)
    ids = dict(
        id_lo=np.arange(1, n + 1, dtype=np.uint64), id_hi=z64,
        dr_lo=dr.astype(np.uint64) + 1, dr_hi=z64,
        cr_lo=cr.astype(np.uint64) + 1, cr_hi=z64,
        pend_lo=z64, pend_hi=z64,
    )
    common = dict(ledger=np.ones(n, np.uint32), code=np.ones(n, np.uint32),
                  ts_nonzero=np.zeros(n, bool), dr_slot=dr, cr_slot=cr)
    if kind == "orderfree_tight":
        return dk.pack_tight(n, **ids, amount_lo=amount, flags=z32, **common)
    flags = z32
    if kind.startswith("linked"):
        flags = np.ones(n, np.uint32)
        flags[3::4] = 0
    extra = {}
    if kind.startswith("two_phase"):
        extra = dict(p_found=np.zeros(n, bool), p_tgt=np.full(n, -1, np.int64),
                     n_cols=dk.N_COLS_TP)
    return dk.pack_base(n, **ids, amount_lo=amount, amount_hi=z64, flags=flags,
                        timeout=z32, e_found=np.zeros(n, bool), **common, **extra)


def probe_stack(kind: str, rows: int, G: int, seed: int = 0) -> np.ndarray:
    """(G, B, C) host batches, batch g drawn from seed + g."""
    return np.stack([probe_batch(kind, rows, seed + g) for g in range(G)])


def scratch_for(kind: str, rows: int, dev: torch.device):
    """One kernel scratch for a whole probe run (allocated outside the
    timed loop); None on the CPU, where the plain versions take none."""
    if dev.type != "cuda":
        return None
    return dk.new_scratch(dk.FAMILY[kind], rows, dev)


def superbatch(kind: str, rows: int, G: int, seed: int = 0) -> np.ndarray:
    """(G * B, C) host superbatch: probe_stack's batches end to end."""
    stack = probe_stack(kind, rows, G, seed)
    return stack.reshape(G * stack.shape[1], stack.shape[2])


def upload(host: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array as the kernels' tensor on `dev` (u64 -> int64, u32 ->
    int32 lanes): one pageable host-to-device copy on a card."""
    lanes = np.int32 if host.dtype == np.uint32 else np.int64
    return torch.from_numpy(np.ascontiguousarray(host).view(lanes)).to(dev)


def tables(rows: int, dev: torch.device):
    """(table, meta, ring): a zero (rows, 8) balance table, meta of
    flags 1 and ledger 1 (the reference probes' jnp.ones), a zero ring."""
    table = torch.zeros((rows, 8), dtype=torch.int64, device=dev)
    meta = torch.ones((rows, 2), dtype=torch.int32, device=dev)
    ring = torch.zeros((RING_ROWS, dk.SUMMARY_WORDS), dtype=torch.int64, device=dev)
    return table, meta, ring


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def rate(label: str, seconds: float, batches: int) -> str:
    """The probe line: µs per batch and events per second."""
    per = seconds / batches
    return f"{label}: {per * 1e6:.1f} us/batch -> {N / per:,.0f} events/s ({batches} batches)"


class Clock:
    """Host seconds around a timed loop that ends with the device idle."""

    def __init__(self, dev: torch.device) -> None:
        self.dev = dev

    def __enter__(self):
        sync(self.dev)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        sync(self.dev)
        self.seconds = time.perf_counter() - self.t0


class Tape:
    """The launches a probe made on one table, in order, so that
    ``verify`` can replay them one batch per call: each entry is (kind,
    ring row, the batch it must have read, n, ts_base), the batch taken
    by plain indexing of the probe's own stack or superbatch."""

    def __init__(self, label: str, table, meta, ring) -> None:
        self.label = label
        self.meta = meta
        self.table0, self.ring0 = table.clone(), ring.clone()
        self.ops: list = []
        self.table = self.ring = None

    def scan(self, kind, ring_at0, stack, ns, tsb, G) -> None:
        R = self.ring0.shape[0]
        for g in range(G):
            self.ops.append((kind, (ring_at0 + g) % R, stack[g], int(ns[g]), int(tsb[g])))

    def staged(self, kind, ring_at, super_pk, g, n, ts_base) -> None:
        self.ops.append((kind, ring_at, super_pk[g * dk.B:(g + 1) * dk.B], int(n), int(ts_base)))

    def close(self, table, ring) -> None:
        self.table, self.ring = table, ring


def verify(tapes) -> str:
    """Replay every tape one batch per call through the kind's
    single-batch launcher (its kernel on a card, its plain version on
    the CPU) from the tape's starting table and ring; the final table
    and ring must equal the probe's, bit for bit.  A hard check."""
    batches = 0
    for tape in tapes:
        check(tape.table is not None, f"{tape.label}: the tape was never closed")
        table, ring = tape.table0.clone(), tape.ring0.clone()
        scratch = {}
        for kind, ring_at, pk, n, ts_base in tape.ops:
            fam = dk.FAMILY[kind]
            if fam not in scratch and table.device.type == "cuda":
                scratch[fam] = dk.new_scratch(fam, table.shape[0], table.device)
            dk.KERNELS[kind](table, tape.meta, ring, ring_at, pk, n, ts_base,
                             scratch=scratch.get(fam))
        sync(table.device)
        check(torch.equal(table, tape.table) and torch.equal(ring, tape.ring),
              f"{tape.label}: table or ring differs from a batch-by-batch run")
        batches += len(tape.ops)
    return (f"check: {len(tapes)} runs, {batches} batches: table and ring equal a "
            f"batch-by-batch run, bit for bit")


def main_of(doc: str, reps: int, run):
    """A probe's main(argv): print the card line, run the probe (which
    prints its lines and returns its tapes), then verify the tapes."""

    def main(argv=None) -> int:
        args = parser(doc, reps).parse_args(argv)
        dev = device_of(args)
        print(card_line(dev), flush=True)
        tapes = run(args, dev)
        print(verify(tapes), flush=True)
        return 0

    return main

"""Guard-band and repeat check of the hand-written kernels (K1-K14, the
launchers ``scan_of`` and ``staged``): the port's stand-in for
``compute-sanitizer``'s memcheck and racecheck, which do not run on the
machine with the card.

Every buffer a kernel is handed is a view into a larger buffer, with a
guard band of ``GUARD_BYTES`` (a multiple of 256 bytes, so the view keeps
its alignment) before and after it, each band filled with a seeded
pattern.  Two levels put them there:

- the case: every tensor a case builds for the kernel's wrapper (tables,
  meta, packed events, rings, slots, scratch images) comes from an
  `Arena`, on the card or on the CPU;
- the launch (card only): ``install`` replaces each raw binding of
  ``kernels`` by one that copies every tensor argument, and the tensors
  of a scratch object, into guarded views of a fresh arena, launches on
  the views, synchronises, checks the bands and copies the views back.
  So the buffers a wrapper makes itself (outputs, scratch) are guarded
  too.  The launch's copies are what the kernel touches, so on the card
  the case's bands are out of its reach but for those of the buffers in
  `RAW_POINTER_BUFFERS`, which a binding takes as a raw address (the
  ring's row, ``ring_row_ptr``) and the launch cannot copy.

The guard bytes a run reports watched are the bands a kernel's store
could reach: on the CPU every band of the case; on the card every band
of every launch, and the case's bands of `RAW_POINTER_BUFFERS`.

What a run holds a kernel to:

- **stores**: after each launch and a sync every band is unchanged, byte
  for byte; a finding names the kernel, the buffer, the side and the
  first changed byte (negative: before the buffer's first byte);
- **reads**: the same inputs run again under a second pattern, then
  through the plain version on the CPU: the three outputs are equal bit
  for bit (a read of a band changes the output with the pattern);
- **races**: the case built for contention (every event on one row,
  gen_zipf's 100 accounts, K9 at the tag wrap, K2 update owning row A-1,
  K14 at W = 1, 2 and 8) runs `REPEATS` times, every output bit-identical
  to the first.

What it cannot see: a read outside a buffer that lands inside another
guarded buffer (or a band's byte equal under both patterns), a race that
the repeats never expose, and shared-memory hazards that leave no trace
in the output.

On the CPU the wrappers take their plain versions, so a run there checks
the cases and the harness (tests/test_torch_memsafe.py); on the card,
the kernels.  Run it alone with

    python -m tigerbeetle_tpu_torch.tools.memsafe [--device cuda:0] [--quick]
"""
# tbcheck: allow-file(no-print): main() is a command-line entry — the
# lines it prints on stdout are its output.

from __future__ import annotations

import argparse
import contextlib
import copy
import functools
import json
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from tigerbeetle_tpu_torch import kernels
from tigerbeetle_tpu_torch.parallel import sharded
from tigerbeetle_tpu_torch.state_machine import commitment as cm
from tigerbeetle_tpu_torch.state_machine import device_kernels as dk
from tigerbeetle_tpu_torch.state_machine import kernel as k3
from tigerbeetle_tpu_torch.state_machine import waves
from tigerbeetle_tpu_torch.testing import (
    commit_cases, orderfree_cases, scan_cases, semantic_cases, shard_cases, wave_cases,
)

GUARD_BYTES = 4096
PATTERNS = (1, 2)
REPEATS = 20
MAIN_BATCH = 8190
MAIN_B = 8192  # the main path's batch bucket (device_kernels.B at its default)
SMALL_ROWS = 1 << 12
N_SHARD = 8  # a sharded case's table is split in 8; the case runs one shard
# The raw bindings of kernels that launch a kernel of the port.
BINDINGS = (
    "orderfree", "linked", "two_phase", "commit_hash_all", "commit_update", "commit_admit",
    "tier_set_rows", "checksum", "exact_scan", "apply_deltas", "exact_init", "exact_segment",
    "exact_finalize", "wave_step", "chain_wave", "spec_conflicts", "shard_accumulate",
    "shard_admit", "shard_apply", "shard_gather", "shard_scatter",
)
# The case buffers a binding takes as a raw address, not as a tensor
# (orderfree, linked and two_phase's ``ring_row_ptr``).
RAW_POINTER_BUFFERS = ("ring",)
# A scratch object's tensors (HashScratch, WordScratch).
_SCRATCH_ATTRS = ("words", "slot_idx")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Arena:
    """Guarded copies of tensors on one device, under one pattern."""

    def __init__(self, device, pattern: int, owner: str = "") -> None:
        self.device = torch.device(device)
        self.pattern = pattern
        self.owner = owner
        self.bands: list[tuple[str, str, int, torch.Tensor, torch.Tensor]] = []

    @property
    def watched(self) -> int:
        """Guard bytes of every band."""
        return len(self.bands) * GUARD_BYTES

    def watched_of(self, names) -> int:
        """Guard bytes of the bands of the buffers named in `names`."""
        return sum(GUARD_BYTES for name, *_ in self.bands if name in names)

    def _band(self) -> torch.Tensor:
        rng = np.random.default_rng((self.pattern, len(self.bands)))
        return torch.from_numpy(rng.integers(0, 256, GUARD_BYTES, dtype=np.uint8)).to(
            self.device)

    def put(self, name: str, t, offset: int | None = None) -> torch.Tensor:
        """A guarded copy of `t` (a tensor or a numpy array, contiguous)
        on the arena's device: `offset` bytes past a 256-byte boundary
        (default: the residue of `t`'s own address, so an unaligned
        view stays unaligned)."""
        if isinstance(t, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(t))
        if not t.is_contiguous():
            raise ValueError(f"{name}: a guarded buffer must be contiguous")
        if offset is None:
            offset = t.data_ptr() % 256 if t.device.type == "cuda" else 0
        if offset % t.element_size():
            raise ValueError(f"{name}: offset {offset} splits a {t.dtype} element")
        nbytes = t.numel() * t.element_size()
        buf = torch.empty(2 * GUARD_BYTES + offset + nbytes, dtype=torch.uint8,
                          device=self.device)
        start = GUARD_BYTES + offset
        for side, lo in (("before", start - GUARD_BYTES), ("after", start + nbytes)):
            band = buf[lo:lo + GUARD_BYTES]
            want = self._band()
            band.copy_(want)
            self.bands.append((name, side, nbytes, band, want))
        view = buf[start:start + nbytes].view(t.dtype).view(t.shape)
        view.copy_(t)
        return view

    def check(self) -> list[str]:
        """A finding for each band that changed (the device synced)."""
        _sync(self.device)
        out = []
        for name, side, nbytes, band, want in self.bands:
            if not torch.equal(band, want):
                i = int(torch.nonzero(band != want)[0])
                at = i - GUARD_BYTES if side == "before" else nbytes + i
                out.append(f"{self.owner}: store outside {name}: {side} guard changed at "
                           f"byte {at} of the buffer")
        return out


@dataclass
class Launches:
    """What the guarded raw bindings did: launches, guard bytes watched
    and findings, across every call while installed."""

    pattern: int = PATTERNS[0]
    calls: int = 0
    watched: int = 0
    findings: list = field(default_factory=list)


def _guarded_binding(name: str, real, state: Launches):
    @functools.wraps(real)
    def launch(*args, **kwargs):
        device = next(a.device for a in args if isinstance(a, torch.Tensor))
        arena = Arena(device, state.pattern, owner=f"{name} launch")
        copies = []

        def guard(x, label):
            if isinstance(x, torch.Tensor):
                view = arena.put(label, x)
                copies.append((x, view))
                return view
            if any(isinstance(getattr(x, a, None), torch.Tensor) for a in _SCRATCH_ATTRS):
                twin = copy.copy(x)
                for a in _SCRATCH_ATTRS:
                    t = getattr(x, a, None)
                    if isinstance(t, torch.Tensor):
                        setattr(twin, a, guard(t, f"{label}.{a}"))
                return twin
            return x

        args = [guard(a, f"argument {i}") for i, a in enumerate(args)]
        real(*args, **kwargs)
        state.calls += 1
        state.findings += arena.check()
        state.watched += arena.watched
        for orig, view in copies:
            orig.copy_(view)

    return launch


@contextlib.contextmanager
def install(state: Launches):
    """The raw bindings of `kernels` guarded while the context is open."""
    saved = {name: getattr(kernels, name) for name in BINDINGS}
    try:
        for name, real in saved.items():
            setattr(kernels, name, _guarded_binding(name, real, state))
        yield state
    finally:
        for name, real in saved.items():
            setattr(kernels, name, real)


# ---------------------------------------------------------------------------
# Cases: each a function of an arena's `put` returning the kernel's
# outputs by name; the same function runs on the card (the kernel) and
# on the CPU (the plain version).


def _i64(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.int64)


def _i32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.int32)


def _orderfree_tables(seed, A):
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 1 << 62, (A, 4), dtype=np.int64)
    hi = rng.integers(0, 1 << 40, (A, 4), dtype=np.int64)
    return np.stack([lo, hi], -1).reshape(A, 8), np.ones((A, 2), np.int32)


def _orderfree_batch(seed, B, n, A, kind):
    """(table, meta, pk, mode) of one K1 batch: "spread" random pairs,
    "one_row" every event between rows 0 and 1, "zipf" gen_zipf's 100
    accounts."""
    rng = np.random.default_rng(seed)
    table, meta = _orderfree_tables(seed, A)
    if kind == "one_row":
        dr, cr = np.zeros(n, np.int64), np.ones(n, np.int64)
    elif kind == "zipf":
        dr, cr = orderfree_cases.zipf_slots(n)
    else:
        dr = rng.integers(0, A, n)
        cr = (dr + 1 + rng.integers(0, A - 1, n)) % A
    amount = rng.integers(1, 100, n).astype(np.uint64)
    if kind == "spread":
        pk = orderfree_cases.pack_wide(B, dr, cr, amount)
        return table, meta, _i64(pk), dk.MODE_FULL
    return table, meta, _i32(orderfree_cases.pack_tight(B, dr, cr, amount)), dk.MODE_TIGHT


def orderfree_case(seed, B, n, A, kind):
    table, meta, pk, mode = _orderfree_batch(seed, B, n, A, kind)

    def run(put):
        t, ring = put("table", table), put("ring", np.zeros((8, dk.SUMMARY_WORDS), np.int64))
        dk.orderfree(t, put("meta", meta), ring, 3, put("pk", pk), n, 1 << 40, mode=mode)
        return {"table": t, "ring": ring}

    return run


def _semantic_case(fn, variant, case):
    table, meta, pk, n = case

    def run(put):
        t, ring = put("table", _i64(table)), put("ring", np.zeros((8, dk.SUMMARY_WORDS),
                                                                   np.int64))
        fn(t, put("meta", _i32(meta)), ring, 3, put("pk", _i64(pk)), n, 1 << 40, **variant)
        return {"table": t, "ring": ring}

    return run


def linked_case(seed, B, scenario, small, A=SMALL_ROWS, pool=24):
    return _semantic_case(dk.linked, {"small": small},
                          semantic_cases.linked_case(seed, B, scenario, A=A, pool=pool))


def two_phase_case(seed, B, scenario, lo_only, A=SMALL_ROWS):
    return _semantic_case(dk.two_phase, {"lo_only": lo_only},
                          semantic_cases.two_phase_case(seed, B, scenario, A=A))


def _launcher_batches(kind, G, seed, B=dk.B, A=SMALL_ROWS):
    """(table, meta, (G, B, C) stack, ns, tsb): G batches of `kind` on
    one table, in the format its kernel takes."""
    family = dk.FAMILY[kind]
    if family == "orderfree":
        shape = "spread" if kind == "orderfree" else "zipf"
        batches = [_orderfree_batch(seed + g, B, B - 2, A, shape) for g in range(G)]
        table, meta = batches[0][0], batches[0][1]
        stack = np.stack([b[2] for b in batches])
    else:
        make = semantic_cases.linked_case if family == "linked" else semantic_cases.two_phase_case
        scenario = "passing" if family == "linked" else "mixed"
        batches = [make(seed + g, B, scenario, A=A, n=B - 2) for g in range(G)]
        table, meta = _i64(batches[0][0]), _i32(batches[0][1])
        stack = np.stack([_i64(b[2]) for b in batches])
    ns = np.full(G, B - 2, np.int64)
    tsb = (1 << 40) + np.arange(G, dtype=np.int64) * 10_000
    return table, meta, stack, ns, tsb


def scan_of_case(kind, G, seed):
    table, meta, stack, ns, tsb = _launcher_batches(kind, G, seed)

    def run(put):
        t, ring = put("table", table), put("ring", np.zeros((G + 2, dk.SUMMARY_WORDS), np.int64))
        dk.scan_of(kind, G)(t, put("meta", meta), ring, 1, put("stack", stack), ns, tsb)
        return {"table": t, "ring": ring}

    return run


def staged_case(kind, G, seed):
    table, meta, stack, ns, tsb = _launcher_batches(kind, G, seed)
    superbatch = stack.reshape(G * stack.shape[1], stack.shape[2])

    def run(put):
        t, ring = put("table", table), put("ring", np.zeros((G, dk.SUMMARY_WORDS), np.int64))
        m, sp = put("meta", meta), put("superbatch", superbatch)
        for g in (0, G - 1, -1):
            dk.staged(kind)(t, m, ring, g % G, sp, g, int(ns[g]), int(tsb[g]))
        return {"table": t, "ring": ring}

    return run


def exact_scan_case(seed, B, cls, A, n=None):
    table, ev, dstat, n, ts_base = scan_cases.make_case(seed, B, cls, A=A, n=n)
    pk = _i64(k3.pack_events(ev))

    def run(put):
        t = put("table", _i64(table))
        _, out = k3.run_create_transfers(t, put("events", pk), put("dstat", _i32(dstat)), n,
                                         ts_base)
        return {"table": t, "out": out}

    return run


def _carry(dstat) -> np.ndarray:
    """K3's initial carry image for `dstat` (make_carry, the plain
    version of K3 init)."""
    words = torch.empty(k3.scratch_words(len(dstat)), dtype=torch.int64)
    return k3.make_carry(words, torch.from_numpy(_i32(dstat))).numpy()


def exact_init_case(seed, B, offset):
    rng = np.random.default_rng(seed)
    dstat = rng.integers(-(1 << 31), 1 << 31, B, dtype=np.int64).astype(np.int32)
    stale = rng.integers(-(1 << 62), 1 << 62, k3.scratch_words(B))

    def run(put):
        w = put("carry", stale, offset=offset)
        k3.exact_init(w, put("dstat", dstat))
        return {"carry": w}

    return run


def exact_segment_case(seed, B, cls, A, n=None, rows=None):
    table, ev, dstat, n, ts_base = scan_cases.make_case(seed, B, cls, A=A, n=n, rows=rows)
    pk = _i64(k3.pack_events(ev))
    carry = _carry(dstat)
    order = np.arange(n, dtype=np.int32)
    segs = [order[: n // 3], order[n // 3:]]

    def run(put):
        t, w, p = put("table", _i64(table)), put("carry", carry), put("events", pk)
        for k, seg in enumerate(segs):
            k3.scan_segment(t, p, w, put(f"rows {k}", seg), n, ts_base)
        return {"table": t, "carry": w}

    return run


def exact_finalize_case(seed, B, A, fix, offset=0):
    table, words, hist_fix = wave_cases.finalize_case(seed, B, A, fix)

    def run(put):
        t = put("table", _i64(table))
        w = put("carry", _i64(words), offset=offset)
        hf = None if hist_fix is None else put("hist_fix", hist_fix.astype(np.uint8))
        return {"out": k3.finalize(t, w, B, hf), "table": t}

    return run


def wave_step_case(seed, B, A, K, hub=False, mask_p=None):
    table, ev, dstat, n, ts_base, plan = wave_cases.wide_case(seed, B, A, n=K)
    if hub:
        writers = (np.arange(B) % 5 == 0) & (np.arange(B) < n) & (ev["p_found"] == 0)
        writers &= (ev["flags"] & 0xC) == 0
        ev["cr_slot"][writers] = A - 1
    pk = _i64(k3.pack_events(ev))
    carry = _carry(dstat)
    idx = np.asarray(plan.segments[0][1], np.int32)
    mask = None
    if mask_p is not None:
        mask = (np.random.default_rng(seed).random(len(idx)) < mask_p).astype(np.uint8)

    def run(put):
        t, w = put("table", _i64(table)), put("carry", carry)
        waves.wave_step(t, put("events", pk), w, put("idx", idx), n, ts_base,
                        mask=None if mask is None else put("mask", mask))
        return {"table": t, "carry": w}

    return run


def chain_wave_case(seed, n_chains, B, A, max_len):
    table, ev, dstat, n, ts_base, plan = wave_cases.chain_case(
        seed, max(n_chains, 40), B, A=A, max_len=max_len)
    P = plan.chain_steps[0]
    plane = waves._chain_plane(ev["flags"], plan.segments[0][1], max(P, max_len), B)
    plane = np.ascontiguousarray(plane[:P, :n_chains])
    pk = _i64(k3.pack_events(ev))
    carry = _carry(dstat)

    def run(put):
        t, w = put("table", _i64(table)), put("carry", carry)
        waves.chain_wave(t, put("events", pk), w, put("plane", plane), n, ts_base)
        return {"table": t, "carry": w}

    return run


def spec_conflicts_case(seed, B, A, count=1, wrap=False):
    """`count` K9 batches of wave_cases.spec_stream back to back on one
    scratch; `wrap`: the scratch's calls start one before the tag cycle
    ends, so the second call takes tag 1 again and refills."""
    stream = wave_cases.spec_stream(seed, count, B, A)

    def run(put):
        out = {}
        scratch = None
        for j, (ev, n, serial) in enumerate(stream):
            pk = put(f"events {j}", _i64(k3.pack_events(ev)))
            if pk.device.type == "cuda" and scratch is None:
                calls = kernels.spec_conflicts_cycle() - 1 if wrap else 0
                scratch = waves.WaveScratch(pk.device, spec_calls=calls)
            idx = put(f"idx {j}", np.arange(n, dtype=np.int32))
            out[f"flags {j}"] = waves.spec_conflicts(pk, idx, put(f"serial {j}", serial[:n]), n,
                                                     A, scratch=scratch)
        return out

    return run


def commit_rebuild_case(seed, A):
    table, meta = _orderfree_tables(seed, A)

    def run(put):
        rh, dg = cm.rebuild(put("balances", table), put("meta", meta),
                            put("rows", np.arange(A, dtype=np.int64)))
        return {"row_hash": rh, "digest": dg}

    return run


def commit_probe_case(seed, A):
    table, meta = _orderfree_tables(seed, A)
    digest = cm.rebuild_plain(torch.from_numpy(table), torch.from_numpy(meta),
                              torch.arange(A))[1].numpy()

    def run(put):
        got = cm.probe(put("balances", table), put("meta", meta), put("digest", digest),
                       put("rows", np.arange(A, dtype=np.int64)))
        return {"probe": got}

    return run


def commit_update_case(seed, A, slots):
    bal, meta, row_hash, digest, slots, rows = commit_cases.update_case(slots, A, seed)

    def run(put):
        rh, dg = put("row_hash", _i64(row_hash)), put("digest", _i64(digest))
        got = cm.update(put("balances", _i64(bal)), put("meta", _i32(meta)), rh, dg,
                        put("slots", slots), put("rows", _i64(rows)))
        return {"row_hash": got[0], "digest": got[1]}

    return run


def commit_admit_case(seed, H, slots, offset=0):
    row_hash, digest, slots, new_lo, new_hi = commit_cases.admit_case(slots, H, seed)

    def run(put):
        rh = put("row_hash", _i64(row_hash), offset=offset)
        got = cm.admit(rh, put("digest", _i64(digest)), put("slots", slots),
                       put("new_lo", _i64(new_lo)), put("new_hi", _i64(new_hi)))
        return {"row_hash": got[0], "digest": got[1]}

    return run


def apply_deltas_case(seed, A, k, padding=0, offset=0):
    rng = np.random.default_rng(seed)
    table, _ = _orderfree_tables(seed, A)
    keys = rng.choice(A * 4, size=k - padding, replace=False)
    packed = np.zeros((4, k), np.int64)
    packed[0, : len(keys)] = keys // 4
    packed[1, : len(keys)] = keys % 4
    packed[2:, : len(keys)] = rng.integers(-(1 << 62), 1 << 62, (2, len(keys)))
    packed[0, len(keys):] = A + np.arange(padding)

    def run(put):
        t = put("table", table, offset=offset)
        return {"table": dk.apply_deltas(t, put("packed", packed))}

    return run


def tier_set_rows_case(seed, H, k, pad, width, dtype):
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    table = rng.integers(info.min, info.max, (H, width), dtype=dtype)
    src = rng.integers(info.min, info.max, (k + pad, width), dtype=dtype)
    idx = np.concatenate([rng.choice(H, k, replace=False), H + np.arange(pad)]).astype(np.int64)

    def run(put):
        t = put("table", table)
        return {"table": dk.tier_set_rows(t, put("idx", idx), put("src", src))}

    return run


def checksum_case(seed, rows, cols, dtype, row0=0):
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    table = rng.integers(info.min, info.max, (rows, cols), dtype=dtype)

    def run(put):
        return {"digest": dk.checksum(put("table", table), row0)}

    return run


def _shard_inputs(seed, rows, n_events, one_row=False):
    balances, *events = shard_cases.apply_events(seed, rows, n_events, near_ceiling=16)
    if one_row:
        events[0][:] = 5
        events[1][:] = 6
    return balances, events


def _shard_events(put, events):
    dr, cr, lo, hi, pending = events
    return (put("dr", dr.astype(np.int32)), put("cr", cr.astype(np.int32)),
            put("amount_lo", lo.view(np.int64)), put("amount_hi", hi.view(np.int64)),
            put("pending", pending.astype(np.bool_)))


def shard_accumulate_case(seed, rows, n_events, shard, one_row=False, mask=False):
    _, events = _shard_inputs(seed, rows, n_events, one_row)
    local = rows // N_SHARD
    keep = np.random.default_rng(seed).random(n_events) < 0.5

    def run(put):
        ev = _shard_events(put, events)
        m = put("mask", keep) if mask else None
        return {"acc": sharded.accumulate(local, shard * local, *ev, mask=m)}

    return run


def _shard_acc(balances, events, rows, shard):
    local = rows // N_SHARD
    ev = [torch.from_numpy(np.ascontiguousarray(a)) for a in (
        events[0].astype(np.int32), events[1].astype(np.int32), events[2].view(np.int64),
        events[3].view(np.int64), events[4])]
    acc = sharded._accumulate(local, shard * local, *ev).numpy()
    table = balances[shard * local:(shard + 1) * local].view(np.int64)
    return np.ascontiguousarray(table), acc, local


def shard_admit_case(seed, rows, n_events, shard, one_row=False):
    balances, events = _shard_inputs(seed, rows, n_events, one_row)
    table, acc, local = _shard_acc(balances, events, rows, shard)

    def run(put):
        ev = _shard_events(put, events)
        return {"reject": sharded.admit(put("table", table), put("acc", acc), shard * local,
                                        ev[0], ev[1])}

    return run


def shard_apply_case(seed, rows, n_events, shard, one_row=False):
    balances, events = _shard_inputs(seed, rows, n_events, one_row)
    table, acc, _ = _shard_acc(balances, events, rows, shard)

    def run(put):
        t = put("table", table)
        sharded.apply(t, put("acc", acc))
        return {"table": t}

    return run


def shard_gather_case(seed, local, width, shard, k):
    rng = np.random.default_rng(seed)
    table = rng.integers(-(1 << 62), 1 << 62, (local, width))
    slots = np.concatenate([rng.choice(8 * local, k, replace=False), [-1, 8 * local]])

    def run(put):
        return {"rows": sharded.gather_part(put("table", table), put("slots", slots), shard)}

    return run


def shard_scatter_case(seed, local, width, shard, k):
    rng = np.random.default_rng(seed)
    table = rng.integers(-(1 << 62), 1 << 62, (local, width))
    slots = np.concatenate([rng.choice(8 * local, k, replace=False), [-1, 8 * local]])
    new = rng.integers(-(1 << 62), 1 << 62, (k + 2, width))

    def run(put):
        t = put("table", table)
        sharded.scatter_part(t, put("slots", slots), put("rows", new), shard)
        return {"table": t}

    return run


@dataclass
class Row:
    """One row of chip_smoke.py's kernels line: its cases by name, the
    one built for contention (repeated), and those left out of a quick
    run (the main-path batch)."""

    name: str
    cases: dict
    contention: str
    main: tuple = ()


def rows() -> list[Row]:
    """The 24 rows (K1-K14 with their separate entry points, and the
    launchers), each with small cases (a few hundred events, a 2^12-row
    table), a contention case and a main-path batch of 8190 events."""
    A, B, n = SMALL_ROWS, 512, 500
    past = np.concatenate([np.arange(0, A - 1, 7), [A - 1, A, A + 5, -1]]).astype(np.int64)
    main_slots = cm.pad_slots(np.sort(np.random.default_rng(3).choice(
        1 << 15, 2 * MAIN_BATCH, replace=False)).astype(np.int64))
    return [
        Row("orderfree", {
            "spread": orderfree_case(1, B, n, A, "spread"),
            "one_row": orderfree_case(2, B, n, A, "one_row"),
            "zipf": orderfree_case(3, B, n, A, "zipf"),
            "main": orderfree_case(4, MAIN_B, MAIN_BATCH, A, "spread"),
        }, "one_row", ("main",)),
        Row("commit_update", {
            "small": commit_update_case(5, A, cm.pad_slots(np.arange(0, A, 11))),
            "owner_A-1": commit_update_case(6, A, past),
            "main": commit_update_case(7, 1 << 15, main_slots),
        }, "owner_A-1", ("main",)),
        Row("commit_rebuild", {
            "small": commit_rebuild_case(8, A),
            "odd": commit_rebuild_case(83, A + 5),
            "main": commit_rebuild_case(9, 1 << 15),
        }, "small", ("main",)),
        Row("commit_probe", {
            "small": commit_probe_case(10, A),
            "odd": commit_probe_case(84, A + 5),
            "main": commit_probe_case(11, 1 << 15),
        }, "small", ("main",)),
        Row("exact_scan", {
            "mixed": exact_scan_case(12, B, "mixed", A, n),
            "contended": exact_scan_case(13, B, "linked", 24, n),
            "main": exact_scan_case(14, 8192, "mixed", A, MAIN_BATCH),
        }, "contended", ("main",)),
        Row("apply_deltas", {
            "small": apply_deltas_case(15, A, 700, padding=64),
            "unaligned": apply_deltas_case(16, A, 701, padding=3, offset=8),
            "one_row_block": apply_deltas_case(17, 64, 256),
            "main": apply_deltas_case(18, 1 << 15, 4 * MAIN_BATCH, padding=4096),
        }, "one_row_block", ("main",)),
        Row("linked", {
            "limits": linked_case(19, B, "limits", small=False),
            "small_wrapped": linked_case(20, B, "small_wrapped", small=True),
            "contended": linked_case(21, B, "multi_iter", small=False, pool=4),
            "main": linked_case(22, MAIN_B, "passing", small=False),
        }, "contended", ("main",)),
        Row("two_phase", {
            "mixed": two_phase_case(23, B, "mixed", lo_only=False),
            "lo": two_phase_case(24, B, "races", lo_only=True),
            "contended": two_phase_case(25, B, "contended", lo_only=False),
            "main": two_phase_case(26, MAIN_B, "mixed", lo_only=False),
        }, "contended", ("main",)),
        Row("exact_init", {
            "small": exact_init_case(27, B, 0),
            "odd": exact_init_case(28, 4097, 0),
            "unaligned": exact_init_case(29, B, 8),
            "main": exact_init_case(30, 8192, 0),
        }, "small", ("main",)),
        Row("exact_segment", {
            "mixed": exact_segment_case(31, B, "mixed", A, n, rows=np.arange(0, A, 97)),
            "contended": exact_segment_case(32, B, "linked", 24, n),
            "main": exact_segment_case(33, 8192, "mixed", A, MAIN_BATCH,
                                       rows=np.arange(0, A, 3)),
        }, "contended", ("main",)),
        Row("exact_finalize", {
            "some": exact_finalize_case(34, 203, 37, "some"),
            "unaligned": exact_finalize_case(35, 97, 500, "all", offset=8),
            "none": exact_finalize_case(36, B, A, "none"),
            "main": exact_finalize_case(37, 8192, A, "some"),
        }, "some", ("main",)),
        Row("wave_step", {
            "small": wave_step_case(38, 8192, A, 300),
            "hub": wave_step_case(39, 8192, A, 513, hub=True),
            "masked": wave_step_case(40, 8192, A, 400, mask_p=0.5),
            "main": wave_step_case(41, 8192, 1 << 15, MAIN_BATCH),
        }, "hub", ("main",)),
        Row("chain_wave", {
            "small": chain_wave_case(42, 40, 8192, A, 7),
            "hubs": chain_wave_case(43, 300, 8192, A, 3),
            "main": chain_wave_case(44, 2048, 8192, 1 << 15, 4),
        }, "hubs", ("main",)),
        Row("spec_conflicts", {
            "stream": spec_conflicts_case(45, B, 61, count=3),
            "tag_wrap": spec_conflicts_case(46, B, 61, count=2, wrap=True),
            "main": spec_conflicts_case(47, 8192, A, count=1),
        }, "tag_wrap", ("main",)),
        Row("tier_set_rows", {
            "w8": tier_set_rows_case(48, A, 300, 64, 8, np.int64),
            "w2": tier_set_rows_case(49, A, 300, 64, 2, np.int32),
            "main": tier_set_rows_case(50, 1 << 15, 16_384 - 64, 64, 8, np.int64),
        }, "w8", ("main",)),
        Row("commit_admit", {
            "small": commit_admit_case(51, A, cm.pad_slots(np.arange(3, A, 13))),
            "owner_H-1": commit_admit_case(52, A, past),
            "unaligned": commit_admit_case(53, A, cm.pad_slots(np.arange(1, A, 29)), offset=8),
            "main": commit_admit_case(54, 1 << 15, cm.pad_slots(np.arange(0, 1 << 15, 2))),
        }, "owner_H-1", ("main",)),
        Row("checksum", {
            "balances": checksum_case(55, A, 8, np.int64),
            "meta": checksum_case(56, A + 3, 2, np.int32),
            "shard": checksum_case(57, A // 4, 8, np.int64, row0=A // 4),
            "main": checksum_case(58, 1 << 15, 8, np.int64),
        }, "balances", ("main",)),
        Row("shard_accumulate", {
            "small": shard_accumulate_case(59, A, n, 3),
            "masked": shard_accumulate_case(60, A, n, 0, mask=True),
            "one_row": shard_accumulate_case(61, A, n, 0, one_row=True),
            "main": shard_accumulate_case(62, A, MAIN_BATCH, 5),
        }, "one_row", ("main",)),
        Row("shard_admit", {
            "small": shard_admit_case(63, A, n, 3),
            "one_row": shard_admit_case(64, A, n, 0, one_row=True),
            "main": shard_admit_case(65, A, MAIN_BATCH, 5),
        }, "one_row", ("main",)),
        Row("shard_apply", {
            "small": shard_apply_case(66, A, n, 3),
            "one_row": shard_apply_case(67, A, n, 0, one_row=True),
            "main": shard_apply_case(68, A, MAIN_BATCH, 5),
        }, "one_row", ("main",)),
        Row("shard_gather", {
            "w1": shard_gather_case(69, 1 << 9, 1, 3, 300),
            "w2": shard_gather_case(70, 1 << 9, 2, 3, 300),
            "w8": shard_gather_case(71, 1 << 9, 8, 3, 300),
            "main": shard_gather_case(72, A, 8, 2, MAIN_BATCH),
        }, "w2", ("main",)),
        Row("shard_scatter", {
            "w1": shard_scatter_case(73, 1 << 9, 1, 3, 300),
            "w2": shard_scatter_case(74, 1 << 9, 2, 3, 300),
            "w8": shard_scatter_case(75, 1 << 9, 8, 3, 300),
            "main": shard_scatter_case(76, A, 8, 2, MAIN_BATCH),
        }, "w8", ("main",)),
        Row("scan_of", {
            "orderfree_tight": scan_of_case("orderfree_tight", 3, 77),
            "linked": scan_of_case("linked", 2, 78),
            "two_phase_lo": scan_of_case("two_phase_lo", 2, 79),
        }, "orderfree_tight"),
        Row("staged", {
            "orderfree": staged_case("orderfree", 3, 80),
            "linked_small": staged_case("linked_small", 2, 81),
            "two_phase": staged_case("two_phase", 2, 82),
        }, "orderfree"),
    ]


# ---------------------------------------------------------------------------
# The harness.


@dataclass
class Result:
    """One row's run: launches, guard bytes watched, repeats, findings."""

    name: str
    launches: int = 0
    watched: int = 0
    repeats: int = 0
    cases: int = 0
    findings: list = field(default_factory=list)
    seconds: float = 0.0

    @property
    def verdict(self) -> str:
        return "clean" if not self.findings else "; ".join(self.findings[:3])

    def line(self) -> str:
        return (f"memsafe {self.name}: {self.launches} launches, {self.cases} cases, "
                f"{self.watched} guard bytes watched, {self.repeats} repeats, "
                f"{self.seconds:.1f} s: {self.verdict}")

    def record(self) -> dict:
        return {"verdict": "clean" if not self.findings else "finding",
                "launches": self.launches, "guard_bytes": self.watched,
                "repeats": self.repeats, "findings": self.findings[:10]}


def run_once(name: str, case, device, pattern: int, state: Launches | None = None):
    """One run of `case` on `device` under `pattern`: (outputs on the
    CPU, findings, guard bytes of the case's bands a kernel could reach).
    With `state`, the raw bindings are guarded (the card): the launches'
    bands are counted in `state`, and of the case's only those of
    `RAW_POINTER_BUFFERS`."""
    arena = Arena(device, pattern, owner=name)
    guard = install(state) if state is not None else contextlib.nullcontext()
    if state is not None:
        state.pattern = pattern
    with guard:
        outs = case(arena.put)
        _sync(arena.device)
    findings = arena.check()
    watched = arena.watched if state is None else arena.watched_of(RAW_POINTER_BUFFERS)
    return {k: v.detach().cpu().clone() for k, v in outs.items()}, findings, watched


def _diff(name, what, got: dict, want: dict) -> list[str]:
    out = []
    for key, w in want.items():
        g = got.get(key)
        if g is None or g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
            out.append(f"{name}: {what}: {key} differs")
    return out


def check_row(row: Row, device, repeats: int = REPEATS, quick: bool = False) -> Result:
    """Stores, reads and races of one row on `device` (see the module's
    docstring); `quick` leaves out the main-path batch.  On a card the
    runs are held to the plain version on the CPU as well."""
    device = torch.device(device)
    res = Result(row.name)
    t0 = time.perf_counter()
    state = Launches() if device.type == "cuda" else None
    for cname, case in row.cases.items():
        if quick and cname in row.main:
            continue
        label = f"{row.name}[{cname}]"
        res.cases += 1
        first, found, watched = run_once(label, case, device, PATTERNS[0], state)
        res.findings += found
        res.watched += watched
        second, found, watched = run_once(label, case, device, PATTERNS[1], state)
        res.findings += found + _diff(label, "second guard pattern", second, first)
        res.watched += watched
        if device.type != "cpu":
            want, _, _ = run_once(label, case, "cpu", PATTERNS[0])
            res.findings += _diff(label, "plain version", first, want)
        if cname == row.contention:
            for k in range(repeats):
                again, found, watched = run_once(label, case, device, PATTERNS[k % 2], state)
                res.findings += found + _diff(label, f"repeat {k + 1}", again, first)
                res.watched += watched
                res.repeats += 1
    if state is not None:
        res.launches = state.calls
        res.watched += state.watched
        res.findings = state.findings + res.findings
    res.seconds = time.perf_counter() - t0
    return res


def check_all(device, quick: bool = False, echo=print) -> list[Result]:
    out = []
    for row in rows():
        res = check_row(row, device, quick=quick)
        echo(res.line())
        out.append(res)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--quick", action="store_true", help="leave out the main-path batches")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("memsafe: no CUDA card (pass --device cpu to check the plain versions)")
    results = check_all(device, args.quick)
    print(json.dumps({r.name: r.record() for r in results}))
    return 0 if all(not r.findings for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())

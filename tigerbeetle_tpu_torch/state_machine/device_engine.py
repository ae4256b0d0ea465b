"""Device-authoritative execution pipeline for create_transfers.

Counterpart of ``tigerbeetle_tpu/state_machine/device_engine.py``.
The engine owns the authoritative device tables — balances (A, 8)
int64 (u64 lanes), account meta (A, 2) int32 (flags, ledger) — and a
stream of semantic batches of three classes: order-free (kernel K1),
linked-chain (K5) and two-phase (K6), each kind launched by its own
kernel (``device_kernels.KERNELS``).  The host submits packed batches
and gets back reply futures; result codes are computed on the device,
ride the failure-sparse summary ring, and materialize once per
execution window:

  submit()  appends the packed batch to a host-side window; nothing
            is launched until the window fills (TB_DEV_WINDOW).
  rotate    at the window boundary: (1) fetch the summary ring of the
            PREVIOUS window (the one synchronisation per window); (2)
            upload the new window's batches in one copy per input
            layout; (3) launch every batch of the new window back to
            back on one stream, then one commitment update (K2) over
            the window's touched rows; (4) only then run the previous
            window's host bookkeeping, overlapped with the device.

A batch whose summary carries a flag (balance overflow in play, more
failures than the summary holds, or a linked kernel's precondition or
fixpoint cap) triggers exact recovery before the
next window launches: the batch is re-executed exactly against the
mirror's image (the exact scan K3 runs on a card tensor built from it),
the table is re-uploaded from the mirror (K2 rebuild), and every later
batch of the window is launched again with its own kind's kernel.

Batches outside the semantic kernels' classes ride the window too,
as wave records (``submit_waves``: a wave plan's segments, kernels K7,
K8 and K3 segments) or speculative records (``submit_speculative``: the
whole batch as one K7 step behind K9's on-device validation, only the
conflicted residue replayed through a plan) — executed in window order
against the device table, their packed outputs fetched at rotation.
Admission against the mirror plus every in-flight record's amount
bound (``inflight_bound``) proves their plans exact, so they carry no
failure flag.  A batch the wave router declines takes the host path: the
machine drains the stream, then resolves the batch exactly against the
table read through ``read()`` (a drain and flush barrier).  Order-free
ones apply through the write-behind lane (``enqueue`` / ``flush``: K4
modular adds, then one K2 update over the written rows); the rest run
the exact scan K3 on the table in place, after which the machine
refreshes the device digest over every row K3 could have written
(``exact_written``).  Pending expiry's releases ride the write-behind
lane too.

Hot/cold tiering (``hot_tier.py``, TB_HOT_CAPACITY): the device
tables (balances, meta, row hashes, every kernel scratch) then hold
only the hot rows, and the mirror plus ``_meta_host`` are the whole
logical table.  The machine prefetches a batch's logical touched set
(``tier_prefetch``: drain, flush, admission, then K10 uploads the
admitted rows and K2 admit swaps their hashes into the digest) before
packing it with hot slots; a batch the hot set cannot hold takes the
host path.  The device digest is then the hot partial of the logical
root, and the host path reads the logical table built from the mirror.

The window, ring and recovery structure and the knob defaults are the
reference's, which a high-latency TPU link shaped; they are to be
retuned once the H100 is measured.  Not ported yet (ROADMAP): the link
seam and chaos shim, the degraded lifecycle and scrubs, row sharding.
"""

from __future__ import annotations

import time as _time

import numpy as np
import torch

from tigerbeetle_tpu_torch import envcheck
from tigerbeetle_tpu_torch.ops.u128 import from_u64, to_u64
from tigerbeetle_tpu_torch.state_machine import commitment as cm
from tigerbeetle_tpu_torch.state_machine import device_kernels as dk
from tigerbeetle_tpu_torch.state_machine import hot_tier, resolve, waves
from tigerbeetle_tpu_torch.state_machine.kernel_fast import flush_entries
from tigerbeetle_tpu_torch.state_machine.mirror import digest_columns

_WINDOW = envcheck.dev_window()
_RING = envcheck.dev_ring()
envcheck.validate_window_ring(_WINDOW, _RING)

_SEMANTIC_KINDS = tuple(dk.KERNELS)
_WAVE_KINDS = ("waves", "spec")
# Speculative-execution counters (the reference's dev_wave.spec.*).
SPEC_COUNTERS = (
    "attempts",        # speculative launches
    "hits",            # batches validated conflict-free (one step)
    "plan_skipped",    # partitioner runs avoided (== hits)
    "residue_events",  # events replayed through a residue plan
    "steps",           # device-step equivalents, residue plans included
    "validation_s",    # host seconds: speculative launch + flags fetch
    "residue_plan_s",  # host seconds: plan_residue on misses
)
_MASK32_NP = np.uint64(0xFFFFFFFF)


class ReplyFuture:
    """Reply bytes that materialize at the batch's window rotation;
    ``result()`` drains the engine if they have not yet."""

    __slots__ = ("_value", "_engine")

    def __init__(self, engine=None, value: bytes | None = None) -> None:
        self._value = value
        self._engine = engine

    def done(self) -> bool:
        return self._value is not None

    def resolve(self, value: bytes) -> None:
        self._value = value

    def result(self) -> bytes:
        if self._value is None and self._engine is not None:
            self._engine.drain()
        if self._value is None:
            raise RuntimeError("reply never materialized")
        return self._value


class _InFlight:
    """One stream entry, in submission order: a semantic batch, a
    lookup gather, or an account-meta update."""

    __slots__ = (
        "kind", "pk", "n", "ts_base", "finish", "fallback", "future",
        "ring_at", "id_keys", "handle", "slots", "rows", "meta_args",
        "wave_args", "touched", "bound", "hot_slots",
    )

    def __init__(self, kind, future, finish, *, pk=None, n=0, ts_base=0,
                 fallback=None, id_keys=None, slots=None, meta_args=None,
                 wave_args=None, bound=0, hot_slots=None):
        self.kind = kind
        self.pk = pk
        self.n = n
        self.ts_base = ts_base
        self.finish = finish
        self.fallback = fallback
        self.future = future
        self.ring_at = -1
        self.id_keys = id_keys  # sorted u128-packed ids (hazard probes)
        self.handle = None      # lookup gather, fetched at rotation
        self.slots = slots      # lookup slots
        self.hot_slots = hot_slots  # their hot slots under tiering
        self.rows = None        # fetched lookup rows
        self.meta_args = meta_args  # (slots, flags, ledger) for "meta"
        # Wave / speculative records: (waves.PackedColumns, plan or the
        # pv_serial fact), the compact record rebuilt at launch.
        self.wave_args = wave_args
        self.touched = None  # rows a wave record can modify (at launch)
        # Bound on the balance additions the record can still make (the
        # wave admission's in-flight term), released at its bookkeeping.
        self.bound = bound


def _touched_of_pk(kind: str, pk, n: int) -> np.ndarray:
    """Balance rows a packed semantic batch can modify, read from the
    host copy of the packed columns (a superset is fine — refreshing
    an unmodified row is a no-op).  The two-phase kernel also writes
    the durable pending target's accounts (COL_TP_SLOTS); an in-batch
    target's are its creator's own slots, which the batch covers."""
    pk = np.asarray(pk)
    if kind == "orderfree_tight":
        s = np.concatenate(
            [pk[:n, 1].astype(np.int64), pk[:n, 2].astype(np.int64)]
        ) - 1
        return s[s >= 0]
    cols = [dk.COL_SLOTS]
    if kind in ("two_phase", "two_phase_lo"):
        cols.append(dk.COL_TP_SLOTS)
    parts = []
    for col in cols:
        w = pk[:n, col]
        parts += [(w & _MASK32_NP).astype(np.int64) - 1, (w >> np.uint64(32)).astype(np.int64) - 1]
    s = np.concatenate(parts)
    return s[s >= 0]


def _host_tensor(array: np.ndarray, device) -> torch.Tensor:
    """numpy u64/u32 array -> int64/int32 tensor with the same bits."""
    a = np.ascontiguousarray(array)
    if a.dtype.itemsize == 8:
        return from_u64(a, device)
    return torch.from_numpy(a.view(np.int32)).to(device)


class DeviceEngine:
    """Authoritative device tables + windowed semantic dispatch.

    `plain=True` runs the plain PyTorch versions of the kernels on the
    engine's device instead of the kernels — the reference run the chip
    smoke test compares the kernels' end-to-end results against."""

    def __init__(self, capacity: int, mirror, device, plain: bool = False) -> None:
        self.capacity = capacity
        self.mirror = mirror  # host bookkeeping copy (recovery + parity)
        self.device = device
        self.window = _WINDOW
        self._plain = plain
        if plain:
            self._kfn = dk.PLAIN
            self._cm = cm.PLAIN_FNS
            self._apply = dk.apply_deltas_plain
            self._set_rows = dk.tier_set_rows_plain
            self._checksum = dk.checksum_plain
        else:
            self._kfn = dk.KERNELS
            self._cm = cm.device_fns()
            self._apply = dk.apply_deltas
            self._set_rows = dk.tier_set_rows
            self._checksum = dk.checksum
        # Hot/cold tiering: None = all-resident.  Tiered, the device
        # tables hold hot.hot_rows rows and the mirror (+ _meta_host) is
        # the logical cold tier.
        self.hot = hot_tier.from_env(capacity)
        rows = capacity if self.hot is None else self.hot.hot_rows
        self._commit_enabled = envcheck.state_commit() == 1
        self._wave_scratch = None
        self._inflight_bound = 0
        self.spec_stats = {name: 0 for name in SPEC_COUNTERS}
        # Stat counters (the reference's names).
        self.stat_semantic_events = 0
        self.stat_fallback_batches = 0
        self.stat_fetches = 0
        self.stat_commit_updates = 0
        self.stat_t_h2d = 0.0
        self.stat_t_dispatch = 0.0
        self.stat_t_fetch = 0.0
        self.stat_t_finish = 0.0
        self._meta_host = np.zeros((capacity, 2), np.uint32)
        self.ring = torch.zeros(
            (_RING, dk.SUMMARY_WORDS), dtype=torch.int64, device=device
        )
        self._ring_at = 0
        # Incremental state commitment: device per-row hashes + fold,
        # with the bit-identical host twin on mirror.commitment.
        self.dev_row_hash = None
        self.dev_digest = None
        if self._commit_enabled and mirror.commitment is None:
            mirror.commitment = cm.HostCommitment(capacity, meta_fn=self._twin_meta)
        self.balances = torch.zeros((rows, 8), dtype=torch.int64, device=device)
        self.meta = torch.zeros((rows, 2), dtype=torch.int32, device=device)
        self._scratch: dict = {}  # kernel family -> its scratch, made at first use
        # The logical table built from the mirror for the host path,
        # keyed by (mirror stamp, capacity); write_back drops it (K3
        # writes it in place).
        self._degraded_cache = None
        self._commit_rebuild()
        # Window pipeline: _pending accumulates host-side; _launched is
        # the window executing on the device; _recovering holds a
        # window mid-recovery, detached so a re-entrant drain cannot
        # rotate it.
        self._pending: list[_InFlight] = []
        self._pending_semantic = 0
        self._launched: list[_InFlight] = []
        self._recovering: list[_InFlight] = []
        # Re-execution of a flagged batch updates the mirror only; the
        # device receives the result through the re-upload after it.
        self._suppress_enqueue = False
        # Write-behind lane (host-resolved batches, pending expiry).
        self._q: list[tuple] = []
        self._queued = 0
        self.stat_flushes = 0

    def _scratch_for(self, kind: str):
        """The scratch of `kind`'s kernel family (None for the plain
        versions and on the CPU)."""
        if self._plain or self.device.type == "cpu":
            return None
        family = dk.FAMILY[kind]
        if family not in self._scratch:
            self._scratch[family] = dk.new_scratch(family, self.balances.shape[0], self.device)
        return self._scratch[family]

    # ------------------------------------------------------------------
    # Moving state in and out (bit for bit, numpy u64/u32 layouts).

    def from_numpy_tables(self, balances_u64, meta_u32, row_hash_u64=None,
                          digest_u64=None) -> None:
        """Replace the device tables from numpy (A, 8) u64 balances and
        (A, 2) u32 meta.  Row hashes + digest are taken as given when
        supplied, else rebuilt on the device.  The engine must hold no
        in-flight work."""
        if self.has_inflight():
            raise RuntimeError("from_numpy_tables with batches in flight")
        if self.hot is not None:
            raise RuntimeError("from_numpy_tables takes logical tables: not on a tiered engine")
        balances_u64 = np.asarray(balances_u64, np.uint64)
        meta_u32 = np.asarray(meta_u32, np.uint32)
        if balances_u64.shape != (self.capacity, 8) or meta_u32.shape != (self.capacity, 2):
            raise ValueError(
                f"tables must be ({self.capacity}, 8) and ({self.capacity}, 2), "
                f"got {balances_u64.shape} and {meta_u32.shape}"
            )
        self.balances = _host_tensor(balances_u64, self.device)
        self.meta = _host_tensor(meta_u32, self.device)
        self._meta_host = meta_u32.copy()
        if row_hash_u64 is None or not self._commit_enabled:
            self._commit_rebuild()
        else:
            self.dev_row_hash = _host_tensor(np.asarray(row_hash_u64, np.uint64), self.device)
            self.dev_digest = _host_tensor(np.asarray(digest_u64, np.uint64), self.device)

    def to_numpy_tables(self):
        """(balances (A, 8) u64, meta (A, 2) u32, row_hash (A, 2) u64 or
        None, digest (2,) u64 or None) — drains and flushes first.  The
        device tables: hot-shaped under tiering."""
        self.drain()
        self.flush()
        meta = self.meta.cpu().numpy().view(np.uint32)
        if self.dev_row_hash is None:
            return to_u64(self.balances), meta, None, None
        return (
            to_u64(self.balances), meta, to_u64(self.dev_row_hash),
            to_u64(self.dev_digest),
        )

    # ------------------------------------------------------------------
    # Account meta maintenance (create_accounts path).  Rides the
    # record stream so updates sequence between the batches around
    # them without forcing a drain.

    def add_accounts(self, slots, acct_flags, acct_ledger) -> None:
        slots = np.asarray(slots, np.int64)
        self._meta_host[slots, 0] = acct_flags
        self._meta_host[slots, 1] = acct_ledger
        if self.mirror.commitment is not None:
            self.mirror.commitment.refresh(slots, self.mirror)
        self._queue_meta(
            slots,
            np.broadcast_to(np.asarray(acct_flags, np.uint32), slots.shape).copy(),
            np.broadcast_to(np.asarray(acct_ledger, np.uint32), slots.shape).copy(),
        )

    def _queue_meta(self, slots, flags_u32, ledger_u32) -> None:
        """Queue a device meta update.  Tiered, the record carries hot
        slots (the map holds until the next admission, which drains
        first) and cold rows drop: _meta_host is their authority and
        admission uploads their meta."""
        if self.hot is not None:
            h = self.hot.translate(slots)
            keep = h >= 0
            if not keep.any():
                return
            slots, flags_u32, ledger_u32 = h[keep], flags_u32[keep], ledger_u32[keep]
        self._pending.append(
            _InFlight("meta", None, None, meta_args=(slots, flags_u32, ledger_u32))
        )

    def grow(self, capacity: int) -> None:
        if capacity <= self.capacity:
            return
        self.drain()
        self.flush()
        self._meta_host = hot_tier.grow_zero_host(self._meta_host, capacity)
        self.capacity = capacity
        if self.hot is not None:
            # The device tables keep their hot-row geometry: logical
            # growth widens only the maps (new rows are cold and zero,
            # so the hot partial does not move).
            self.hot.grow_logical(capacity)
            return
        self.balances = hot_tier.grow_zero_device(self.balances, capacity)
        self.meta = hot_tier.grow_zero_device(self.meta, capacity)
        self._scratch = {}
        # Zero rows hash to 0, so the digest VALUE is unchanged, but the
        # per-row hash array must match the new geometry.
        self._commit_rebuild()

    # ------------------------------------------------------------------
    # Hot/cold tiering: the machine calls tier_prefetch with a batch's
    # logical touched set before packing; packed records then carry hot
    # slots.  The map only moves against a quiesced pipeline (admission
    # drains and flushes first), so every record launches under the map
    # it was translated with, and eviction is free: after the drain the
    # mirror holds every finished batch's effects.

    def tier_prefetch(self, slots) -> bool:
        """Make every logical row of `slots` device-resident (negative
        entries ignored).  False when the batch cannot run on the device
        (its touched set is wider than the hot set, or nothing can be
        evicted): the caller takes the exact host path."""
        if self.hot is None:
            return True
        hot = self.hot
        uniq, missing = hot.plan(np.asarray(slots, np.int64))
        if len(missing) == 0:
            hot.record_use(uniq, len(uniq), 0)
            return True
        if len(uniq) > hot.hot_rows:
            return False
        t0 = _time.perf_counter()
        self.drain()
        self.flush()
        got = hot.admit(missing, protect=uniq)
        if got is None:
            return False
        admitted, hot_slots, _evicted = got
        self._tier_upload(admitted, hot_slots)
        hot.record_use(uniq, len(uniq) - len(missing), len(missing))
        hot.note_stall(_time.perf_counter() - t0)
        return True

    def _tier_upload(self, admitted, hot_slots) -> None:
        """Upload the admitted rows (balances and meta, from the cold
        tier) into their hot slots with K10, and swap their hashes into
        the device digest with K2 admit: the victims' hashes out, the
        host twin's hashes of the admitted rows in, so the digest stays
        the exact hot partial."""
        if len(admitted) == 0:
            return
        idx = torch.from_numpy(np.asarray(hot_slots, np.int64)).to(self.device)
        self._set_rows(self.balances, idx, from_u64(self.mirror.rows8(admitted), self.device))
        self._set_rows(self.meta, idx, _host_tensor(self._meta_host[admitted], self.device))
        if self._commit_enabled and self.dev_row_hash is not None:
            twin = self.mirror.commitment
            self._cm["admit"](
                self.dev_row_hash, self.dev_digest, idx,
                from_u64(twin.row_lo[admitted], self.device),
                from_u64(twin.row_hi[admitted], self.device),
            )

    # ------------------------------------------------------------------
    # Semantic dispatch.

    def submit(self, kind, pk, n, ts_base, finish, fallback,
               id_keys=None, bound=0) -> ReplyFuture:
        """Queue one semantic batch; returns its reply future.
        `finish(summary) -> bytes` runs at materialization; `fallback()
        -> bytes` re-executes the batch exactly on the host; `bound` is
        the batch's amount bound (the wave admission's in-flight term)."""
        return self._submit_record(
            lambda fut: _InFlight(kind, fut, finish, pk=pk, n=n, ts_base=ts_base,
                                  fallback=fallback, id_keys=id_keys, bound=bound)
        )

    def submit_waves(self, ev, dstat_init, n, ts_base, plan, hist_fix, finish,
                     fallback, id_keys=None, bound=0) -> ReplyFuture:
        """Queue one WAVE-DISPATCHED batch: executed inside the window as
        its plan's segments against the device table (_exec_waves).
        `ev` is the host (B,)-array event dict (kernel.EVENT_FIELDS),
        `plan` the admitted WavePlan, `hist_fix` the snapshot-rewrite
        mask; `finish(packed_np) -> bytes` runs the exact path's
        bookkeeping at materialization.  The record keeps the lossless
        compact columns (waves.pack_wave_record), not the padded dict."""
        packed = waves.pack_wave_record(ev, dstat_init, hist_fix, n)
        return self._submit_record(
            lambda fut: _InFlight("waves", fut, finish, n=n, ts_base=ts_base,
                                  fallback=fallback, id_keys=id_keys, bound=bound,
                                  wave_args=(packed, plan))
        )

    def submit_speculative(self, ev, dstat_init, n, ts_base, spec_serial, pv_serial,
                           finish, fallback, id_keys=None, bound=0) -> ReplyFuture:
        """Queue one SPECULATIVE batch: at launch the whole batch runs as
        one validated step and only a conflicted residue replays through
        a plan (_exec_spec).  `spec_serial` marks the events the step
        does not model (chain members, history events, serialized
        post/voids); `pv_serial` is the submit-time routing fact the
        residue planner reuses.  `bound` must be the WHOLE batch's bound:
        a later record's admission must count everything this one can
        still apply."""
        packed = waves.pack_spec_record(ev, dstat_init, spec_serial, n)
        return self._submit_record(
            lambda fut: _InFlight("spec", fut, finish, n=n, ts_base=ts_base,
                                  fallback=fallback, id_keys=id_keys, bound=bound,
                                  wave_args=(packed, bool(pv_serial)))
        )

    def _submit_record(self, make_rec) -> ReplyFuture:
        """The one stream-entry protocol of semantic and wave records:
        flush (earlier host-resolved deltas land first), enqueue, count
        the record's bound in flight, rotate at the window boundary."""
        self.flush()
        fut = ReplyFuture(self)
        rec = make_rec(fut)
        self._pending.append(rec)
        self._pending_semantic += 1
        self._inflight_bound += rec.bound
        if self._pending_semantic >= self.window:
            self._rotate()
        return fut

    def inflight_bound(self) -> int:
        """Upper bound on balance additions submitted but not yet in the
        mirror: the wave admission's `extra` term."""
        return self._inflight_bound

    def _release_bound(self, rec: _InFlight) -> None:
        """The record's bookkeeping reached the mirror (its finish or its
        host fallback ran): its contributions are no longer in flight.
        Idempotent."""
        if rec.bound:
            self._inflight_bound -= rec.bound
            rec.bound = 0

    def lookup(self, slots, finish) -> ReplyFuture:
        """Device-side balance gather for lookup_accounts: rides the
        record stream, so it sees every earlier batch's effects.
        Tiered, every looked-up row is made resident first; when that
        cannot be done, the stream drains and the rows come from the
        mirror (exact: the drain put every earlier batch there)."""
        slots = np.asarray(slots, np.int64)
        if not self.tier_prefetch(slots):
            self.drain()
            self.flush()
            return ReplyFuture(value=finish(self.mirror.rows8(slots)))
        self.flush()
        fut = ReplyFuture(self)
        self._pending.append(_InFlight(
            "lookup", fut, finish, slots=slots,
            hot_slots=None if self.hot is None else self.hot.translate(slots),
        ))
        return fut

    def _gather(self, rec: _InFlight):
        slots = rec.slots if rec.hot_slots is None else rec.hot_slots
        pad = ((len(slots) + 255) & ~255) or 256
        sl = np.full(pad, -1, np.int64)
        sl[: len(slots)] = slots
        return dk.lookup(self.balances, torch.from_numpy(sl).to(self.device))

    def _meta_update(self, rec: _InFlight) -> None:
        slots, flags, ledger = rec.meta_args
        dk.meta_update(
            self.meta, torch.from_numpy(slots).to(self.device),
            _host_tensor(flags, self.device), _host_tensor(ledger, self.device),
        )

    # ------------------------------------------------------------------
    # Window launch: one upload per input layout, then back-to-back
    # launches with no host synchronisation.

    def _plan_chunks(self, recs):
        """Group records into dispatch units: maximal same-kind
        semantic runs, with meta/lookup records as unit boundaries.  A
        run is one unit: its batches launch back to back from one
        upload buffer, so the reference's split into compiled scan
        sizes (TB_DEV_SCAN_SIZES) has no counterpart here."""
        units = []
        run = []
        for rec in recs:
            # Wave and speculative records are units of their own.
            if rec.kind in _SEMANTIC_KINDS and (not run or run[-1].kind == rec.kind):
                run.append(rec)
                continue
            if run:
                units.append(("scan", run))
                run = []
            if rec.kind in _SEMANTIC_KINDS:
                run.append(rec)
            else:
                units.append((rec.kind, [rec]))
        if run:
            units.append(("scan", run))
        return units

    def _launch(self, recs: list[_InFlight]) -> None:
        if not recs:
            return
        t0 = _time.perf_counter()
        units = self._plan_chunks(recs)
        # One (rows, B, C) buffer per input layout; launch groups claim
        # contiguous row ranges in plan order.
        rows_of: dict[tuple, int] = {}
        for ukind, urecs in units:
            if ukind == "scan":
                spec = dk.PK_SPEC[urecs[0].kind]
                rows_of[spec] = rows_of.get(spec, 0) + len(urecs)
        bufs: dict[tuple, list] = {}  # spec -> [big, ns, tsb, cursor]
        offsets: dict[int, int] = {}
        for i, (ukind, urecs) in enumerate(units):
            if ukind != "scan":
                continue
            spec = dk.PK_SPEC[urecs[0].kind]
            if spec not in bufs:
                ncols, dtype = spec
                bufs[spec] = [
                    np.zeros((rows_of[spec], dk.B, ncols), dtype),
                    np.zeros(rows_of[spec], np.int64),
                    np.zeros(rows_of[spec], np.uint64),
                    0,
                ]
            big, ns, tsb, cur = bufs[spec]
            for g, rec in enumerate(urecs):
                big[cur + g] = rec.pk
                ns[cur + g] = rec.n
                tsb[cur + g] = rec.ts_base
            offsets[i] = cur
            bufs[spec][3] = cur + len(urecs)
        dev_bufs = {
            spec: (_host_tensor(big, self.device), ns, tsb)
            for spec, (big, ns, tsb, _cur) in bufs.items()
        }
        t1 = _time.perf_counter()
        self.stat_t_h2d += t1 - t0
        for i, (ukind, urecs) in enumerate(units):
            if ukind == "meta":
                self._meta_update(urecs[0])
            elif ukind == "lookup":
                urecs[0].handle = self._gather(urecs[0])
            elif ukind == "waves":
                self._exec_waves(urecs[0])
            elif ukind == "spec":
                self._exec_spec(urecs[0])
            else:
                kind = urecs[0].kind
                big, ns, tsb = dev_bufs[dk.PK_SPEC[kind]]
                dk.run_window(
                    kind, self.balances, self.meta, self.ring,
                    self._ring_at, big, offsets[i], len(urecs), ns, tsb,
                    scratch=self._scratch_for(kind), fn=self._kfn[kind],
                )
                for g, rec in enumerate(urecs):
                    rec.ring_at = (self._ring_at + g) % _RING
                self._ring_at = (self._ring_at + len(urecs)) % _RING
        self.stat_t_dispatch += _time.perf_counter() - t1
        # Absorb the whole window's touched rows into the device
        # commitment: one extra launch per window.
        if self._commit_enabled:
            touched = self._collect_touched(recs)
            if touched is not None:
                self._commit_update(touched)

    def _dispatch(self, rec: _InFlight) -> None:
        """Immediate single-batch launch (recovery re-dispatch path),
        with the kernel of the batch's own kind."""
        pk = _host_tensor(rec.pk, self.device)
        self._kfn[rec.kind](
            self.balances, self.meta, self.ring, self._ring_at, pk, rec.n,
            rec.ts_base, scratch=self._scratch_for(rec.kind),
        )
        rec.ring_at = self._ring_at
        self._ring_at = (self._ring_at + 1) % _RING

    def _wave_scratch_dev(self):
        if self._plain or self.device.type != "cuda":
            return None
        if self._wave_scratch is None:
            self._wave_scratch = waves.WaveScratch(self.device)
        return self._wave_scratch

    def _exec_waves(self, rec: _InFlight) -> None:
        """Execute a wave record's plan against the device table, in
        place (waves.run_plan_engine); the packed outputs are fetched at
        rotation like a lookup gather.  A CUDA error raises with part of
        the batch applied: the engine has no retry (the reference's link
        seam is not ported), and the mirror — which holds exactly the
        batches before this one — is the state to rebuild the table
        from."""
        packed_rec, plan = rec.wave_args
        ev, dstat_init, hist_fix = waves.unpack_wave_record(packed_rec)
        if self._commit_enabled:
            rec.touched = waves.touched_slots(ev, rec.n)
        rec.handle = waves.run_plan_engine(
            self.balances, ev, dstat_init, rec.n, rec.ts_base, plan, hist_fix,
            scratch=self._wave_scratch_dev(), plain=self._plain,
        )

    def _exec_spec(self, rec: _InFlight) -> None:
        """Execute a speculative record: one whole-batch step with the
        on-device validation, the conflict flags fetched (the validation
        synchronisation: later records read the table, so the verdict
        cannot wait for rotation), then only on a miss plan_residue over
        the conflicted events and the carry-threaded replay."""
        packed_rec, pv_serial = rec.wave_args
        ev, dstat_init, spec_serial = waves.unpack_spec_record(packed_rec)
        if self._commit_enabled:
            rec.touched = waves.touched_slots(ev, rec.n)
        n = rec.n
        B = len(ev["flags"])
        scratch = self._wave_scratch_dev()
        st = self.spec_stats
        st["attempts"] += 1
        t0 = _time.perf_counter()
        carry, confl = waves.run_speculative_engine(
            self.balances, ev, dstat_init, spec_serial, n, rec.ts_base,
            scratch=scratch, plain=self._plain,
        )
        confl_np = confl.cpu().numpy().astype(bool)[:n]
        st["validation_s"] += _time.perf_counter() - t0
        residue = np.flatnonzero(confl_np)
        hist = np.zeros(B, bool)
        if len(residue) == 0:
            hist[:n] = True
            rec.handle = waves.finalize_engine(self.balances, carry, hist, plain=self._plain)
            st["hits"] += 1
            st["plan_skipped"] += 1
            st["steps"] += 1
            return
        t1 = _time.perf_counter()
        meta = resolve.spec_meta_from_events(ev, n, pv_serial)
        plan = waves.plan_residue(n, meta, residue)
        st["residue_plan_s"] += _time.perf_counter() - t1
        # Committed events and residue wave/chain events take batch-final
        # snapshots; residue scan events keep their sequential ones.
        hist[:n] = ~confl_np
        hist[:n] |= plan.wave_mask
        rec.handle = waves.continue_plan_engine(
            self.balances, carry, ev, n, rec.ts_base, plan, hist,
            scratch=scratch, plain=self._plain,
        )
        st["residue_events"] += len(residue)
        st["steps"] += 1 + plan.n_steps

    # ------------------------------------------------------------------
    # Hazard probe: does any probe id match an in-flight batch's ids?

    def inflight_ids_hit(self, keys: np.ndarray) -> bool:
        """keys: u128-packed (V16) id probes, any order."""
        stream = self._launched + self._pending
        if not stream or len(keys) == 0:
            return False
        keys = np.sort(keys)
        lo = keys[0].tobytes()
        hi = keys[-1].tobytes()
        for rec in stream:
            ik = rec.id_keys
            if ik is None or len(ik) == 0:
                continue
            if hi < ik[0].tobytes() or lo > ik[-1].tobytes():
                continue
            pos = np.searchsorted(ik, keys)
            pos = np.minimum(pos, len(ik) - 1)
            if (ik[pos] == keys).any():
                return True
        return False

    def has_inflight(self) -> bool:
        return bool(self._launched or self._pending)

    # ------------------------------------------------------------------
    # Rotation + materialization.

    def _fetch_ring(self, recs):
        """Ring snapshot + lookup-row pulls for a launched window; the
        copy synchronises the stream."""
        ring_np = None
        t0 = _time.perf_counter()
        if any(r.kind in _SEMANTIC_KINDS for r in recs):
            self.stat_fetches += 1
            ring_np = to_u64(self.ring)
        for rec in recs:
            if rec.kind in ("lookup",) + _WAVE_KINDS and rec.handle is not None:
                rec.rows = to_u64(rec.handle)
                rec.handle = None
        self.stat_t_fetch += _time.perf_counter() - t0
        return ring_np

    def _window_clean(self, recs, ring_np) -> bool:
        for rec in recs:
            if rec.kind not in _SEMANTIC_KINDS:
                continue
            if int(ring_np[rec.ring_at][1]) & (dk.FLAG_OVERFLOW | dk.FLAG_CAP | dk.FLAG_PRECOND):
                return False
        return True

    def _resolve_clean(self, recs, ring_np) -> None:
        t0 = _time.perf_counter()
        for rec in recs:
            if rec.kind == "meta":
                continue
            if rec.kind == "lookup":
                rec.future.resolve(rec.finish(rec.rows))
                continue
            if rec.kind in _WAVE_KINDS:
                self.stat_semantic_events += rec.n
                rec.future.resolve(rec.finish(rec.rows))
                self._release_bound(rec)
                continue
            s = dk.unpack_summary(ring_np[rec.ring_at])
            self.stat_semantic_events += rec.n
            rec.future.resolve(rec.finish(s))
            self._release_bound(rec)
        self.stat_t_finish += _time.perf_counter() - t0

    def _rotate(self) -> None:
        """Window boundary: fetch the launched window's ring; when it is
        clean, launch the pending window while the host holds the
        results, then finish the old window's bookkeeping overlapped
        with the device's work on the new one."""
        prev = self._launched
        ring_np = self._fetch_ring(prev) if prev else None
        if prev and (ring_np is None or self._window_clean(prev, ring_np)):
            nxt = self._pending
            self._launch(nxt)
            self._launched = nxt
            self._pending = []
            self._pending_semantic = 0
            self._resolve_clean(prev, ring_np)
            return
        if prev:
            # A flagged batch in the window: serial exact recovery
            # first, with the window detached from _launched.
            self._launched = []
            self._recovering = prev
            self._resolve_recovery(prev, ring_np)
            self._recovering = []
        self._launched = []
        nxt = self._pending
        self._launch(nxt)
        self._launched = nxt
        self._pending = []
        self._pending_semantic = 0

    def _resolve_recovery(self, covered, ring_np) -> None:
        """Exact recovery: resolve in order until the flagged batch,
        re-execute it on the host (the mirror becomes current), rebuild
        the device table from the mirror, re-dispatch everything after
        it, repeat until done."""
        while covered:
            if ring_np is None:
                ring_np = self._fetch_ring(covered)
            failed_at = None
            for i, rec in enumerate(covered):
                if rec.kind == "meta":
                    continue
                if rec.kind == "lookup":
                    rec.future.resolve(rec.finish(rec.rows))
                    continue
                if rec.kind in _WAVE_KINDS:
                    # No failure flag: admission proved the plan exact,
                    # so the fetched outputs (computed against the
                    # stream before any later fallback) resolve.
                    self.stat_semantic_events += rec.n
                    rec.future.resolve(rec.finish(rec.rows))
                    self._release_bound(rec)
                    continue
                s = dk.unpack_summary(ring_np[rec.ring_at])
                if s["overflow"] or s["cap_exceeded"] or s["precond"]:
                    failed_at = i
                    self.stat_fallback_batches += 1
                    rec.future.resolve(rec.fallback())
                    self._release_bound(rec)
                    break
                self.stat_semantic_events += rec.n
                rec.future.resolve(rec.finish(s))
                self._release_bound(rec)
            if failed_at is None:
                return
            self._upload_from_mirror()
            covered = covered[failed_at + 1 :]
            for rec in covered:
                if rec.kind == "meta":
                    self._meta_update(rec)
                elif rec.kind == "lookup":
                    rec.handle = self._gather(rec)
                elif rec.kind == "waves":
                    self._exec_waves(rec)
                elif rec.kind == "spec":
                    self._exec_spec(rec)
                else:
                    self._dispatch(rec)
            # The re-dispatched suffix mutated the rebuilt table: fold
            # its touched rows back into the commitment.
            if self._commit_enabled and covered:
                touched = self._collect_touched(covered)
                if touched is not None:
                    self._commit_update(touched)
            ring_np = None

    def _upload_from_mirror(self) -> None:
        """Re-upload the balance table from the mirror (its hot image
        under tiering) and re-derive the device commitment from scratch
        (reads the current device meta, which the stream keeps in step
        with the host)."""
        src = self._mirror_hot_table_np() if self.hot is not None else self.mirror.table8(self.capacity)
        self.balances = _host_tensor(src, self.device)
        self._commit_rebuild()

    def _mirror_hot_table_np(self) -> np.ndarray:
        """Hot-shaped (hot_rows, 8) u64 image of the mirror: what the
        device balance table must equal under tiering."""
        return hot_tier.mirror_hot_table8(self.mirror, self.hot.logical_of)

    def _meta_hot_np(self) -> np.ndarray:
        """Hot-shaped (hot_rows, 2) u32 image of _meta_host (zeros for a
        free hot slot)."""
        lof = self.hot.logical_of
        out = np.zeros((len(lof), 2), np.uint32)
        occ = np.flatnonzero(lof >= 0)
        out[occ] = self._meta_host[lof[occ]]
        return out

    # ------------------------------------------------------------------
    # Integrity digests (kernel K11) and divergence localization.

    def _device_checksum(self) -> np.ndarray:
        """K11 digest of the device balance table (16 u64 words)."""
        return to_u64(self._checksum(self.balances))

    def _device_health_digest(self) -> np.ndarray:
        """Balance digest + meta digest of the device tables (K11 on
        each): what the host's copies are compared with."""
        return np.concatenate([self._device_checksum(), to_u64(self._checksum(self.meta))])

    def _host_health_digest(self) -> np.ndarray:
        """The same 20 words from the host's copies: hot-shaped images
        under tiering (the logical table is attested through the
        commitment fold), the logical tables otherwise."""
        if self.hot is not None:
            return np.concatenate([
                digest_columns(self._mirror_hot_table_np()),
                digest_columns(self._meta_hot_np()),
            ])
        return np.concatenate([
            self.mirror.checksum8(self.capacity), digest_columns(self._meta_host),
        ])

    def checksum(self) -> np.ndarray:
        """Digest of the authoritative logical balance table (drained and
        flushed first): K11 on the device table all-resident; tiered the
        logical table is the mirror's, which the drain made current."""
        self.drain()
        self.flush()
        if self.hot is not None:
            return self.mirror.checksum8(self.capacity)
        return self._device_checksum()

    def _localize_divergence(self) -> np.ndarray:
        """The full-table fetch, run only after a digest compare failed:
        the logical rows where the device tables differ from the host's
        copies (hot-shaped tables compared under tiering)."""
        bal, meta, _, _ = self.to_numpy_tables()
        if self.hot is not None:
            diverged = (bal != self._mirror_hot_table_np()).any(axis=1) | (
                meta != self._meta_hot_np()
            ).any(axis=1)
            return self.hot.logical_of[np.flatnonzero(diverged)]
        diverged = (bal != self.mirror.table8(self.capacity)).any(axis=1) | (
            meta != self._meta_host
        ).any(axis=1)
        return np.flatnonzero(diverged)

    # ------------------------------------------------------------------
    # Incremental state commitment (kernel K2).

    def _twin_meta(self, slots: np.ndarray) -> np.ndarray:
        """Meta columns for a standalone engine's host twin."""
        out = np.zeros((len(slots), 2), np.uint32)
        m = slots < len(self._meta_host)
        out[m] = self._meta_host[slots[m]]
        return out

    def _commit_rows(self) -> torch.Tensor:
        """Logical-row binding for the commitment kernels: identity
        all-resident, logical_of tiered.  A free hot slot binds to row 0:
        its all-zero content hashes to (0, 0) whatever the binding, so
        the digest is exactly the hot partial of the logical table."""
        if self.hot is None:
            return torch.arange(self.balances.shape[0], dtype=torch.int64, device=self.device)
        lof = self.hot.logical_of
        return torch.from_numpy(np.where(lof >= 0, lof, 0)).to(self.device)

    def _commit_rebuild(self) -> None:
        if not self._commit_enabled:
            return
        self.dev_row_hash, self.dev_digest = self._cm["rebuild"](
            self.balances, self.meta, self._commit_rows()
        )

    def _commit_update(self, slots) -> None:
        """Absorb the touched rows of one window into the device digest:
        one launch, O(touched).  `slots` index the device tables (hot
        slots under tiering, hashed under their logical rows)."""
        if not self._commit_enabled or self.dev_row_hash is None:
            return
        slots = np.unique(np.asarray(slots, np.int64))
        slots = slots[(slots >= 0) & (slots < self.balances.shape[0])]
        if len(slots) == 0:
            return
        padded_np = cm.pad_slots(slots)
        padded = torch.from_numpy(padded_np).to(self.device)
        rows = padded
        if self.hot is not None:
            lof = self.hot.logical_of[np.maximum(padded_np, 0)]
            rows = torch.from_numpy(np.where(padded_np >= 0, lof, 0)).to(self.device)
        self.stat_commit_updates += 1
        self._cm["update"](
            self.balances, self.meta, self.dev_row_hash, self.dev_digest, padded, rows,
        )

    def _collect_touched(self, recs) -> np.ndarray | None:
        """Union of balance rows a record list can have modified."""
        touched = []
        for rec in recs:
            if rec.kind == "meta":
                touched.append(rec.meta_args[0])
            elif rec.kind in _WAVE_KINDS and rec.touched is not None:
                touched.append(rec.touched)
            elif rec.kind in _SEMANTIC_KINDS:
                touched.append(_touched_of_pk(rec.kind, rec.pk, rec.n))
        if not touched:
            return None
        return np.concatenate(touched)

    def twin_expected_digest(self) -> np.ndarray:
        """What the host twin says the device digest is: the whole root
        all-resident, the hot partial tiered (the cold partial is the
        twin's remainder: fold(hot, cold) stays the logical root)."""
        twin = self.mirror.commitment
        if self.hot is None:
            return twin.digest
        return twin.partial(self.hot.occupied())

    def commit_probe(self) -> np.ndarray:
        """(2, 2) u64 [maintained digest, from-scratch digest]; the
        caller holds the engine drained."""
        return to_u64(
            self._cm["probe"](
                self.balances, self.meta, self.dev_digest, self._commit_rows()
            )
        )

    def drain(self) -> None:
        # A drain nested inside exact recovery (the host re-execution
        # may read state) must not touch the stream: the outer
        # recovery finishes it.
        while (self._launched or self._pending) and not self._recovering:
            self._rotate()

    # ------------------------------------------------------------------
    # Write-behind lane and the host path's table access.

    def enqueue(self, slots, cols, add_lo, add_hi) -> None:
        """Queue host-resolved (slot, col, u128 delta) modular adds.  They
        come from the mirror's own methods, which already refreshed the
        commitment twin.  During exact recovery they are dropped: the
        re-upload from the mirror that follows carries them."""
        if len(slots) == 0:
            return
        if self._suppress_enqueue:
            return
        # Host-path deltas only arrive after a drain, so they never
        # overtake queued semantic batches.
        assert self._pending_semantic == 0 and not self._launched, (
            "write-behind enqueue with in-flight semantic batches"
        )
        self._q.append((
            np.asarray(slots, np.int64), np.asarray(cols, np.int64),
            np.asarray(add_lo, np.uint64), np.asarray(add_hi, np.uint64),
        ))
        self._queued += len(slots)

    def flush(self) -> None:
        """Apply the queued deltas with K4, then absorb the written rows
        into the device digest (one K2 update)."""
        if not self._queued:
            return
        slots, cols, a_lo, a_hi = (np.concatenate([e[k] for e in self._q]) for k in range(4))
        self._q.clear()
        self._queued = 0
        self.stat_flushes += 1
        # Tiered, the entries carry logical slots: flush_entries applies
        # the hot ones and returns their hot slots (cold rows keep their
        # deltas in the mirror, and upload whole on admission).
        written = flush_entries(self.balances, slots, cols, a_lo, a_hi, self._apply, self.hot)
        self._commit_update(written)

    def read(self) -> torch.Tensor:
        """The logical table the host path resolves against.  During
        exact recovery the mirror is the truth (it holds exactly the
        stream prefix before the re-executed batch, while the device
        table holds the whole window's effects), so a card tensor is
        built from it; otherwise a drain and flush barrier, then the
        device table — tiered, the table built from the mirror, which
        the drain made current."""
        if self._recovering:
            return self._degraded_table()
        self.drain()
        self.flush()
        if self.hot is not None:
            return self._degraded_table()
        return self.balances

    def write_back(self, value: torch.Tensor) -> None:
        """Replace the table from a full logical table image (the host
        path's exact result): a handle swap all-resident, which does not
        move the digest; tiered, the hot rows gathered out of the image
        and the digest rebuilt (the mirror stays the cold tier's
        authority)."""
        self._degraded_cache = None
        if self.hot is None:
            self.balances = value
            return
        self.balances = hot_tier.gather_hot(value, self.hot.logical_of)
        self._commit_rebuild()

    def exact_written(self, slots) -> None:
        """Fold the rows an exact scan wrote (logical slots) into the
        device digest.  In recovery the re-upload and rebuild that follow
        cover them; tiered, write_back's rebuild did."""
        if not self._recovering and self.hot is None:
            self._commit_update(slots)

    def _degraded_table(self) -> torch.Tensor:
        """The logical table built from the mirror on the card, cached
        against (mirror stamp, capacity): a tiered engine's exact batches
        would otherwise upload the whole table each time."""
        key = (self.mirror.version, self.capacity)
        if self._degraded_cache is None or self._degraded_cache[0] != key:
            self._degraded_cache = (key, _host_tensor(self.mirror.table8(self.capacity), self.device))
        return self._degraded_cache[1]

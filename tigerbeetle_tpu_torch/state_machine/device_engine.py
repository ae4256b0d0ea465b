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

Row sharding (``devices``): given several devices and a table whose
rows divide among them (the reference's rule), balances, meta and row
hashes are ``sharded.ShardedTable``s split row-wise over a ("shard",)
mesh; the ring and the digest stay on the mesh's first device (home).
The row kernels (K1, K5, K6 per window unit, K4, K2 update, lookups
and meta writes) run dense on a compact table: a K14 gather of the
rows the unit can touch onto home, its slot columns remapped onto the
compact rows (``_remap_pk``), the dense kernel unchanged, a K14
scatter back onto the owners.  Wave records run
``waves._execute_plan_sharded`` on the shard tables.  The whole-table
kernels run per shard and add up on home: K2 rebuild and probe (each
shard hashes its rows under their global ids), K11 (each shard mixes
its rows under their global indices, ``row0``).  ``read`` joins the
table onto home and ``write_back`` splits it again.

Link seam and lifecycle (the reference's, :136-2190): every crossing
of the card — an upload, a kernel launch, a fetch, the health probe —
goes through one ``DeviceLink`` and ``_retry``, so a seeded chaos shim
(``testing/chaos.py``) can interpose and retry and error classification
live in one place.  A fatal crossing, or a transient one past its retry
budget, demotes the engine (``_demote``): the host mirror becomes
authoritative, every outstanding record is replayed exactly on the host
in submission order, and later work is served by the host path on the
CPU (plain versions or the native lanes) with no launch on the card.
``tick`` (once per committed operation) probes and re-promotes every
TB_DEV_PROBE_EVERY operations while degraded — probe, re-upload from
the mirror (K2 rebuild), a 16-byte handshake against the host twin —
and while healthy runs the scrub every TB_DEV_SCRUB_EVERY ring fetches:
K2 probe against the twin's expected digest, and only on a mismatch the
full-table fetch that names the diverged rows before the heal.

The window, ring and recovery structure and the knob defaults are the
reference's, which a high-latency TPU link shaped; they are to be
retuned once the H100 is measured.
"""

from __future__ import annotations

import collections
import contextlib
import time as _time

import numpy as np
import torch

from tigerbeetle_tpu_torch import envcheck, kernels
from tigerbeetle_tpu_torch.device import resolve_device
from tigerbeetle_tpu_torch.ops.u128 import from_u64
from tigerbeetle_tpu_torch.parallel import sharded
from tigerbeetle_tpu_torch.state_machine import commitment as cm
from tigerbeetle_tpu_torch.state_machine import device_kernels as dk
from tigerbeetle_tpu_torch.state_machine import hot_tier, resolve, waves
from tigerbeetle_tpu_torch.state_machine.kernel_fast import flush_entries
from tigerbeetle_tpu_torch.state_machine.mirror import digest_columns
from tigerbeetle_tpu_torch.types import EngineState

_WINDOW = envcheck.dev_window()
_RING = envcheck.dev_ring()
envcheck.validate_window_ring(_WINDOW, _RING)

# Link-robustness knobs (envcheck.dev_*), read at import and looked up
# at call time so tests can tighten them per module.
_RETRIES = envcheck.dev_retries()
_BACKOFF_MS = envcheck.dev_backoff_ms()
_BACKOFF_CAP_MS = envcheck.dev_backoff_cap_ms()
_PROBE_EVERY = envcheck.dev_probe_every()
# The cheap 16-byte scrub (commitment on) takes the tight default
# cadence; an engine without the commitment pays the K11 compare per
# scrub and keeps the legacy 256 unless the operator set the cadence.
_SCRUB_EVERY_SET = envcheck.dev_scrub_every_set()
_SCRUB_EVERY = envcheck.dev_scrub_every()
_SCRUB_EVERY_LEGACY = 256
_SCRUB_JITTER = envcheck.dev_scrub_jitter()
envcheck.validate_scrub_jitter(_SCRUB_EVERY, _SCRUB_JITTER)

# Per-process engine construction ordinal: the default scrub-jitter seed
# mixes it in so same-capacity engines of one process still derive
# different offsets (deterministic for a fixed construction order).
_ENGINE_SEQ = 0

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


class LinkError(RuntimeError):
    """A device-link crossing failed (base for injected faults)."""


class TransientLinkError(LinkError):
    """Retryable: the crossing may succeed if reissued."""


class FatalLinkError(LinkError):
    """Not retryable: the link (or device state behind it) is gone."""


class DeviceLostError(RuntimeError):
    """The device link is lost: a crossing failed fatally or exhausted
    its retry budget.  Raised to callers only when no exact host answer
    exists (a stranded future after ``close()``); everywhere else the
    engine catches it and demotes to the host path."""

    def __init__(self, stage: str, cause: object = None) -> None:
        self.stage = stage
        self.cause = cause
        detail = f": {cause}" if cause is not None else ""
        super().__init__(f"device lost at {stage}{detail}")


# Link-error taxonomy: message markers -> classification, first match
# wins in declaration order.  The reference's rows come first, in its
# order (gRPC-style status names); after them the card's own texts for
# the same statuses: CUDA's "out of memory" (cudaErrorMemoryAllocation,
# which kernels._launch reports, and torch.cuda.OutOfMemoryError's
# "CUDA out of memory") plays RESOURCE_EXHAUSTED's part.  A text no row
# names is fatal: a sticky CUDA error ("an illegal memory access was
# encountered") leaves the context unusable, so nothing retries it.
LINK_ERROR_MARKERS = (
    ("RESOURCE_EXHAUSTED", "transient"),
    ("UNAVAILABLE", "transient"),
    ("DEADLINE_EXCEEDED", "transient"),
    ("ABORTED", "transient"),
    ("CANCELLED", "transient"),
    ("temporarily", "transient"),
    ("INVALID_ARGUMENT", "fatal"),
    ("FAILED_PRECONDITION", "fatal"),
    ("NOT_FOUND", "fatal"),
    ("UNIMPLEMENTED", "fatal"),
    ("INTERNAL", "fatal"),
    ("DATA_LOSS", "fatal"),
    ("out of memory", "transient"),
)


def classify_link_error(exc: BaseException) -> str:
    """-> "transient" (retry may succeed) or "fatal" (demote)."""
    if isinstance(exc, TransientLinkError):
        return "transient"
    if isinstance(exc, (FatalLinkError, DeviceLostError)):
        return "fatal"
    msg = str(exc)
    for marker, kind in LINK_ERROR_MARKERS:
        if marker in msg:
            return kind
    return "fatal"


# The texts of a CUDA runtime error: the kernel launcher's ("<symbol>:
# CUDA error <rc> (<text>)"), PyTorch's ("CUDA error: <text>", raised as
# torch.AcceleratorError or RuntimeError) and its allocator's
# (torch.cuda.OutOfMemoryError, "CUDA out of memory").
_CUDA_FAULT_TEXTS = ("CUDA error", "CUDA out of memory")


def is_link_fault(exc: BaseException) -> bool:
    """True for what a lost or flaky link raises: the seam's own
    LinkError, or a CUDA runtime error.  Nothing else is the link's: a
    kernel build that failed, a wrong argument or a bug in a wrapper or
    a plain version reaches the caller as it was raised, and the engine
    neither retries it nor demotes for it."""
    if isinstance(exc, (LinkError, torch.cuda.OutOfMemoryError)):
        return True
    return isinstance(exc, RuntimeError) and any(t in str(exc) for t in _CUDA_FAULT_TEXTS)


def _host_tensor(array: np.ndarray, device) -> torch.Tensor:
    """numpy u64/u32 array -> int64/int32 tensor with the same bits."""
    a = np.ascontiguousarray(array)
    if a.dtype.itemsize == 8:
        return from_u64(a, device)
    return torch.from_numpy(a.view(np.int32)).to(device)


class DeviceLink:
    """Every host<->device crossing the engine makes, behind one seam.

    The engine calls no upload, launch or fetch itself; it goes through
    this object, so the chaos harness (testing/chaos.py) can interpose a
    seeded fault-injecting shim, and retry and classification live in
    one place (DeviceEngine._retry).  Stages: "h2d" (uploads and the
    stream synchronisation), "dispatch" (kernel launches), "fetch" (d2h
    reads), "probe" (the health check)."""

    def device_put(self, array, device) -> torch.Tensor:
        """A pageable upload of a numpy array (same bits), or a tensor
        moved to `device` (itself when it lies there)."""
        if isinstance(array, torch.Tensor):
            return array.to(device)
        return _host_tensor(array, device)

    def block_until_ready(self, device) -> None:
        """Wait for the work queued on `device`'s current stream."""
        device = torch.device(device)
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()

    def fetch(self, tensor: torch.Tensor) -> np.ndarray:
        """The tensor's values on the host (its own dtype)."""
        return tensor.detach().cpu().numpy()

    def dispatch(self, fn, *args):
        return fn(*args)

    def probe(self, device) -> None:
        """A four-word upload and fetch; raises if the link is dead."""
        echo = self.fetch(self.device_put(np.arange(4, dtype=np.uint64), device))
        if int(echo.view(np.uint64)[3]) != 3:
            raise FatalLinkError("probe round trip corrupted")


def _launch_total() -> int:
    """Kernel launches counted so far (every binding adds one where it
    launches): the retry rule's proof that no kernel of a failed
    crossing ran."""
    return sum(kernels.launches.values())


class ReplyFuture:
    """Reply bytes that materialize at the batch's window rotation.

    A future always terminates: it resolves with exact reply bytes
    (device summary, or host replay after a demotion) or fails with a
    typed error — ``result()`` never strands the caller when the link
    dies mid-window."""

    __slots__ = ("_value", "_engine", "_exc")

    def __init__(self, engine=None, value: bytes | None = None) -> None:
        self._value = value
        self._engine = engine
        self._exc: BaseException | None = None

    def done(self) -> bool:
        return self._value is not None or self._exc is not None

    def resolve(self, value: bytes) -> None:
        self._value = value

    def fail(self, exc: BaseException) -> None:
        self._exc = exc

    def result(self) -> bytes:
        if self._value is None and self._exc is None and self._engine is not None:
            self._engine.drain()
        if self._exc is not None:
            raise self._exc
        if self._value is None:
            raise DeviceLostError("drain", "reply never materialized and no host replay ran")
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


def _remap_pk(kind: str, pk: np.ndarray, rows: np.ndarray, A: int) -> np.ndarray:
    """A packed batch's copy with its slot words moved onto the compact
    table of `rows` (sharded.compact_rows): each word holds slot + 1, 0
    meaning none, and is remapped by sharded.remap_slots (0 stays 0).
    The tight format holds its slots in u32 columns 1 and 2; the others
    in the two u32 halves of COL_SLOTS (and COL_TP_SLOTS for the
    two-phase kinds)."""

    def move(word):
        return sharded.remap_slots(word.astype(np.int64) - 1, rows, A) + 1

    out = np.array(pk, copy=True)
    if kind == "orderfree_tight":
        for col in (1, 2):
            out[:, col] = move(out[:, col]).astype(np.uint32)
        return out
    cols = [dk.COL_SLOTS] + ([dk.COL_TP_SLOTS] if kind in ("two_phase", "two_phase_lo") else [])
    for col in cols:
        w = out[:, col]
        lo = move(w & _MASK32_NP).astype(np.uint64)
        hi = move(w >> np.uint64(32)).astype(np.uint64)
        out[:, col] = lo | (hi << np.uint64(32))
    return out




class DeviceEngine:
    """Authoritative device tables + windowed semantic dispatch.

    `plain=True` runs the plain PyTorch versions of the kernels on the
    engine's device instead of the kernels — the reference run the chip
    smoke test compares the kernels' end-to-end results against."""

    def __init__(self, capacity: int, mirror, device, plain: bool = False,
                 devices=None, link: DeviceLink | None = None,
                 seed: int | None = None) -> None:
        """`devices`: the devices the tables may shard over (the
        reference's jax.devices()); None or one device keeps one dense
        table on `device`, which must be the list's first.  `link`: the
        DeviceLink every crossing goes through (tests pass a chaos
        shim).  `seed`: the scrub jitter's (default: the capacity mixed
        with the process's engine ordinal)."""
        self.capacity = capacity
        self.mirror = mirror  # host bookkeeping copy (recovery + parity)
        self.device = device
        self.window = _WINDOW
        self.link = link if link is not None else DeviceLink()
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
        # Multi-device: the tables shard row-wise over `devices` when
        # there are several and the device rows divide among them.
        if devices is not None and sharded.resolve_devices(devices)[0] != resolve_device(device):
            raise ValueError(f"device {device} is not the first of {devices}")
        self.sharding = sharded.row_mesh_for(rows, devices)
        # Lifecycle (types.EngineState): healthy -> degraded on a lost
        # link (the mirror becomes authoritative, every outstanding
        # record is replayed exactly on the host) -> repromoting (probe,
        # re-upload, handshake) -> healthy.
        self.state = EngineState.healthy
        self.last_demotion: str | None = None
        self.last_probe_failure: str | None = None
        self._degraded_submits = 0
        self._closed = False
        # Host seconds of the last demotion's replay, and of the last
        # re-promotion's parts (upload, K2 rebuild, handshake fetch).
        self.last_demotion_replay_s = 0.0
        self.last_repromotion: dict = {}
        # Healthy-mode scrub cadence with a deterministic per-engine
        # offset: it only advances the first scrub, the period stays
        # the cadence.
        global _ENGINE_SEQ
        _ENGINE_SEQ += 1
        if seed is None:
            seed = capacity + 0x85EBCA6B * _ENGINE_SEQ
        self._commit_enabled = envcheck.state_commit() == 1
        self._scrub_every = (
            _SCRUB_EVERY if (self._commit_enabled or _SCRUB_EVERY_SET) else _SCRUB_EVERY_LEGACY
        )
        cap = envcheck.scrub_jitter_cap(self._scrub_every, _SCRUB_JITTER)
        self._scrub_offset = (seed * 0x9E3779B9) % (cap + 1) if cap else 0
        self._last_scrub_fetch = -self._scrub_offset
        self.stat_wave_sharded = 0
        self._wave_scratch = None
        self._inflight_bound = 0
        self.spec_stats = {name: 0 for name in SPEC_COUNTERS}
        # The owning machine's dev_wave.spec.validation_us histogram
        # (None: not recorded).
        self.spec_validation_hist = None
        # Stat counters (the reference's names).
        self.stat_semantic_events = 0
        # Semantic batches submitted, by kind: each record launches its
        # kernel (K1, K5 or K6) once, and again only when exact recovery
        # re-runs a window's later records.
        self.stat_semantic_batches: collections.Counter = collections.Counter()
        self.stat_fallback_batches = 0
        self.stat_fetches = 0
        self.stat_commit_updates = 0
        self.stat_windows = 0  # window launches (the unit of the per-window costs)
        # Link and lifecycle counters.
        self.stat_retries = 0
        self.stat_link_errors = 0
        self.stat_demotions = 0
        self.stat_repromotions = 0
        self.stat_probe_failures = 0
        self.stat_degraded_events = 0
        self.stat_scrubs = 0
        self.stat_scrub_heals = 0
        # Scrubs by the 16-byte compare (K2 probe) and by the full-table
        # localization, full-table fetches paid, and digest repairs
        # (tables equal but a digest drifted: should stay 0).
        self.stat_scrub_cheap = 0
        self.stat_scrub_fallback = 0
        self.stat_full_fetches = 0
        self.stat_commit_repairs = 0
        self.stat_t_h2d = 0.0
        # Sharded, the parts of stat_t_h2d spent on the units' compact
        # rows and on remapping their batches into the upload buffer.
        self.stat_t_rows = 0.0
        self.stat_t_remap = 0.0
        self.stat_t_dispatch = 0.0
        self.stat_t_fetch = 0.0
        self.stat_t_finish = 0.0
        self._meta_host = np.zeros((capacity, 2), np.uint32)
        # Incremental state commitment: device per-row hashes + fold,
        # with the bit-identical host twin on mirror.commitment.
        self.dev_row_hash = None
        self.dev_digest = None
        if self._commit_enabled and mirror.commitment is None:
            mirror.commitment = cm.HostCommitment(capacity, meta_fn=self._twin_meta)
        self._scratch: dict = {}  # kernel family -> its scratch, made at first use
        # The logical table built from the mirror for the host path,
        # keyed by (mirror stamp, capacity, where); write_back drops it
        # (K3 writes it in place).
        self._degraded_cache = None
        self._ring_at = 0
        if not plain and torch.device(device).type == "cuda":
            # Every kernel library built and loaded before the first
            # crossing: a failed build raises here, never as a lost link.
            kernels.load_all()
        try:
            self.ring = self._zeros((_RING, dk.SUMMARY_WORDS), torch.int64)
            self.balances = self._place(self._zeros((rows, 8), torch.int64))
            self.meta = self._place(self._zeros((rows, 2), torch.int32))
            self._commit_rebuild()
        except DeviceLostError as exc:
            # Born degraded: the link was already dead.  CPU placeholders
            # give the accessors well-typed tables; re-promotion replaces
            # them from the mirror.  Counted as a demotion.
            self.state = EngineState.degraded
            self.stat_demotions += 1
            self.last_demotion = repr(exc)
            self.ring = torch.zeros((_RING, dk.SUMMARY_WORDS), dtype=torch.int64)
            self.balances = torch.zeros((rows, 8), dtype=torch.int64)
            self.meta = torch.zeros((rows, 2), dtype=torch.int32)
            self.dev_row_hash = self.dev_digest = None
        # Window pipeline: _pending accumulates host-side; _launched is
        # the window executing on the device; _recovering holds a
        # window mid-recovery, detached so a re-entrant drain cannot
        # rotate it, but still owned so a demotion replays it.
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

    # ------------------------------------------------------------------
    # Link crossings: bounded retry + transient/fatal classification.
    # Every upload, launch and fetch funnels through _retry, so a flaky
    # link costs backoff and a dead one raises one typed error
    # (DeviceLostError) that the lifecycle guards catch.

    def _retry(self, fn, stage: str):
        """Run one crossing, reissuing it after a transient error.

        Only a link fault (is_link_fault: a LinkError from the seam, a
        CUDA runtime error on the card) is retried or turned into
        DeviceLostError, on which the callers demote; any other error is
        raised as it was.  The port's kernels write the tables in place
        (K1, K4, K5 and the rest are not pure, as the reference's jitted
        functions are), so a launch crossing is reissued only when it
        raised before a kernel of it launched: a link's own LinkError
        (the seam raises it before calling through), or on the card a
        transient error with the launch counts unchanged since the
        attempt began (an allocation that failed).  An error from a
        launch or after one is fatal, as is, off the card, any error
        from inside a call (its plain versions are not counted); the
        demotion then replays exactly from the mirror.  Uploads and
        fetches write no table and are always reissuable."""
        delay_s = _BACKOFF_MS / 1e3
        attempt = 0
        while True:
            launched = _launch_total()
            try:
                return fn()
            except Exception as exc:  # noqa: BLE001
                if isinstance(exc, DeviceLostError) or not is_link_fault(exc):
                    raise
                self.stat_link_errors += 1
                reissuable = (
                    stage != "dispatch"
                    or isinstance(exc, LinkError)
                    or (not self._plain and self.device.type == "cuda"
                        and _launch_total() == launched)
                )
                if classify_link_error(exc) != "transient" or attempt >= _RETRIES or not reissuable:
                    raise DeviceLostError(stage, exc) from exc
                attempt += 1
                self.stat_retries += 1
                if delay_s > 0:
                    _time.sleep(delay_s)
                delay_s = min(delay_s * 2, _BACKOFF_CAP_MS / 1e3)

    def _put(self, array, device=None) -> torch.Tensor:
        """Upload a numpy array (same bits) to `device` (the engine's)."""
        dev = self.device if device is None else device
        return self._retry(lambda: self.link.device_put(array, dev), "h2d")

    def _run(self, fn, *args):
        """One launch crossing: fn(*args) (a kernel wrapper, or a
        closure of the launches one unit makes)."""
        return self._retry(lambda: self.link.dispatch(fn, *args), "dispatch")

    def _fetch(self, tensor: torch.Tensor) -> np.ndarray:
        return self._retry(lambda: self.link.fetch(tensor), "fetch")

    def _fetch_u64(self, fn, *args) -> np.ndarray:
        """Launch fn(*args) and fetch its int64 result as u64 (one
        crossing: nothing it launches writes a table)."""
        return self._retry(
            lambda: self.link.fetch(self.link.dispatch(fn, *args)), "fetch"
        ).view(np.uint64)

    def _zeros(self, shape, dtype) -> torch.Tensor:
        return self._run(lambda: torch.zeros(shape, dtype=dtype, device=self.device))

    def _place(self, src):
        """A dense table (numpy, same bits, or a tensor) on the engine's
        device as the engine holds it (split over the mesh when
        sharded)."""
        return self._retry(
            lambda: sharded.place(self.link.device_put(src, self.device), self.sharding,
                                  self._plain),
            "h2d",
        )

    @property
    def device_rows(self) -> int:
        """Rows of the device tables (hot_rows under tiering)."""
        return self.meta.rows if self.sharding is not None else self.meta.shape[0]

    def _scratch_for(self, kind: str):
        """The scratch of `kind`'s kernel family (None for the plain
        versions and on the CPU).  Sized for the device rows, so it also
        serves a sharded engine's compact tables; made inside the launch
        crossing that first needs it."""
        if self._plain or self.device.type == "cpu":
            return None
        family = dk.FAMILY[kind]
        if family not in self._scratch:
            self._scratch[family] = dk.new_scratch(family, self.device_rows, self.device)
        return self._scratch[family]

    # ------------------------------------------------------------------
    # Moving state in and out (bit for bit, numpy u64/u32 layouts).

    def from_numpy_tables(self, balances_u64, meta_u32, row_hash_u64=None,
                          digest_u64=None) -> None:
        """Replace the device tables from numpy (A, 8) u64 balances and
        (A, 2) u32 meta.  Row hashes + digest are taken as given when
        supplied, else rebuilt on the device.  The engine must hold no
        in-flight work and be healthy."""
        if self.has_inflight():
            raise RuntimeError("from_numpy_tables with batches in flight")
        if self.hot is not None:
            raise RuntimeError("from_numpy_tables takes logical tables: not on a tiered engine")
        if self.state is not EngineState.healthy:
            raise RuntimeError(f"from_numpy_tables on a {self.state.value} engine")
        balances_u64 = np.asarray(balances_u64, np.uint64)
        meta_u32 = np.asarray(meta_u32, np.uint32)
        if balances_u64.shape != (self.capacity, 8) or meta_u32.shape != (self.capacity, 2):
            raise ValueError(
                f"tables must be ({self.capacity}, 8) and ({self.capacity}, 2), "
                f"got {balances_u64.shape} and {meta_u32.shape}"
            )
        self.balances = self._place(balances_u64)
        self.meta = self._place(meta_u32)
        self._meta_host = meta_u32.copy()
        if row_hash_u64 is None or not self._commit_enabled:
            self._commit_rebuild()
        else:
            self.dev_row_hash = self._place(np.asarray(row_hash_u64, np.uint64))
            self.dev_digest = self._put(np.asarray(digest_u64, np.uint64))

    def to_numpy_tables(self):
        """(balances (A, 8) u64, meta (A, 2) u32, row_hash (A, 2) u64 or
        None, digest (2,) u64 or None) — drains and flushes first.  The
        device tables: hot-shaped under tiering; degraded, the host
        images they will be re-uploaded from."""
        self.drain()
        self.flush()
        if self.state is not EngineState.healthy:
            if self.hot is not None:
                return self._mirror_hot_table_np(), self._meta_hot_np(), None, None
            return self.mirror.table8(self.capacity), self._meta_host.copy(), None, None
        balances = self._fetch_u64(sharded.dense, self.balances)
        meta = self._fetch(self._run(sharded.dense, self.meta)).view(np.uint32)
        if self.dev_row_hash is None:
            return balances, meta, None, None
        return (
            balances, meta, self._fetch_u64(sharded.dense, self.dev_row_hash),
            self._fetch(self.dev_digest).view(np.uint64),
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
        if self.state is not EngineState.healthy:
            # The host copy above is authoritative while degraded;
            # re-promotion re-uploads the whole meta table from it.
            return
        self._queue_meta(
            slots,
            np.broadcast_to(np.asarray(acct_flags, np.uint32), slots.shape).copy(),
            np.broadcast_to(np.asarray(acct_ledger, np.uint32), slots.shape).copy(),
        )

    def remove_accounts(self, slots) -> None:
        """Linked create_accounts rollback support."""
        slots = np.asarray(slots, np.int64)
        self._meta_host[slots] = 0
        if self.mirror.commitment is not None:
            self.mirror.commitment.refresh(slots, self.mirror)
        if self.state is not EngineState.healthy:
            return  # see add_accounts
        z = np.zeros(len(slots), np.uint32)
        self._queue_meta(slots, z, z)

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
        # Capacity is committed before any link work: a demotion
        # mid-widen serves from the mirror at the new capacity, and
        # re-promotion rebuilds both tables from the mirror at it.
        self.capacity = capacity
        if self.hot is not None:
            # The device tables keep their hot-row geometry: logical
            # growth widens only the maps (new rows are cold and zero,
            # so the hot partial does not move).
            self.hot.grow_logical(capacity)
            return
        was_sharding = self.sharding
        if self.sharding is not None and capacity % self.sharding.shape["shard"]:
            self.sharding = None  # one dense table from here on
        self._scratch = {}
        if self.state is not EngineState.healthy:
            return

        def widen(table):
            dense = table.join() if was_sharding is not None else table
            return hot_tier.grow_zero_device(dense, capacity)

        try:
            self.balances = self._place(self._run(widen, self.balances))
            self.meta = self._place(self._run(widen, self.meta))
            # Zero rows hash to 0, so the digest VALUE is unchanged, but
            # the per-row hash array must match the new geometry.
            self._commit_rebuild()
        except DeviceLostError as exc:
            self._demote(exc)

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
        (its touched set is wider than the hot set, nothing can be
        evicted, the engine is not healthy, or the link died during the
        admission): the caller takes the exact host path."""
        if self.hot is None:
            return True
        hot = self.hot
        uniq, missing = hot.plan(np.asarray(slots, np.int64))
        if len(missing) == 0:
            hot.record_use(uniq, len(uniq), 0)
            return True
        if len(uniq) > hot.hot_rows or self.state is not EngineState.healthy:
            return False
        t0 = _time.perf_counter()
        # Quiesce before the map moves; the drain can itself demote.
        self.drain()
        self.flush()
        if self.state is not EngineState.healthy:
            return False
        got = hot.admit(missing, protect=uniq)
        if got is None:
            return False
        admitted, hot_slots, _evicted = got
        try:
            self._tier_upload(admitted, hot_slots)
        except DeviceLostError as exc:
            self._demote(exc)
            return False
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
        commit = self._commit_enabled and self.dev_row_hash is not None
        twin = self.mirror.commitment
        hot_slots = np.asarray(hot_slots, np.int64)
        if self.sharding is not None:
            self._run(self._tier_upload_sharded, admitted, hot_slots, commit)
            return
        idx = self._put(hot_slots)
        self._run(self._set_rows, self.balances, idx, self._put(self.mirror.rows8(admitted)))
        self._run(self._set_rows, self.meta, idx, self._put(self._meta_host[admitted]))
        if commit:
            self._run(self._cm["admit"], self.dev_row_hash, self.dev_digest, idx,
                      self._put(twin.row_lo[admitted]), self._put(twin.row_hi[admitted]))

    def _tier_upload_sharded(self, admitted, hot_slots, commit) -> None:
        """K10 and K2 admit on each shard for the slots it owns (one
        launch crossing); each shard's admit moves a zero digest by its
        new - old, and the moves add up on home."""
        twin = self.mirror.commitment
        moves = []
        for s, idx, pos in self.balances.owned(hot_slots):
            dev, rows = idx.device, admitted[pos]
            self._set_rows(self.balances.shards[s], idx, from_u64(self.mirror.rows8(rows), dev))
            self._set_rows(self.meta.shards[s], idx, _host_tensor(self._meta_host[rows], dev))
            if commit:
                moves.append(self._cm["admit"](
                    self.dev_row_hash.shards[s], torch.zeros(2, dtype=torch.int64, device=dev),
                    idx, from_u64(twin.row_lo[rows], dev), from_u64(twin.row_hi[rows], dev),
                )[1])
        if moves:
            self.dev_digest += self.balances.sum(moves)

    # ------------------------------------------------------------------
    # Semantic dispatch.

    def submit(self, kind, pk, n, ts_base, finish, fallback,
               id_keys=None, bound=0) -> ReplyFuture:
        """Queue one semantic batch; returns its reply future.
        `finish(summary) -> bytes` runs at materialization; `fallback()
        -> bytes` re-executes the batch exactly on the host; `bound` is
        the batch's amount bound (the wave admission's in-flight term).
        Degraded, the batch never touches the link: it resolves at once
        through the exact host path (bit-identical reply)."""
        self.stat_semantic_batches[kind] += 1
        return self._submit_record(
            n, fallback,
            lambda fut: _InFlight(kind, fut, finish, pk=pk, n=n, ts_base=ts_base,
                                  fallback=fallback, id_keys=id_keys, bound=bound),
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
            n, fallback,
            lambda fut: _InFlight("waves", fut, finish, n=n, ts_base=ts_base,
                                  fallback=fallback, id_keys=id_keys, bound=bound,
                                  wave_args=(packed, plan)),
        )

    def submit_speculative(self, ev, dstat_init, n, ts_base, spec_serial, pv_serial,
                           finish, fallback, id_keys=None, bound=0) -> ReplyFuture:
        """Queue one SPECULATIVE batch: at launch the whole batch runs as
        one validated step and only a conflicted residue replays through
        a plan (_exec_spec).  `spec_serial` marks the events the step
        does not model (chain members, history events, serialized
        post/voids); `pv_serial` is the submit-time routing fact the
        residue planner reuses.  `bound` must be the WHOLE batch's bound:
        a demotion replays the whole batch through the host fallback,
        and a later record's admission must count everything this one
        can still apply."""
        packed = waves.pack_spec_record(ev, dstat_init, spec_serial, n)
        return self._submit_record(
            n, fallback,
            lambda fut: _InFlight("spec", fut, finish, n=n, ts_base=ts_base,
                                  fallback=fallback, id_keys=id_keys, bound=bound,
                                  wave_args=(packed, bool(pv_serial))),
        )

    def _submit_record(self, n, fallback, make_rec) -> ReplyFuture:
        """The one stream-entry protocol of semantic and wave records:
        degraded check, flush (earlier host-resolved deltas land first;
        the flush itself may lose the link), degraded re-check, enqueue,
        count the record's bound in flight, rotate at the window
        boundary."""
        if self.state is EngineState.healthy:
            self.flush()
        if self.state is not EngineState.healthy:
            fut = ReplyFuture(self)
            self.stat_degraded_events += n
            self._resolve_host_now(fut, fallback)
            return fut
        fut = ReplyFuture(self)
        rec = make_rec(fut)
        self._pending.append(rec)
        self._pending_semantic += 1
        self._inflight_bound += rec.bound
        if self._pending_semantic >= self.window:
            try:
                self._rotate()
            except DeviceLostError as exc:
                self._demote(exc)
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
        mirror (exact: the drain put every earlier batch there), as they
        do while degraded."""
        slots = np.asarray(slots, np.int64)

        def from_mirror() -> ReplyFuture:
            fut = ReplyFuture(self)
            self._resolve_host_now(fut, lambda: finish(self.mirror.rows8(slots)))
            return fut

        if self.state is not EngineState.healthy:
            return from_mirror()
        if not self.tier_prefetch(slots):
            self.drain()
            self.flush()
            return from_mirror()
        # Earlier host-resolved deltas must be visible to the gather.
        self.flush()
        if self.state is not EngineState.healthy:
            return from_mirror()
        fut = ReplyFuture(self)
        self._pending.append(_InFlight(
            "lookup", fut, finish, slots=slots,
            hot_slots=None if self.hot is None else self.hot.translate(slots),
        ))
        return fut

    @staticmethod
    def _resolve_host_now(fut: ReplyFuture, produce) -> None:
        try:
            fut.resolve(produce())
        except Exception as exc:  # noqa: BLE001
            # A host-path failure still terminates the future; the
            # caller sees the real error at result().
            fut.fail(exc)
            raise

    def _gather(self, rec: _InFlight):
        slots = rec.slots if rec.hot_slots is None else rec.hot_slots
        pad = ((len(slots) + 255) & ~255) or 256
        sl = np.full(pad, -1, np.int64)
        sl[: len(slots)] = slots
        if self.sharding is not None:
            # K14 gathers zeros for -1 (no shard owns it); a slot past
            # the table clips to its last row, as dk.lookup's does.
            sl = np.where(sl >= 0, np.minimum(sl, self.device_rows - 1), -1)
            return self._run(self.balances.gather, self._put(sl))
        return self._run(dk.lookup, self.balances, self._put(sl))

    def _meta_update(self, rec: _InFlight) -> None:
        slots, flags, ledger = rec.meta_args
        if self.sharding is not None:
            # A K14 scatter of the (flags, ledger) rows (the slots are
            # distinct: a range of new accounts); a slot no shard owns
            # drops, as dk.meta_update's does.
            rows = np.stack([flags, ledger], axis=1).astype(np.uint32)
            self._run(self.meta.scatter, self._put(np.asarray(slots, np.int64)), self._put(rows))
            return
        self._run(dk.meta_update, self.meta, self._put(np.asarray(slots, np.int64)),
                  self._put(flags), self._put(ledger))

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
        self.stat_windows += 1
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
        # Sharded: each unit's compact rows; its batches are uploaded
        # with their slots remapped onto them.
        unit_rows: dict[int, np.ndarray] = {}
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
            if self.sharding is not None:
                t_rows = _time.perf_counter()
                unit_rows[i] = self._unit_rows(urecs)
                t_remap = _time.perf_counter()
                self.stat_t_rows += t_remap - t_rows
            for g, rec in enumerate(urecs):
                big[cur + g] = rec.pk if i not in unit_rows else _remap_pk(
                    rec.kind, rec.pk, unit_rows[i], self.device_rows)
                ns[cur + g] = rec.n
                tsb[cur + g] = rec.ts_base
            if i in unit_rows:
                self.stat_t_remap += _time.perf_counter() - t_remap
            offsets[i] = cur
            bufs[spec][3] = cur + len(urecs)
        dev_bufs = {
            spec: (self._put(big), ns, tsb)
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
                ring_at = self._ring_at
                with self._compact(unit_rows.get(i)) as (bal, meta):
                    self._run(lambda: dk.run_window(
                        kind, bal, meta, self.ring, ring_at, big, offsets[i], len(urecs), ns,
                        tsb, scratch=self._scratch_for(kind), fn=self._kfn[kind],
                    ))
                for g, rec in enumerate(urecs):
                    rec.ring_at = (self._ring_at + g) % _RING
                self._ring_at = (self._ring_at + len(urecs)) % _RING
        self.stat_t_dispatch += _time.perf_counter() - t1
        # Absorb the window's touched rows into the device commitment:
        # one extra launch per window.
        self._commit_records(recs)

    def _unit_rows(self, recs) -> np.ndarray:
        """A sharded unit's compact rows: every row its batches can
        touch (_touched_of_pk), with the clip rows."""
        return sharded.compact_rows(
            np.concatenate([_touched_of_pk(r.kind, r.pk, r.n) for r in recs]), self.device_rows)

    @contextlib.contextmanager
    def _compact(self, rows):
        """(balances, meta) for a row kernel: the engine's tables when
        dense (`rows` None); sharded, the K14 gather of `rows` onto home,
        whose balances are K14-scattered back onto their owners after
        the body (the row kernels write no meta).  The K2 update of
        `rows` then runs on the same compact table, so the unit's
        records need none at the end of the window (_commit_records)."""
        if rows is None:
            yield self.balances, self.meta
            return
        slots = self._put(rows)
        bal, meta = self._run(self.balances.gather, slots), self._run(self.meta.gather, slots)
        yield bal, meta
        self._run(self.balances.scatter, slots, bal)
        self._commit_compact(rows, slots, bal, meta)

    def _dispatch(self, rec: _InFlight) -> None:
        """Immediate single-batch launch (recovery re-dispatch path),
        with the kernel of the batch's own kind."""
        rows = None if self.sharding is None else self._unit_rows([rec])
        pk = rec.pk if rows is None else _remap_pk(rec.kind, rec.pk, rows, self.device_rows)
        pk_t = self._put(pk)
        ring_at = self._ring_at
        with self._compact(rows) as (bal, meta):
            self._run(lambda: self._kfn[rec.kind](
                bal, meta, self.ring, ring_at, pk_t, rec.n,
                rec.ts_base, scratch=self._scratch_for(rec.kind),
            ))
        rec.ring_at = self._ring_at
        self._ring_at = (self._ring_at + 1) % _RING

    def _wave_scratch_dev(self):
        if self._plain or self.device.type != "cuda":
            return None
        if self._wave_scratch is None:
            self._wave_scratch = waves.WaveScratch(self.device)
        return self._wave_scratch

    def wave_mesh(self):
        """The row mesh a sharded engine's wave records run over (a 1-D
        ("shard",) mesh whose shard count divides the capacity), else
        None: the router then declines wave dispatch ("mesh")."""
        if self.sharding is None or self.capacity % self.sharding.shape["shard"]:
            return None
        return self.sharding

    def _exec_waves(self, rec: _InFlight) -> None:
        """Execute a wave record's plan against the device table, in
        place (waves.run_plan_engine; sharded, the sharded executor on
        the shard tables), as one launch crossing; the packed outputs
        are fetched at rotation like a lookup gather.  An error after
        the first launch leaves part of the batch applied, so it is
        fatal (_retry) and the demotion replays the batch from the
        mirror, which holds exactly the batches before it."""
        packed_rec, plan = rec.wave_args
        ev, dstat_init, hist_fix = waves.unpack_wave_record(packed_rec)
        if self._commit_enabled:
            rec.touched = waves.touched_slots(ev, rec.n)
        mesh = self.wave_mesh()
        if self.sharding is not None and mesh is None:
            raise RuntimeError("a wave record on a sharded engine without a wave mesh")
        rec.handle = self._run(lambda: waves.run_plan_engine(
            self.balances if mesh is None else self.balances.shards, ev, dstat_init, rec.n,
            rec.ts_base, plan, hist_fix, mesh, scratch=self._wave_scratch_dev(),
            plain=self._plain,
        ))
        # Counted only after the launch succeeded (the reference's
        # forensics, :1428-1433).
        if mesh is not None:
            self.stat_wave_sharded += 1

    def _exec_spec(self, rec: _InFlight) -> None:
        """Execute a speculative record: one whole-batch step with the
        on-device validation, the conflict flags fetched (the validation
        synchronisation: later records read the table, so the verdict
        cannot wait for rotation), then only on a miss plan_residue over
        the conflicted events and the carry-threaded replay.  The step
        writes the table in place, so the step, the flags' fetch and the
        finish are three crossings of their own (_retry reissues each
        alone, a launch only before it launched): a fault on the fetch
        or the finish must not run the step a second time.  The
        reference retries the whole record from its table handle, which
        its executor never donates."""
        if self.sharding is not None:
            raise RuntimeError("speculative records do not run on a sharded engine")
        packed_rec, pv_serial = rec.wave_args
        ev, dstat_init, spec_serial = waves.unpack_spec_record(packed_rec)
        if self._commit_enabled:
            rec.touched = waves.touched_slots(ev, rec.n)
        n = rec.n
        B = len(ev["flags"])

        def run():
            scratch = self._wave_scratch_dev()
            t0 = _time.perf_counter()
            carry, confl = self._run(
                lambda: waves.run_speculative_engine(
                    self.balances, ev, dstat_init, spec_serial, n, rec.ts_base,
                    scratch=scratch, plain=self._plain,
                ))
            confl_np = self._fetch(confl).astype(bool)[:n]
            val_s = _time.perf_counter() - t0
            residue = np.flatnonzero(confl_np)
            hist = np.zeros(B, bool)
            if len(residue) == 0:
                hist[:n] = True
                out = self._run(
                    lambda: waves.finalize_engine(self.balances, carry, hist, plain=self._plain))
                return out, 0, 1, val_s, 0.0
            t1 = _time.perf_counter()
            meta = resolve.spec_meta_from_events(ev, n, pv_serial)
            plan = waves.plan_residue(n, meta, residue)
            plan_s = _time.perf_counter() - t1
            # Committed events and residue wave/chain events take
            # batch-final snapshots; residue scan events keep their
            # sequential ones.
            hist[:n] = ~confl_np
            hist[:n] |= plan.wave_mask
            out = self._run(lambda: waves.continue_plan_engine(
                self.balances, carry, ev, n, rec.ts_base, plan, hist,
                scratch=scratch, plain=self._plain,
            ))
            return out, len(residue), 1 + plan.n_steps, val_s, plan_s

        st = self.spec_stats
        st["attempts"] += 1
        rec.handle, residue_n, steps, val_s, plan_s = run()
        if residue_n == 0:
            st["hits"] += 1
            st["plan_skipped"] += 1
        else:
            st["residue_events"] += residue_n
            st["residue_plan_s"] += plan_s
        st["steps"] += steps
        st["validation_s"] += val_s
        if self.spec_validation_hist is not None:
            self.spec_validation_hist.observe(val_s * 1e6)

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
            ring_np = self._fetch(self.ring).view(np.uint64)
        for rec in recs:
            if rec.kind in ("lookup",) + _WAVE_KINDS and rec.handle is not None:
                rec.rows = self._fetch(rec.handle).view(np.uint64)
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
        with the device's work on the new one.

        Raises DeviceLostError on a lost link; records move between
        _launched and _pending only after the crossing that covers them
        succeeded, so _demote always finds every unresolved record in
        the stream lists, in order."""
        prev = self._launched
        ring_np = self._fetch_ring(prev) if prev else None
        if prev and (ring_np is None or self._window_clean(prev, ring_np)):
            nxt = self._pending
            self._launch(nxt)  # may raise: prev + nxt stay tracked
            self._launched = nxt
            self._pending = []
            self._pending_semantic = 0
            self._resolve_clean(prev, ring_np)  # host only, cannot lose
            return
        if prev:
            # A flagged batch in the window: serial exact recovery
            # first, with the window detached from _launched (a demotion
            # mid-recovery replays it from _recovering).
            self._launched = []
            self._recovering = prev
            self._resolve_recovery(prev, ring_np)
            self._recovering = []
        self._launched = []
        nxt = self._pending
        self._launch(nxt)  # may raise: nxt still in _pending
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
            self._commit_records(covered)
            ring_np = None

    def _upload_from_mirror(self) -> None:
        """Re-upload the balance table from the mirror (its hot image
        under tiering) and re-derive the device commitment from scratch
        (reads the current device meta, so a caller that re-uploads
        meta too does so first)."""
        src = (self._mirror_hot_table_np() if self.hot is not None
               else self.mirror.table8(self.capacity))
        self.balances = self._place(src)
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
        return self._fetch_u64(sharded.checksum, self.balances, self._checksum)

    def _device_health_digest(self) -> np.ndarray:
        """Balance digest + meta digest of the device tables (K11 on
        each): what the host's copies are compared with."""
        meta = self._fetch_u64(sharded.checksum, self.meta, self._checksum)
        return np.concatenate([self._device_checksum(), meta])

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
        flushed first): K11 on the device table all-resident and
        healthy; the mirror's (computed on the host, no device work)
        while degraded, and tiered, where the logical table is the
        mirror's, which the drain made current."""
        self.drain()
        self.flush()
        if self.state is not EngineState.healthy or self.hot is not None:
            return self.mirror.checksum8(self.capacity)
        try:
            return self._device_checksum()
        except DeviceLostError as exc:
            self._demote(exc)
            return self.mirror.checksum8(self.capacity)

    def _localize_divergence(self) -> np.ndarray:
        """The full-table fetch, run only after a digest compare failed
        (or on the deep-scrub cadence): the logical rows where the
        device tables differ from the host's copies (hot-shaped tables
        compared under tiering)."""
        self.stat_full_fetches += 1
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

    def restore_tables(self, acct_flags, acct_ledger) -> None:
        """A restored machine's fresh engine: the account meta of slots
        [0, n) into the host copy, then both device tables re-uploaded
        from the host copies with the K2 rebuild (_heal_from_mirror); a
        lost link demotes, the restored mirror being authoritative."""
        n = len(acct_flags)
        self._meta_host[:n, 0] = acct_flags
        self._meta_host[:n, 1] = acct_ledger
        if self.state is not EngineState.healthy:
            return
        try:
            self._heal_from_mirror()
        except DeviceLostError as exc:
            self._demote(exc)

    def _heal_from_mirror(self) -> None:
        """Re-upload both tables from the host copies (meta first: the
        commitment rebuild inside _upload_from_mirror hashes it)."""
        meta_src = self._meta_hot_np() if self.hot is not None else self._meta_host
        self.meta = self._place(meta_src)
        self._upload_from_mirror()

    # ------------------------------------------------------------------
    # Incremental state commitment (kernel K2).

    def _twin_meta(self, slots: np.ndarray) -> np.ndarray:
        """Meta columns for a standalone engine's host twin."""
        out = np.zeros((len(slots), 2), np.uint32)
        m = slots < len(self._meta_host)
        out[m] = self._meta_host[slots[m]]
        return out

    def _commit_rows(self, row0: int = 0, count: int | None = None,
                     device=None) -> torch.Tensor:
        """Logical-row binding of device rows [row0, row0 + count) (all
        of them by default) for the commitment kernels: identity
        all-resident, logical_of tiered.  A free hot slot binds to row 0:
        its all-zero content hashes to (0, 0) whatever the binding, so
        the digest is exactly the hot partial of the logical table.
        Called inside the launch crossing that reads it."""
        count = self.device_rows if count is None else count
        device = self.device if device is None else device
        if self.hot is None:
            return torch.arange(row0, row0 + count, dtype=torch.int64, device=device)
        lof = self.hot.logical_of[row0 : row0 + count]
        return torch.from_numpy(np.where(lof >= 0, lof, 0)).to(device)

    def _shard_rows(self):
        """Sharded: (balances, meta, logical rows) of every shard."""
        L = self.balances.local_rows
        return [
            (b, m, self._commit_rows(s * L, L, b.device))
            for s, (b, m) in enumerate(zip(self.balances.shards, self.meta.shards))
        ]

    def _commit_rebuild(self) -> None:
        if not self._commit_enabled:
            return
        if self.sharding is None:
            self.dev_row_hash, self.dev_digest = self._run(
                lambda: self._cm["rebuild"](self.balances, self.meta, self._commit_rows()))
            return

        # Each shard hashes its rows under their global ids; the fold is
        # a wrapping sum, so the shards' folds add up on home.
        def rebuild():
            parts = [self._cm["rebuild"](b, m, rows) for b, m, rows in self._shard_rows()]
            return (sharded.ShardedTable(self.sharding, [p[0] for p in parts], self._plain),
                    self.balances.sum([p[1] for p in parts]))

        self.dev_row_hash, self.dev_digest = self._run(rebuild)

    def _commit_update(self, slots) -> None:
        """Absorb the touched rows of one window into the device digest:
        one launch, O(touched).  `slots` index the device tables (hot
        slots under tiering, hashed under their logical rows)."""
        if not self._commit_enabled or self.dev_row_hash is None:
            return
        slots = np.unique(np.asarray(slots, np.int64))
        slots = slots[(slots >= 0) & (slots < self.device_rows)]
        if len(slots) == 0:
            return
        if self.sharding is not None:
            self._commit_update_sharded(slots)
            return
        padded_np = cm.pad_slots(slots)
        padded = self._put(padded_np)
        rows = padded
        if self.hot is not None:
            lof = self.hot.logical_of[np.maximum(padded_np, 0)]
            rows = self._put(np.where(padded_np >= 0, lof, 0))
        self.stat_commit_updates += 1
        self._run(self._cm["update"], self.balances, self.meta, self.dev_row_hash,
                  self.dev_digest, padded, rows)

    def _commit_update_sharded(self, slots: np.ndarray) -> None:
        """K2 update of the distinct device `slots`: their balances and
        meta K14-gathered onto home, then _commit_compact."""
        idx = self._put(slots)
        self._commit_compact(slots, idx, self._run(self.balances.gather, idx),
                             self._run(self.meta.gather, idx))

    def _commit_compact(self, slots: np.ndarray, idx, bal, meta) -> None:
        """K2 update on a compact table (`bal`, `meta`) of the distinct
        device rows `slots` (`idx` on home): their row hashes
        K14-gathered, K2 over compact positions hashing under the global
        (logical) rows, the new hashes K14-scattered back; the digest
        lives on home.  A row the unit left unchanged hashes as before
        and does not move the digest."""
        if not self._commit_enabled or self.dev_row_hash is None:
            return
        rows = slots if self.hot is None else np.where(
            self.hot.logical_of[slots] >= 0, self.hot.logical_of[slots], 0)
        rows_t = self._put(np.asarray(rows, np.int64))
        self.stat_commit_updates += 1

        def update():
            row_hash = self.dev_row_hash.gather(idx)
            self._cm["update"](
                bal, meta, row_hash, self.dev_digest,
                torch.arange(len(slots), dtype=torch.int64, device=self.device), rows_t,
            )
            self.dev_row_hash.scatter(idx, row_hash)

        self._run(update)

    def _commit_records(self, recs) -> None:
        """Absorb the rows `recs` can have modified into the device
        commitment (one K2 update).  Sharded, the K1 / K5 / K6 records
        were absorbed on their units' compact tables (_compact): only
        meta and wave records remain."""
        if not self._commit_enabled:
            return
        if self.sharding is not None:
            recs = [r for r in recs if r.kind not in _SEMANTIC_KINDS]
        touched = self._collect_touched(recs)
        if touched is not None:
            self._commit_update(touched)

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
        """(2, 2) u64 [maintained digest, from-scratch digest] from one
        K2 probe crossing; the caller holds the engine drained.
        Sharded, each shard's from-scratch fold (a probe against a zero
        digest) adds up on home."""
        if self.sharding is None:
            return self._fetch_u64(lambda: self._cm["probe"](
                self.balances, self.meta, self.dev_digest, self._commit_rows()))

        def probe():
            folds = [
                self._cm["probe"](b, m, torch.zeros(2, dtype=torch.int64, device=b.device),
                                  rows)[1]
                for b, m, rows in self._shard_rows()
            ]
            return torch.stack([self.dev_digest, self.balances.sum(folds)])

        return self._fetch_u64(probe)

    def device_root(self) -> np.ndarray:
        """(2,) u64 maintained device digest (a 16-byte fetch)."""
        return self._fetch(self.dev_digest).view(np.uint64)

    def drain(self) -> None:
        # A drain nested inside exact recovery (the host re-execution
        # may read state) must not touch the stream: the outer
        # recovery finishes it.
        while (self._launched or self._pending) and not self._recovering:
            try:
                self._rotate()
            except DeviceLostError as exc:
                self._demote(exc)

    def close(self) -> None:
        """End-of-life barrier: every outstanding future resolves (by the
        drain, demoting to exact host replay if the link dies) or fails
        with a typed DeviceLostError — no caller blocked in result() is
        stranded."""
        try:
            self.drain()
            self.flush()
        # tbcheck: allow(broad-except): end-of-life barrier — when even
        # the host replay fails, every stranded future must still be
        # terminated with a typed DeviceLostError (never a hang).
        except Exception as exc:
            for rec in self._recovering + self._launched + self._pending:
                if rec.future is not None and not rec.future.done():
                    rec.future.fail(DeviceLostError("close", exc))
            self._recovering = []
            self._launched = []
            self._pending = []
            self._pending_semantic = 0
            self._inflight_bound = 0
            self._q.clear()
            self._queued = 0
        self._closed = True

    # ------------------------------------------------------------------
    # Degraded-mode lifecycle: demote on a lost link, serve exact
    # replies from the host engine against the mirror, probe + re-upload
    # + handshake to re-promote, and the periodic scrub while healthy.

    def _demote(self, exc: BaseException) -> None:
        """Lost link: the host mirror becomes authoritative.  Every
        outstanding future resolves in submission order through the
        exact host path — bit-identical to what the device would have
        replied — and later submits take the host path until a
        re-promotion handshake passes."""
        t0 = _time.perf_counter()
        self.state = EngineState.degraded
        self.stat_demotions += 1
        self.last_demotion = repr(exc)
        self._degraded_submits = 0
        # The device commitment is as dead as the tables it covers; the
        # host twin stays live and re-promotion rebuilds the device side.
        self.dev_row_hash = None
        self.dev_digest = None
        outstanding = self._recovering + self._launched + self._pending
        # Clear before replaying: the host path may drain or read this
        # engine re-entrantly and must see an empty stream.
        self._recovering = []
        self._launched = []
        self._pending = []
        self._pending_semantic = 0
        # Write-behind deltas are on the mirror already; the device copy
        # is abandoned (re-promotion re-uploads the whole table).
        self._q.clear()
        self._queued = 0
        self._degraded_cache = None
        for rec in outstanding:
            self._replay_record_on_host(rec)
        self.last_demotion_replay_s = _time.perf_counter() - t0

    def _replay_record_on_host(self, rec: _InFlight) -> None:
        fut = rec.future
        if fut is None or fut.done():
            self._release_bound(rec)
            return
        try:
            if rec.kind == "lookup":
                fut.resolve(rec.finish(self.mirror.rows8(rec.slots)))
            else:
                self.stat_degraded_events += rec.n
                fut.resolve(rec.fallback())
        # tbcheck: allow(broad-except): the host replay itself failed —
        # fail THIS future with the real error and keep terminating the
        # rest of the stream (one bad record must not strand the rest).
        except Exception as exc:
            fut.fail(exc)
        finally:
            self._release_bound(rec)

    def tick(self) -> None:
        """Periodic lifecycle work, once per committed operation (the
        state machine's commit_async): degraded, a health probe and
        re-promotion attempt every TB_DEV_PROBE_EVERY operations;
        healthy, the scrub every TB_DEV_SCRUB_EVERY ring fetches."""
        if self.state is EngineState.degraded:
            self._degraded_submits += 1
            if self._degraded_submits >= _PROBE_EVERY:
                self._degraded_submits = 0
                self.try_repromote()
            return
        if (
            self._scrub_every
            and self.state is EngineState.healthy
            and self.stat_fetches >= self._last_scrub_fetch + self._scrub_every
        ):
            try:
                self.scrub()
            except DeviceLostError as exc:
                self._demote(exc)

    def try_repromote(self) -> bool:
        """Health probe -> table re-upload from the mirror (K2 rebuild)
        -> handshake.  The device becomes authoritative again only if
        the round-tripped digest equals the host's; any failure leaves
        the engine degraded (and counted), never half-promoted.  A
        sticky CUDA error keeps the probe failing: the process's context
        is not recovered, so the engine stays degraded, as the
        reference's does behind a dead link."""
        if self.state is EngineState.healthy:
            return True
        if self._closed:
            return False
        self.state = EngineState.repromoting
        try:
            t0 = _time.perf_counter()
            self._retry(lambda: self.link.probe(self.device), "probe")
            t1 = _time.perf_counter()
            self._scratch = {}
            self.meta = self._place(
                self._meta_hot_np() if self.hot is not None else self._meta_host)
            self.balances = self._place(
                self._mirror_hot_table_np() if self.hot is not None
                else self.mirror.table8(self.capacity))
            self.ring = self._zeros((_RING, dk.SUMMARY_WORDS), torch.int64)
            self._ring_at = 0
            self._retry(lambda: self.link.block_until_ready(self.device), "h2d")
            t2 = _time.perf_counter()
            self._commit_rebuild()
            self._retry(lambda: self.link.block_until_ready(self.device), "h2d")
            t3 = _time.perf_counter()
            if self._commit_enabled and self.mirror.commitment is not None:
                # The device's freshly rebuilt 16-byte root against the
                # host twin (its hot partial under tiering).
                dev_sum = self.device_root()
                host_sum = self.twin_expected_digest()
            else:
                dev_sum = self._device_health_digest()
                host_sum = self._host_health_digest()
            t4 = _time.perf_counter()
            if not (dev_sum == host_sum).all():
                raise FatalLinkError(
                    "re-promotion checksum handshake mismatch: "
                    f"device={dev_sum.tolist()} host={host_sum.tolist()}"
                )
        except (DeviceLostError, LinkError) as exc:
            # Re-promotion is opportunistic: a lost probe, upload or
            # handshake leaves the engine degraded; the next tick
            # retries.  Any other error is not the link's and raises.
            self.state = EngineState.degraded
            self.stat_probe_failures += 1
            self.last_probe_failure = repr(exc)
            self.dev_row_hash = self.dev_digest = None
            return False
        self.state = EngineState.healthy
        self.stat_repromotions += 1
        self._degraded_cache = None
        self.last_repromotion = dict(probe_s=t1 - t0, upload_s=t2 - t1, rebuild_s=t3 - t2,
                                     handshake_s=t4 - t3)
        return True

    def scrub(self) -> bool:
        """Integrity-compare the device tables against the host while
        idle; heal a divergence by re-uploading from the mirror.  True
        when the tables already matched.  Raises DeviceLostError if the
        link dies mid-scrub (tick demotes).

        With the commitment: one K2 probe crossing — the device's
        maintained digest, its from-scratch recompute (which catches a
        corrupted row no step touched) and the host twin must agree.
        Only a mismatch (or the TB_DEV_SCRUB_FALLBACK deep-scrub
        cadence) pays the full-table fetch, which names the diverged
        rows before the heal.  Without it, the K11 digests of both
        tables against the host's."""
        if self.state is not EngineState.healthy or self.has_inflight() or self._queued:
            return True
        self._last_scrub_fetch = self.stat_fetches
        self.stat_scrubs += 1
        cheap = (self._commit_enabled and self.dev_digest is not None
                 and self.mirror.commitment is not None)
        if cheap:
            self.stat_scrub_cheap += 1
            pair = self.commit_probe()
            host = self.twin_expected_digest()
            clean = bool((pair[0] == pair[1]).all() and (pair[1] == host).all())
            deep_every = envcheck.scrub_fallback_every()
            if clean and not (deep_every and self.stat_scrubs % deep_every == 0):
                return True
        else:
            clean = bool((self._device_health_digest() == self._host_health_digest()).all())
            if clean:
                return True
        # Divergence localization (the full-fetch path) + heal.  A deep
        # scrub that confirms the cheap verdict returns without healing.
        self.stat_scrub_fallback += 1
        rows = self._localize_divergence()
        if len(rows) == 0:
            if not clean:
                # Tables equal byte for byte yet a digest disagreed: the
                # incremental accumulator drifted.  Repaired loudly.
                self.stat_commit_repairs += 1
                if self.mirror.commitment is not None:
                    self.mirror.commitment.rebuild(self.mirror)
                self._commit_rebuild()
            return True
        self.stat_scrub_heals += 1
        self._heal_from_mirror()
        return False

    # ------------------------------------------------------------------
    # Write-behind lane and the host path's table access.

    def enqueue(self, slots, cols, add_lo, add_hi, refresh_twin: bool = True) -> None:
        """Queue host-resolved (slot, col, u128 delta) modular adds.  The
        native library mutates the mirror in place and feeds its deltas
        only through here, so the mutation stamp is bumped for every call
        (suppressed ones included) and, by default, the commitment twin
        refreshes the touched rows; `refresh_twin=False` when the deltas
        came through the mirror's own methods, which already did.  During
        exact recovery they are dropped: the re-upload from the mirror
        that follows carries them; degraded, the mirror is the
        authority and re-promotion uploads it whole."""
        if len(slots) == 0:
            return
        self.mirror.version += 1
        if refresh_twin and self.mirror.commitment is not None:
            self.mirror.commitment.refresh(np.asarray(slots, np.int64), self.mirror)
        if self._suppress_enqueue or self.state is not EngineState.healthy:
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
        if self.state is not EngineState.healthy:
            self._q.clear()
            self._queued = 0
            return
        slots, cols, a_lo, a_hi = (np.concatenate([e[k] for e in self._q]) for k in range(4))
        self._q.clear()
        self._queued = 0
        self.stat_flushes += 1
        try:
            # Tiered, the entries carry logical slots: flush_entries
            # applies the hot ones and returns their hot slots (cold rows
            # keep their deltas in the mirror, and upload whole on
            # admission).
            written = self._run(flush_entries, self.balances, slots, cols, a_lo, a_hi,
                                self._apply, self.hot)
            self._commit_update(written)
        except DeviceLostError as exc:
            self._demote(exc)

    def read(self) -> torch.Tensor:
        """The logical table the host path resolves against.  During
        exact recovery the mirror is the truth (it holds exactly the
        stream prefix before the re-executed batch, while the device
        table holds the whole window's effects), so a card tensor is
        built from it; otherwise a drain and flush barrier, then the
        device table (sharded: joined onto home, a copy that only
        write_back puts back) — tiered, the card tensor built from the
        mirror, which the drain made current.  Degraded, the table is
        built from the mirror on the CPU: no degraded work goes to the
        card."""
        if self._recovering and self.state is EngineState.healthy:
            return self._degraded_table()
        self.drain()
        self.flush()
        if self.state is not EngineState.healthy or self.hot is not None:
            return self._degraded_table()
        try:
            return self._run(sharded.dense, self.balances)
        except DeviceLostError as exc:
            self._demote(exc)
            return self._degraded_table()

    def write_back(self, value: torch.Tensor) -> None:
        """Replace the table from a full logical table image (the host
        path's exact result): a handle swap all-resident (sharded: the
        image split onto the shards), which does not move the digest;
        tiered, the hot rows gathered out of the image and the digest
        rebuilt (the mirror stays the cold tier's authority).  Degraded,
        the image is the CPU table built from the mirror, which the
        caller updates next: nothing goes to the card."""
        self._degraded_cache = None
        if self.state is not EngineState.healthy:
            return
        try:
            if self.hot is None:
                self.balances = self._place(value)
                return
            self.balances = self._place(
                self._run(hot_tier.gather_hot, value, self.hot.logical_of))
            self._commit_rebuild()
        except DeviceLostError as exc:
            self._demote(exc)

    def exact_written(self, slots) -> None:
        """Fold the rows an exact scan wrote (logical slots) into the
        device digest.  In recovery the re-upload and rebuild that follow
        cover them; tiered, write_back's rebuild did; degraded, the
        re-promotion's rebuild will."""
        if self._recovering or self.hot is not None or self.state is not EngineState.healthy:
            return
        try:
            self._commit_update(slots)
        except DeviceLostError as exc:
            self._demote(exc)

    def _degraded_table(self) -> torch.Tensor:
        """The logical table built from the mirror, cached against
        (mirror stamp, capacity, where): on the CPU while degraded (the
        reference pins degraded reads to the CPU backend), on the card
        for a healthy engine's recovery and tiered host path (whose
        exact batches would otherwise upload the whole table each
        time)."""
        on_card = self.state is EngineState.healthy
        key = (self.mirror.version, self.capacity, on_card)
        if self._degraded_cache is None or self._degraded_cache[0] != key:
            image = self.mirror.table8(self.capacity)
            table = self._put(image) if on_card else from_u64(image)
            self._degraded_cache = (key, table)
        return self._degraded_cache[1]

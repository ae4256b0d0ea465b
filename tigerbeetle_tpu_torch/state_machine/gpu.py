"""GPU-backed state machine: host orchestration around the CUDA kernels.

Counterpart of ``tigerbeetle_tpu/state_machine/tpu.py:TpuStateMachine``.
Same external interface (``input_valid`` / ``prepare`` /
``pulse_needed`` / ``prefetch`` / ``commit`` / ``commit_async`` over
wire bytes), so the two are interchangeable under the test harness and
diffable bit for bit; method names follow the reference.

Two execution authorities, as in the reference (``engine``, or
``TB_ENGINE``, default "host"):

- "host": the host resolves every create_transfers batch, first in the
  native library (``runtime/fastpath.py``, C++ built at first use):
  order-free batches (``commit_transfers``), linked chains
  (``commit_linked``) and post/void batches (``commit_two_phase``) each
  in one call, the exact remainder in its serial engine
  (``commit_exact``).  The library owns the balance mirror's memory and
  mutates it in place; the deltas reach the device table through the
  write-behind lane (kernel K4).  Under TB_FASTPATH_DISABLE the Python
  lanes take these batches instead: the mirror's admission, the numpy
  linked / two-phase resolvers (``resolve.py``) and the exact path
  against the device table.  TB_WAVES=1/exact/scan sends every batch to
  that exact path with the library on too: a wave plan (``waves.py``:
  parallel wave steps K7, chain waves K8 and K3 scan segments over one
  carry) when admitted and profitable, else the whole sequential scan
  K3; the mirror is rebuilt from the row snapshots either way.
- "device": the device-authoritative engine (DeviceEngine) computes the
  codes on the device inside pipelined windows, routed as the
  reference routes them: order-free batches to kernel K1, linked-chain
  batches (limit accounts allowed) to K5, pending-create + post/void
  batches to K6; the state commitment stays on the device (kernel K2).
  Every other batch is speculated (the whole batch as one K7 step
  behind K9's validation, only the conflicted residue replayed through
  a plan) or wave-dispatched inside the window (TB_DEV_WAVES,
  TB_WAVES_SPECULATE); a batch that routing declines drains the stream
  and takes the host path above.  A flagged batch (an overflow, more
  failures than the summary holds, a K5 precondition or fixpoint cap)
  is re-executed exactly on the host.

State split: the device holds the balance table (and, device engine,
the account-meta table, the summary ring and the digest); the host
holds the id directories, immutable account attributes, the columnar
transfer store, the expires index, the history rows and the balance
mirror.  Hot/cold tiering (TB_HOT_CAPACITY, ``hot_tier.py``) keeps only
a hot set of rows on the card in either engine, with the mirror as the
cold tier: the device engine prefetches each batch's accounts before
packing it with hot slots (``_tier_translate``), the host engine admits
them as its deltas arrive.

The device engine crosses the card through one DeviceLink
(``device_link``: tests pass the chaos shim of ``testing/chaos.py``); a
lost link demotes it and every batch is then served exactly by the
host path on the CPU until ``tick`` (once per committed operation)
re-promotes it.  The queries (get_account_transfers,
get_account_balances) read the host stores; ``snapshot`` / ``restore``
carry the durable state in the reference's blob layout
(``utils/snapshot.py``).

Row sharding (``devices``, the reference's ``jax.devices()``): with
several devices whose count divides the device table's rows, either
engine splits its tables row-wise over a ("shard",) mesh
(``parallel/sharded.py``); the router then routes as the reference's
sharded machine does: no speculation, and wave dispatch declines a plan
with scan segments ("shard_plan") or a mesh that does not divide the
capacity ("mesh").
"""

from __future__ import annotations

import time as _time

import numpy as np

import torch

from tigerbeetle_tpu_torch import constants as cfg
from tigerbeetle_tpu_torch import envcheck, types
from tigerbeetle_tpu_torch.device import resolve_device
from tigerbeetle_tpu_torch.ops.u128 import from_u64, to_u64
from tigerbeetle_tpu_torch.parallel import sharded
from tigerbeetle_tpu_torch.runtime import fastpath
from tigerbeetle_tpu_torch.state_machine import commitment as cm
from tigerbeetle_tpu_torch.state_machine import device_kernels as dk
from tigerbeetle_tpu_torch.state_machine import kernel, resolve, waves
from tigerbeetle_tpu_torch.state_machine.device_engine import (
    DeviceEngine,
    DeviceLostError,
    ReplyFuture,
)
from tigerbeetle_tpu_torch.state_machine.hot_tier import mirror_hot_table8
from tigerbeetle_tpu_torch.state_machine.kernel_fast import DeviceTable
from tigerbeetle_tpu_torch.state_machine.mirror import BalanceMirror, _sub_u128, digest_columns
from tigerbeetle_tpu_torch.types import (
    ACCOUNT_BALANCE_DTYPE,
    ACCOUNT_DTYPE,
    ACCOUNT_FILTER_DTYPE,
    CREATE_RESULT_DTYPE,
    NS_PER_S,
    TIMESTAMP_MAX,
    TIMESTAMP_MIN,
    TRANSFER_DTYPE,
    U64_MAX,
    U128_MAX,
    AccountFilterFlags,
    AccountFlags,
    CreateAccountResult,
    CreateTransferResult,
    EngineState,
    Operation,
    TransferFlags,
    TransferPendingStatus,
)
from tigerbeetle_tpu_torch.utils import RunIndex
from tigerbeetle_tpu_torch.utils import snapshot as snapcodec

AF = AccountFlags
TF = TransferFlags
CAR = CreateAccountResult
CTR = CreateTransferResult

# Tight device-input gate: amounts must fit u32 (tests shrink this to
# force the wide format on the same stream).
_TIGHT_AMOUNT_LIMIT = 1 << 32
# Account flags that keep a batch off the order-free and two-phase
# kernels: the limits (the linked kernel takes them) and history.
_LIMH = np.uint32(AF.debits_must_not_exceed_credits | AF.credits_must_not_exceed_debits | AF.history)

# Columnar transfer-store fields.
_STORE_FIELDS = {
    "id_lo": np.uint64, "id_hi": np.uint64,
    "dr_slot": np.int32, "cr_slot": np.int32,
    "amount_lo": np.uint64, "amount_hi": np.uint64,
    "pending_lo": np.uint64, "pending_hi": np.uint64,
    "ud128_lo": np.uint64, "ud128_hi": np.uint64,
    "ud64": np.uint64, "ud32": np.uint32,
    "timeout": np.uint32, "ledger": np.uint32, "code": np.uint32,
    "flags": np.uint32, "timestamp": np.uint64,
    "status": np.uint8,  # TransferPendingStatus for pending transfers
}

_HISTORY_FIELDS = {
    "timestamp": np.uint64,
    "dr_id_lo": np.uint64, "dr_id_hi": np.uint64,
    "cr_id_lo": np.uint64, "cr_id_hi": np.uint64,
    "dr_bal": (np.uint64, 8), "cr_bal": (np.uint64, 8),
}

_ATTR_FIELDS = {
    "id_lo": np.uint64, "id_hi": np.uint64,
    "ud128_lo": np.uint64, "ud128_hi": np.uint64,
    "ud64": np.uint64, "ud32": np.uint32,
    "ledger": np.uint32, "code": np.uint32, "flags": np.uint32,
    "timestamp": np.uint64,
}

_BATCH_BUCKETS = kernel.BATCH_BUCKETS


def _amount_bound_total(amount_lo: np.ndarray, amount_hi: np.ndarray) -> int:
    """Exact host-integer sum of (lo, hi) u128 amount bounds by 32-bit
    limb sums (each below 2^21 * 2^32 < 2^64): the in-flight admission
    bookkeeping of the device engine's window."""
    m32 = np.uint64(0xFFFFFFFF)
    return (
        int((amount_lo & m32).sum(dtype=np.uint64))
        + (int((amount_lo >> np.uint64(32)).sum(dtype=np.uint64)) << 32)
        + (int((amount_hi & m32).sum(dtype=np.uint64)) << 64)
        + (int((amount_hi >> np.uint64(32)).sum(dtype=np.uint64)) << 96)
    )


def pack_u128(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """(lo, hi) u64 limbs -> (n,) V16 keys ordering like the u128 value
    (big-endian byte order)."""
    n = len(lo)
    out = np.empty((n, 2), ">u8")
    out[:, 0] = hi
    out[:, 1] = lo
    return out.view("V16").reshape(n)


class Columns:
    """Growable columnar array store with vectorized batch append."""

    def __init__(self, fields: dict, capacity: int = 1024) -> None:
        self.count = 0
        self._cap = capacity
        self._cols = {}
        for name, dt in fields.items():
            if isinstance(dt, tuple):  # (dtype, width): a 2-D column
                self._cols[name] = np.zeros((capacity, dt[1]), dt[0])
            else:
                self._cols[name] = np.zeros(capacity, dt)

    def _ensure(self, extra: int) -> None:
        need = self.count + extra
        if need <= self._cap:
            return
        while self._cap < need:
            self._cap *= 4
        for name, col in self._cols.items():
            new = np.zeros((self._cap,) + col.shape[1:], col.dtype)
            new[: self.count] = col[: self.count]
            self._cols[name] = new

    def append(self, **arrays) -> np.ndarray:
        n = len(next(iter(arrays.values())))
        self._ensure(n)
        lo, hi = self.count, self.count + n
        for name, arr in arrays.items():
            self._cols[name][lo:hi] = arr
        self.count = hi
        return np.arange(lo, hi)

    def truncate(self, count: int) -> None:
        assert count <= self.count
        self.count = count

    def col(self, name: str) -> np.ndarray:
        return self._cols[name][: self.count]

    def __getitem__(self, name: str) -> np.ndarray:
        return self._cols[name]


class TailStore(Columns):
    """The transfer store.  The reference spills its oldest rows into an
    LSM tier; this port keeps every row in RAM (the spill tier is not
    ported), so global row numbers are physical rows."""

    def gather_many(self, names: list[str], rows: np.ndarray) -> dict:
        rows = np.asarray(rows)
        return {n: self._cols[n][rows] for n in names}


def _dir_capacity(entries: int) -> int:
    """Pow2 hash capacity holding `entries` at <= 50% load."""
    return max(1 << 16, 1 << (2 * max(entries, 1)).bit_length())


def _apply_code(result: np.ndarray, cond: np.ndarray, code: int) -> None:
    np.copyto(result, np.uint32(code), where=(result == 0) & cond)


def _pad(arr: np.ndarray, size: int) -> np.ndarray:
    out = np.zeros(size, arr.dtype)
    out[: len(arr)] = arr
    return out


# Store columns the exact path joins for durable duplicates and pendings.
_JOIN_FIELDS = (
    "flags", "dr_slot", "cr_slot", "amount_lo", "amount_hi",
    "pending_lo", "pending_hi", "ud128_lo", "ud128_hi",
    "ud64", "ud32", "timeout", "ledger", "code", "timestamp",
    "status",
)


class TorchStateMachine:
    """Accounting state machine whose create_transfers codes are
    computed by the host engine or the device-authoritative engine,
    with the kernels on the GPU."""

    def __init__(
        self,
        config: cfg.Config = cfg.PRODUCTION,
        account_capacity: int = 1 << 16,
        transfer_capacity: int = 1 << 16,
        device=None,
        plain: bool = False,
        engine: str | None = None,
        devices=None,
        device_link=None,
    ) -> None:
        """`device`: None = the first CUDA card (raises without one);
        "cpu" runs the kernels' plain PyTorch versions on the CPU.
        `devices`: the devices the device tables may shard over (the
        reference's jax.devices(); they may repeat a device, as
        ["cpu"] * 8); `device`, when named too, must be the first.  With
        neither, every visible CUDA card; with `device` alone, that one.
        `plain` runs the plain versions on `device` (a reference run).
        `engine`: "host" or "device" (default: TB_ENGINE, else "host").
        `device_link` (device engine only): the DeviceLink every upload,
        launch and fetch of the engine crosses (tests pass a seeded
        chaos shim, testing/chaos.py)."""
        self.config = config
        self.engine = engine or envcheck.engine()
        if self.engine not in ("host", "device"):
            raise ValueError(f"engine must be 'host' or 'device', got {self.engine!r}")
        if devices is not None or device is None:
            devices = sharded.resolve_devices(devices)
            if device is not None and resolve_device(device) != devices[0]:
                raise ValueError(f"device {device!r} is not the first of {devices}")
            device = devices[0]
        self.device = resolve_device(device)
        self.plain = plain
        self._devices = devices
        self._device_link = device_link
        self.prepare_timestamp = 0
        self.commit_timestamp = 0
        self.pulse_next_timestamp = TIMESTAMP_MIN

        # Work-split counters (the reference's names).
        self.stat_device_events = 0
        self.stat_exact_events = 0
        self.stat_exact_batches = 0
        self.stat_host_semantic_events = 0
        self.stat_fallback_events = 0
        # Linked and two-phase batches: the device engine's K5 / K6 and
        # the host path's lanes (native or Python) alike, as the
        # reference counts them; fixpoint iterations of K5 and of
        # resolve.linked_resolve.
        self.stat_linked_batches = 0
        self.stat_two_phase_batches = 0
        self.stat_resolve_iters = 0
        # Which bookkeeping tail a native-lane batch took: the one-C-pass
        # hot tail (every event applied, no timeouts) or the general one.
        self.stat_hot_tail_batches = 0
        self.stat_slow_tail_batches = 0
        # Wave execution of the host exact path (TB_WAVES) and wave /
        # speculative dispatch inside the device window (TB_DEV_WAVES).
        self.stat_wave_batches = 0
        self.stat_wave_steps = 0
        self.stat_wave_events = 0
        self.stat_wave_parallel_events = 0
        self.stat_dev_wave_batches = 0
        self.stat_dev_wave_declined = 0
        self.stat_dev_wave_steps = 0
        self.stat_dev_wave_events = 0
        self.stat_dev_wave_plan_s = 0.0
        self.stat_dev_wave_decline_reasons: dict = {}
        # Device-engine batches whose touched set the hot set could not
        # take (the reference's dev_tier.punt): they ran the host path.
        # The tier's own counters are on self._dev.hot.
        self.stat_tier_punts = 0

        self._acct_dir = RunIndex(_dir_capacity(account_capacity))
        self._attrs = Columns(_ATTR_FIELDS, capacity=max(1024, account_capacity))
        self._mirror = BalanceMirror(account_capacity)
        # The host commitment twin rides the mirror, with meta columns
        # read live from the attribute store; attached before the
        # engine so both sides share it.
        self._commitment = None
        if envcheck.state_commit() == 1:
            self._commitment = cm.HostCommitment(
                account_capacity, meta_fn=self._commit_meta_cols
            )
            self._mirror.commitment = self._commitment
        if self.engine == "device":
            self._dev = DeviceEngine(
                account_capacity, self._mirror, self.device, plain=plain, devices=devices,
                link=device_link,
            )
        else:
            self._dev = DeviceTable(account_capacity, self.device, self._mirror, plain=plain,
                                    devices=devices)
        # The native fast path (runtime/fastpath.py): the balance mirror
        # is re-pointed at the library's memory so both sides share one
        # copy.  A failed build raises; TB_FASTPATH_DISABLE runs the
        # Python lanes instead.
        self._native = None
        if fastpath.available():
            self._native = fastpath.NativeFastpath(account_capacity)
            self._mirror.lo = self._native.lo
            self._mirror.hi = self._native.hi
        self._exact_scratch = None
        self._wave_scratch = None
        self._tdir = RunIndex(_dir_capacity(transfer_capacity))
        self._store = TailStore(_STORE_FIELDS, capacity=max(1024, transfer_capacity))
        # expires_at index: (expires_at, store row, active).
        self._exp = Columns(
            {"expires_at": np.uint64, "row": np.uint32, "active": np.bool_}
        )
        self._exp_dead = 0
        self._history = Columns(_HISTORY_FIELDS)
        self._expiry_rows: np.ndarray | None = None
        # A device-window batch may create timeout-carrying pendings.
        self._inflight_timeouts = False

    @property
    def stat_device_semantic_events(self) -> int:
        """Events whose result codes were computed on the device."""
        return self._dev.stat_semantic_events if self.engine == "device" else 0

    @property
    def history_count(self) -> int:
        return self._history.count

    def _engine_drain(self) -> None:
        if self.engine == "device":
            self._dev.drain()

    def _commit_meta_cols(self, slots: np.ndarray) -> np.ndarray:
        """(k, 2) uint32 meta columns (flags, ledger) for the commitment,
        read live from the attribute store; zeros past the live count."""
        slots = np.asarray(slots, np.int64)
        out = np.zeros((len(slots), 2), np.uint32)
        m = slots < self._attrs.count
        if m.any():
            out[m, 0] = self._attrs.col("flags")[slots[m]]
            out[m, 1] = self._attrs.col("ledger")[slots[m]]
        return out

    def state_root(self) -> bytes:
        """16-byte state commitment of the account table (balances +
        meta), current to the last materialized commit."""
        if self._commitment is not None:
            return self._commitment.root_bytes()
        n = self._attrs.count
        meta = self._commit_meta_cols(np.arange(n, dtype=np.int64))
        return cm.root_bytes(cm.table_digest(self._mirror.rows8(np.arange(n)), meta))

    def verify_device_mirror(self) -> None:
        """Crash loudly unless the device tables equal the host copies
        (the checkpoint tripwire; reference: tpu.py:642-778).

        Device engine with the commitment live: the device's maintained
        digest and its from-scratch recompute (K2 probe) must equal what
        the host twin expects (the whole root, or under tiering the hot
        partial), and the twin a from-scratch host digest of the mirror.
        Device engine without it: the K11 digests of the device tables
        against the host's (hot-shaped images under tiering).  Host
        engine: the K11 digest of the flushed device table against the
        mirror's (its hot image under tiering).  The whole tables are
        fetched only to name the diverged rows.  A degraded device engine
        has nothing to compare (the mirror is the authoritative table);
        a crossing lost here demotes it."""
        dev = self._dev
        if self.engine == "host":
            dev_sum = dev.device_checksum()
            if dev.hot is not None:
                host_sum = digest_columns(mirror_hot_table8(self._mirror, dev.hot.logical_of))
            else:
                host_sum = self._mirror.checksum8(dev.capacity)
            if not (dev_sum == host_sum).all():
                raise AssertionError(
                    "device/mirror balance divergence: "
                    f"device={dev_sum.tolist()} host={host_sum.tolist()}"
                )
            return
        if dev.state is not EngineState.healthy:
            return
        dev.drain()
        dev.flush()
        if dev.state is not EngineState.healthy:
            return
        try:
            self._verify_device_engine(dev)
        except DeviceLostError as exc:
            dev._demote(exc)

    def _verify_device_engine(self, dev) -> None:
        if self._commitment is not None and dev.dev_digest is not None:
            pair = dev.commit_probe()
            twin = self._commitment.digest
            n_rows = len(self._mirror.lo)
            host_scratch = cm.table_digest(
                self._mirror.rows8(np.arange(n_rows)),
                self._commit_meta_cols(np.arange(n_rows, dtype=np.int64)),
            )
            if (
                (pair[0] == pair[1]).all()
                and (pair[1] == dev.twin_expected_digest()).all()
                and (twin == host_scratch).all()
            ):
                return
            raise AssertionError(
                f"device/mirror commitment divergence: {self._diverged(dev)}; "
                f"device(maintained, scratch)={pair.tolist()} "
                f"twin={twin.tolist()} host_scratch={host_scratch.tolist()}"
            )
        dev_sum = dev._device_health_digest()
        host_sum = dev._host_health_digest()
        if not (dev_sum == host_sum).all():
            raise AssertionError(
                f"device/mirror table divergence: {self._diverged(dev)}; "
                f"device={dev_sum.tolist()} host={host_sum.tolist()}"
            )

    @staticmethod
    def _diverged(dev) -> str:
        """The diverged rows for a tripwire's message (the full-table
        fetch; a lost link there still leaves the divergence reported)."""
        try:
            rows = dev._localize_divergence()
        except DeviceLostError as exc:
            return f"localization fetch failed: {exc!r}"
        return f"{len(rows)} rows diverged (first: {rows[:8].tolist()})"

    # ------------------------------------------------------------------
    # Interface plumbing (reference: src/state_machine.zig:543-596).

    def input_valid(self, operation: Operation, input_bytes: bytes) -> bool:
        if operation == Operation.pulse:
            return len(input_bytes) == 0
        if operation in (Operation.get_account_transfers, Operation.get_account_balances):
            return len(input_bytes) == ACCOUNT_FILTER_DTYPE.itemsize
        event_size = types.EVENT_DTYPE[operation].itemsize
        batch_max = self.config.batch_max(
            event_size, types.RESULT_DTYPE[operation].itemsize
        )
        if len(input_bytes) % event_size != 0:
            return False
        return len(input_bytes) <= batch_max * event_size

    def prepare(self, operation: Operation, input_bytes: bytes) -> None:
        assert self.input_valid(operation, input_bytes)
        if operation in (Operation.create_accounts, Operation.create_transfers):
            event_size = types.EVENT_DTYPE[operation].itemsize
            self.prepare_timestamp += len(input_bytes) // event_size

    def pulse_needed(self) -> bool:
        # A device-window batch in flight may be about to create a
        # timeout-carrying pending, which would pull pulse_next_timestamp
        # earlier: drain before deciding, so the pulse schedule matches
        # the reference's exactly.
        if self.engine == "device" and self._inflight_timeouts and self._dev.has_inflight():
            self._engine_drain()
        if self.engine == "device" and not self._dev.has_inflight():
            self._inflight_timeouts = False
        return self.pulse_next_timestamp <= self.prepare_timestamp

    def prefetch(
        self, operation: Operation, input_bytes: bytes, prefetch_timestamp: int
    ) -> None:
        if operation == Operation.pulse:
            self._engine_drain()
            self._expiry_rows = self._scan_expired(prefetch_timestamp)

    def commit(self, client: int, op: int, timestamp: int,
               operation: Operation, input_bytes: bytes) -> bytes:
        return self.commit_async(client, op, timestamp, operation, input_bytes).result()

    def commit_async(self, client: int, op: int, timestamp: int,
                     operation: Operation, input_bytes: bytes):
        """Dispatch one committed operation; returns a ReplyFuture.  On
        the device engine, create_transfers batches of the kernels'
        classes (and lookup_accounts gathers behind in-flight batches)
        resolve at the next ring fetch; every other reply resolves
        synchronously."""
        assert op != 0
        assert self.input_valid(operation, input_bytes)
        assert timestamp > self.commit_timestamp
        if self.engine == "device":
            # Lifecycle tick on every committed operation: re-promotion
            # probes while degraded, the scrub cadence while healthy.
            self._dev.tick()
        if operation == Operation.create_transfers:
            if self.engine == "device":
                return self._commit_create_transfers_device(timestamp, input_bytes)
            return ReplyFuture(value=self._commit_create_transfers(timestamp, input_bytes))
        if operation == Operation.lookup_accounts:
            if self.engine == "device" and self._dev.has_inflight():
                return self._lookup_accounts_device(input_bytes)
            return ReplyFuture(value=self._lookup_accounts(input_bytes))
        if operation == Operation.pulse:
            return ReplyFuture(value=self._commit_expire(timestamp))
        if operation == Operation.create_accounts:
            return ReplyFuture(value=self._commit_create_accounts(timestamp, input_bytes))
        # Store-reading queries: exact only against materialized state.
        self._engine_drain()
        if operation == Operation.lookup_transfers:
            return ReplyFuture(value=self._lookup_transfers(input_bytes))
        if operation == Operation.get_account_transfers:
            return ReplyFuture(value=self._get_account_transfers(input_bytes))
        if operation == Operation.get_account_balances:
            return ReplyFuture(value=self._get_account_balances(input_bytes))
        raise AssertionError(operation)

    # ------------------------------------------------------------------
    # Accounts (cold path: per-event, exact oracle semantics).

    def _account_slot(self, id_value: int) -> int | None:
        found, slot = self._acct_dir.lookup(
            np.array([id_value & U64_MAX], np.uint64),
            np.array([id_value >> 64], np.uint64),
        )
        return int(slot[0]) if found[0] else None

    def _sync_engine_meta(self, n0: int) -> None:
        """Register accounts created since slot n0: with the device
        engine's meta table (the device ladder's ledger input; it also
        refreshes the commitment twin), or, on the host engine, with the
        twin (their meta columns just became nonzero)."""
        if self._attrs.count <= n0:
            return
        slots = np.arange(n0, self._attrs.count, dtype=np.int64)
        if self.engine == "device":
            self._dev.add_accounts(
                slots, self._attrs.col("flags")[n0:], self._attrs.col("ledger")[n0:]
            )
        elif self._commitment is not None:
            self._commitment.refresh(slots, self._mirror)

    def _commit_create_accounts(self, timestamp: int, input_bytes: bytes) -> bytes:
        events = np.frombuffer(input_bytes, dtype=ACCOUNT_DTYPE)
        n = len(events)
        n0 = self._attrs.count

        reply = self._commit_create_accounts_fast(timestamp, events, n)
        if reply is not None:
            self._sync_engine_meta(n0)
            return reply
        results: list[tuple[int, int]] = []
        chain: int | None = None
        chain_broken = False
        scope_slots: list[int] = []  # slots allocated in the open chain

        def exists_ladder(ev: dict, slot: int) -> int:
            a = self._attrs
            if ev["flags"] != int(a["flags"][slot]):
                return CAR.exists_with_different_flags
            if ev["ud128_lo"] != int(a["ud128_lo"][slot]) or ev["ud128_hi"] != int(
                a["ud128_hi"][slot]
            ):
                return CAR.exists_with_different_user_data_128
            if ev["ud64"] != int(a["ud64"][slot]):
                return CAR.exists_with_different_user_data_64
            if ev["ud32"] != int(a["ud32"][slot]):
                return CAR.exists_with_different_user_data_32
            if ev["ledger"] != int(a["ledger"][slot]):
                return CAR.exists_with_different_ledger
            if ev["code"] != int(a["code"][slot]):
                return CAR.exists_with_different_code
            return CAR.exists

        def rollback_scope() -> None:
            if not scope_slots:
                return
            self._acct_dir.remove(
                self._attrs["id_lo"][scope_slots], self._attrs["id_hi"][scope_slots]
            )
            if self._native is not None:
                self._native.remove_accounts(
                    self._attrs["id_lo"][scope_slots], self._attrs["id_hi"][scope_slots]
                )
            self._attrs.truncate(min(scope_slots))
            scope_slots.clear()

        for index in range(n):
            row = events[index]
            ev = {
                "id": types.u128_get(row, "id"),
                "flags": int(row["flags"]),
                "ud128_lo": int(row["user_data_128_lo"]),
                "ud128_hi": int(row["user_data_128_hi"]),
                "ud64": int(row["user_data_64"]),
                "ud32": int(row["user_data_32"]),
                "ledger": int(row["ledger"]),
                "code": int(row["code"]),
            }
            linked = bool(ev["flags"] & AF.linked)

            result: int | None = None
            if linked:
                if chain is None:
                    chain = index
                    assert not chain_broken
                    scope_slots.clear()
                if index == n - 1:
                    result = CAR.linked_event_chain_open
            if result is None and chain_broken:
                result = CAR.linked_event_failed
            if result is None and int(row["timestamp"]) != 0:
                result = CAR.timestamp_must_be_zero

            if result is None:
                result = self._create_account_checked(row, ev, exists_ladder)
                if result == CAR.ok:
                    slot = self._attrs.count
                    self._attrs.append(
                        id_lo=np.array([row["id_lo"]]),
                        id_hi=np.array([row["id_hi"]]),
                        ud128_lo=np.array([row["user_data_128_lo"]]),
                        ud128_hi=np.array([row["user_data_128_hi"]]),
                        ud64=np.array([row["user_data_64"]]),
                        ud32=np.array([row["user_data_32"]]),
                        ledger=np.array([row["ledger"]]),
                        code=np.array([row["code"]]),
                        flags=np.array([row["flags"]]),
                        timestamp=np.array([timestamp - n + index + 1], np.uint64),
                    )
                    self._acct_dir.insert(
                        np.array([row["id_lo"]], np.uint64),
                        np.array([row["id_hi"]], np.uint64),
                        np.array([slot], np.uint64),
                    )
                    if self._native is not None:
                        # A capacity rebuild re-registers every account
                        # of _attrs (this one included).
                        native = self._native
                        self._ensure_balance_capacity(self._attrs.count)
                        if self._native is native:
                            native.add_accounts(
                                np.array([row["id_lo"]], np.uint64),
                                np.array([row["id_hi"]], np.uint64),
                                np.array([row["flags"]], np.uint32),
                                np.array([row["ledger"]], np.uint32),
                                base_slot=slot,
                            )
                    if chain is not None:
                        scope_slots.append(slot)
                    self.commit_timestamp = timestamp - n + index + 1

            if result != CAR.ok:
                if chain is not None:
                    if not chain_broken:
                        chain_broken = True
                        rollback_scope()
                        for chain_index in range(chain, index):
                            results.append((chain_index, CAR.linked_event_failed))
                results.append((index, int(result)))

            if chain is not None and (
                not linked or result == CAR.linked_event_chain_open
            ):
                scope_slots.clear()
                chain = None
                chain_broken = False

        self._ensure_balance_capacity(self._attrs.count)
        self._sync_engine_meta(n0)

        out = np.zeros(len(results), dtype=CREATE_RESULT_DTYPE)
        for i, (index, result) in enumerate(results):
            out[i]["index"] = index
            out[i]["result"] = result
        return out.tobytes()

    def _commit_create_accounts_fast(
        self, timestamp: int, events: np.ndarray, n: int
    ) -> bytes | None:
        """Vectorized all-valid batch: no chains, no failures, no
        existing ids — else None routes to the exact per-event loop."""
        if n == 0:
            return b""
        flags = events["flags"].astype(np.uint32)
        if (flags & np.uint32(AF.linked)).any():
            return None
        id_lo = events["id_lo"].astype(np.uint64)
        id_hi = events["id_hi"].astype(np.uint64)
        invalid = (
            (events["timestamp"] != 0)
            | (events["reserved"] != 0)
            | ((flags & ~np.uint32(0xF)) != 0)
            | ((id_lo == 0) & (id_hi == 0))
            | ((id_lo == np.uint64(U64_MAX)) & (id_hi == np.uint64(U64_MAX)))
            | (
                ((flags & np.uint32(AF.debits_must_not_exceed_credits)) != 0)
                & ((flags & np.uint32(AF.credits_must_not_exceed_debits)) != 0)
            )
            | (events["ledger"] == 0)
            | (events["code"] == 0)
        )
        for field in ("debits_pending", "debits_posted", "credits_pending",
                      "credits_posted"):
            invalid |= (events[f"{field}_lo"] != 0) | (events[f"{field}_hi"] != 0)
        if invalid.any():
            return None
        if n > 1 and not (
            (id_hi[1:] == id_hi[:-1]).all() and (id_lo[1:] > id_lo[:-1]).all()
        ):
            mix = id_lo * np.uint64(0x9E3779B97F4A7C15) + id_hi * np.uint64(
                0xC2B2AE3D27D4EB4F
            )
            if len(np.unique(mix)) != n:
                return None
        found, _ = self._acct_dir.lookup(id_lo, id_hi)
        if found.any():
            return None

        base = self._attrs.count
        ts0 = np.uint64(timestamp - n + 1)
        rows = self._attrs.append(
            id_lo=id_lo, id_hi=id_hi,
            ud128_lo=events["user_data_128_lo"], ud128_hi=events["user_data_128_hi"],
            ud64=events["user_data_64"], ud32=events["user_data_32"],
            ledger=events["ledger"], code=events["code"], flags=flags,
            timestamp=ts0 + np.arange(n, dtype=np.uint64),
        )
        assert rows[0] == base
        self._acct_dir.insert(id_lo, id_hi, rows.astype(np.uint64))
        self.commit_timestamp = timestamp
        native = self._native
        self._ensure_balance_capacity(self._attrs.count)
        # A capacity rebuild already re-registered every account.
        if native is not None and self._native is native:
            native.add_accounts(id_lo, id_hi, flags, events["ledger"], base_slot=base)
        return b""

    def _create_account_checked(self, row, ev, exists_ladder) -> int:
        # reference: src/state_machine.zig:1421-1448
        if int(row["reserved"]) != 0:
            return CAR.reserved_field
        if ev["flags"] & ~0xF:
            return CAR.reserved_flag
        if ev["id"] == 0:
            return CAR.id_must_not_be_zero
        if ev["id"] == U128_MAX:
            return CAR.id_must_not_be_int_max
        if (ev["flags"] & AF.debits_must_not_exceed_credits) and (
            ev["flags"] & AF.credits_must_not_exceed_debits
        ):
            return CAR.flags_are_mutually_exclusive
        for field in ("debits_pending", "debits_posted", "credits_pending",
                      "credits_posted"):
            if types.u128_get(row, field) != 0:
                return getattr(CAR, f"{field}_must_be_zero")
        if ev["ledger"] == 0:
            return CAR.ledger_must_not_be_zero
        if ev["code"] == 0:
            return CAR.code_must_not_be_zero
        slot = self._account_slot(ev["id"])
        if slot is not None:
            return exists_ladder(ev, slot)
        return CAR.ok

    def _ensure_balance_capacity(self, slots: int) -> None:
        cap = self._dev.capacity
        if slots <= cap:
            return
        while cap < slots:
            cap *= 2
        self._dev.grow(cap)
        if self._native is not None:
            self._rebuild_native(cap)
        else:
            self._mirror.grow(cap)

    def _rebuild_native(self, capacity: int) -> None:
        """Recreate the native fast path at a new capacity: copy the
        balances, re-point the shared mirror, re-register the id
        directories (reference: tpu.py:1289).  Every other holder reads
        the arrays through the mirror, so it sees the new ones."""
        old_lo, old_hi = self._mirror.lo, self._mirror.hi
        native = fastpath.NativeFastpath(capacity)
        native.lo[: len(old_lo)] = old_lo
        native.hi[: len(old_hi)] = old_hi
        if self._attrs.count:
            native.add_accounts(
                self._attrs.col("id_lo"), self._attrs.col("id_hi"),
                self._attrs.col("flags"), self._attrs.col("ledger"), base_slot=0,
            )
        if self._store.count:  # every row in RAM: global row = physical row
            native.add_transfer_ids(self._store.col("id_lo"), self._store.col("id_hi"), 0)
        self._native = native
        self._mirror.lo = native.lo
        self._mirror.hi = native.hi
        self._mirror.version += 1

    # ------------------------------------------------------------------
    # Device-authoritative create_transfers (engine == "device").

    def _commit_create_transfers_device(self, timestamp: int, input_bytes: bytes):
        """Route a batch to a device semantic kernel — order-free (K1),
        linked-chain (K5) or two-phase (K6); the host does the joins,
        the device computes the result codes — or, for shapes outside
        the kernels' classes, to wave or speculative dispatch inside the
        window (_try_submit_device_waves), and on its decline drain the
        stream and take the exact host path (reference:
        tpu.py:1329-1489).  A degraded engine serves every batch through
        the host path until tick re-promotes it.  Each kernel's
        submit returns None, and the batch takes the host path, when the
        tiered hot set cannot hold its accounts."""
        events = np.frombuffer(input_bytes, dtype=TRANSFER_DTYPE)
        n = len(events)
        ts_base = timestamp - n + 1

        def host_path() -> ReplyFuture:
            # Wave dispatch first; a decline hands its decode to the
            # drained host path.
            fut, decoded = self._try_submit_device_waves(events, n, timestamp, input_bytes)
            if fut is not None:
                return fut
            self._engine_drain()
            return ReplyFuture(
                value=self._commit_create_transfers(timestamp, input_bytes, decoded=decoded)
            )

        if self._dev.state is not EngineState.healthy:
            return host_path()

        if n == 0 or n > dk.B:
            return host_path()

        # TB_WAVES_SPECULATE=force: every window batch, kernel shapes
        # included, goes through the speculative dispatcher.
        if waves.spec_mode() == "force":
            return host_path()

        id_lo = np.asarray(events["id_lo"])
        id_hi = np.asarray(events["id_hi"])
        flags16 = np.asarray(events["flags"])
        flags = flags16.astype(np.uint32)
        timeout = events["timeout"].astype(np.uint64)
        amount_hi = np.asarray(events["amount_hi"])

        has_linked = bool((flags16 & np.uint16(TF.linked)).any())
        has_pending = bool((flags16 & np.uint16(TF.pending)).any())
        pv16 = np.uint16(TF.post_pending_transfer | TF.void_pending_transfer)
        has_pv = bool((flags16 & pv16).any())
        has_bal = bool(
            (flags16 & np.uint16(TF.balancing_debit | TF.balancing_credit)).any()
        )

        # Unique-id check: ascending ids prove uniqueness; else a
        # 64-bit key mix.
        ascending = n == 1 or bool(
            (
                (id_hi[1:] > id_hi[:-1])
                | ((id_hi[1:] == id_hi[:-1]) & (id_lo[1:] > id_lo[:-1]))
            ).all()
        )
        if ascending:
            ids_unique = True
        else:
            mix = id_lo * np.uint64(0x9E3779B97F4A7C15) + id_hi * np.uint64(
                0xC2B2AE3D27D4EB4F
            )
            ids_unique = len(np.unique(mix)) == n
        if not ids_unique or has_bal:
            return host_path()

        # In-flight hazards: this batch's ids must not collide with
        # batches whose bookkeeping has not materialized yet, and a
        # post/void batch's pending references join the probe (and its
        # recorded keys), so a later pipelined finalize of the same
        # durable pending drains instead of reading a stale status
        # (the double-finalize hazard, reference :1414-1426).
        keys = pack_u128(id_lo, id_hi)
        probe = keys
        if has_pv:
            # pending_id == 0 means "no reference" and must not alias.
            plo = np.asarray(events["pending_id_lo"])
            phi = np.asarray(events["pending_id_hi"])
            ref = (plo != 0) | (phi != 0)
            probe = np.concatenate([probe, pack_u128(plo[ref], phi[ref])])
        keys_sorted = np.sort(probe) if (has_pv or not ascending) else keys
        if self._dev.inflight_ids_hit(probe):
            self._engine_drain()

        e_found, _e_row = self._tdir.lookup(id_lo, id_hi)
        if e_found.any():
            return host_path()

        # Account joins (slots + flags for routing).
        dr_lo = np.asarray(events["debit_account_id_lo"])
        dr_hi = np.asarray(events["debit_account_id_hi"])
        cr_lo = np.asarray(events["credit_account_id_lo"])
        cr_hi = np.asarray(events["credit_account_id_hi"])
        dr_found, dr_slot_u = self._acct_dir.lookup(dr_lo, dr_hi)
        cr_found, cr_slot_u = self._acct_dir.lookup(cr_lo, cr_hi)
        dr_slot = np.where(dr_found, dr_slot_u.astype(np.int64), -1)
        cr_slot = np.where(cr_found, cr_slot_u.astype(np.int64), -1)
        attrs = self._attrs
        dr_flags = np.where(dr_found, attrs["flags"][np.clip(dr_slot, 0, None)], 0).astype(np.uint32)
        cr_flags = np.where(cr_found, attrs["flags"][np.clip(cr_slot, 0, None)], 0).astype(np.uint32)
        touch_limit_hist = bool(((dr_flags | cr_flags) & _LIMH).any())
        touch_hist = bool(((dr_flags | cr_flags) & np.uint32(AF.history)).any())

        common = dict(
            events=events, n=n, ts_base=ts_base, id_lo=id_lo, id_hi=id_hi,
            dr_lo=dr_lo, dr_hi=dr_hi, cr_lo=cr_lo, cr_hi=cr_hi, flags=flags,
            timeout=timeout, dr_slot=dr_slot, cr_slot=cr_slot,
            keys_sorted=keys_sorted, timestamp=timestamp, input_bytes=input_bytes,
        )
        if not (has_linked or has_pv) and not touch_limit_hist:
            fut = self._submit_device_orderfree(**common)
            return fut if fut is not None else host_path()
        if (
            has_linked
            and not (has_pending or has_pv)
            and not touch_hist
            and not amount_hi.any()
        ):
            fut = self._submit_device_linked(**common)
            return fut if fut is not None else host_path()
        if has_pv and not has_linked and not timeout.any() and not touch_limit_hist:
            fut = self._submit_device_two_phase(**common)
            if fut is not None:
                return fut
        return host_path()

    def _device_pack_base(self, n, events, id_lo, id_hi, dr_lo, dr_hi,
                          cr_lo, cr_hi, flags, timeout, dr_slot, cr_slot,
                          p_found=None, p_tgt=None, n_cols=None):
        return dk.pack_base(
            n, id_lo=id_lo, id_hi=id_hi,
            dr_lo=dr_lo, dr_hi=dr_hi, cr_lo=cr_lo, cr_hi=cr_hi,
            pend_lo=np.asarray(events["pending_id_lo"]),
            pend_hi=np.asarray(events["pending_id_hi"]),
            amount_lo=np.asarray(events["amount_lo"]),
            amount_hi=np.asarray(events["amount_hi"]),
            flags=flags, ledger=np.asarray(events["ledger"]),
            code=events["code"].astype(np.uint32),
            timeout=events["timeout"].astype(np.uint32),
            ts_nonzero=np.asarray(events["timestamp"] != 0),
            dr_slot=dr_slot, cr_slot=cr_slot,
            e_found=np.zeros(n, bool),  # the router proved no duplicates
            p_found=p_found, p_tgt=p_tgt, n_cols=n_cols or dk.N_COLS,
        )

    def _device_fallback(self, timestamp, input_bytes):
        """Exact host re-execution for a flagged batch (the engine has
        resolved every batch before it; the mirror is current)."""

        def run() -> bytes:
            self.stat_fallback_events += len(input_bytes) // TRANSFER_DTYPE.itemsize
            self._dev._suppress_enqueue = True
            try:
                return self._commit_create_transfers(timestamp, input_bytes)
            finally:
                self._dev._suppress_enqueue = False

        return run

    def _tier_translate(self, *slot_arrays):
        """The tiering front door of the device submit paths (reference:
        tpu.py:1728-1748): prefetch the batch's logical touched set into
        the hot set (DeviceEngine.tier_prefetch) and return each array
        translated to hot slots (negative entries pass through); None
        when the batch cannot run on the device (counted as a punt).
        All-resident: the arrays themselves."""
        hot = self._dev.hot
        if hot is None:
            return slot_arrays
        touched = np.concatenate([np.asarray(a, np.int64).ravel() for a in slot_arrays])
        if not self._dev.tier_prefetch(touched):
            self.stat_tier_punts += 1
            return None
        return tuple(hot.translate(np.asarray(a, np.int64)) for a in slot_arrays)

    def _submit_device_orderfree(
        self, events, n, ts_base, id_lo, id_hi, dr_lo, dr_hi, cr_lo, cr_hi,
        flags, timeout, dr_slot, cr_slot, keys_sorted, timestamp, input_bytes,
    ):
        # Packed columns take hot slots; the finish closure keeps the
        # logical ones (the mirror and attributes are logical).
        tr = self._tier_translate(dr_slot, cr_slot)
        if tr is None:
            return None
        t_dr_slot, t_cr_slot = tr
        amount_lo = np.asarray(events["amount_lo"])
        amount_hi = np.asarray(events["amount_hi"])
        has_timeout = bool(timeout.any())
        has_hi = bool(amount_hi.any())
        # Tight 20-byte/event input when the batch's exact facts allow.
        tight = (
            not has_timeout
            and not has_hi
            and (n == 0 or int(amount_lo.max()) < _TIGHT_AMOUNT_LIMIT)
        )
        if tight:
            pk = dk.pack_tight(
                n, id_lo=id_lo, id_hi=id_hi, dr_lo=dr_lo, dr_hi=dr_hi,
                cr_lo=cr_lo, cr_hi=cr_hi,
                pend_lo=np.asarray(events["pending_id_lo"]),
                pend_hi=np.asarray(events["pending_id_hi"]),
                amount_lo=amount_lo, flags=flags,
                ledger=np.asarray(events["ledger"]),
                code=events["code"].astype(np.uint32),
                ts_nonzero=np.asarray(events["timestamp"] != 0),
                dr_slot=t_dr_slot, cr_slot=t_cr_slot,
            )
        else:
            pk = self._device_pack_base(
                n, events, id_lo, id_hi, dr_lo, dr_hi, cr_lo, cr_hi,
                flags, timeout, t_dr_slot, t_cr_slot,
            )
        if has_timeout:
            self._inflight_timeouts = True
        created = self._created_cols(
            events, n, flags, timeout, dr_slot, cr_slot, amount_lo, amount_hi
        )

        def finish(summary) -> bytes:
            results = np.zeros(n, np.uint32)
            results[summary["fail_idx"]] = summary["fail_codes"]
            apply_mask = results == 0
            is_pending = (flags & np.uint32(TF.pending)) != 0
            # Mirror bookkeeping doubles as an admission parity check:
            # the device admitted, so this can never refuse.
            deltas = self._mirror.try_apply_adds(
                dr_slot, cr_slot, amount_lo, amount_hi, is_pending, apply_mask,
            )
            if deltas is None:
                raise AssertionError("device/mirror admission divergence")
            return self._finish_fast(
                n, ts_base, id_lo, id_hi, flags, timeout, results, created,
                last_applied=summary["last_applied"],
            )

        if tight:
            kind = "orderfree_tight"
        else:
            kind = "orderfree" if has_hi else "orderfree_lo"
        return self._dev.submit(
            kind, pk, n, ts_base, finish,
            self._device_fallback(timestamp, input_bytes),
            id_keys=keys_sorted,
            bound=_amount_bound_total(amount_lo, amount_hi),
        )

    def _created_cols(self, events, n, flags, timeout, dr_slot, cr_slot, amount_lo, amount_hi):
        """Store columns of a batch's own events (the creates of a
        device-resolved batch)."""
        return {
            "flags": flags,
            "dr_slot": dr_slot.astype(np.int32),
            "cr_slot": cr_slot.astype(np.int32),
            "amount_lo": amount_lo, "amount_hi": amount_hi,
            "pending_lo": np.asarray(events["pending_id_lo"]),
            "pending_hi": np.asarray(events["pending_id_hi"]),
            "ud128_lo": np.asarray(events["user_data_128_lo"]),
            "ud128_hi": np.asarray(events["user_data_128_hi"]),
            "ud64": np.asarray(events["user_data_64"]),
            "ud32": np.asarray(events["user_data_32"]),
            "timeout": timeout,
            "ledger": np.asarray(events["ledger"]),
            "code": events["code"].astype(np.uint32),
        }

    def _submit_device_linked(
        self, events, n, ts_base, id_lo, id_hi, dr_lo, dr_hi, cr_lo, cr_hi,
        flags, timeout, dr_slot, cr_slot, keys_sorted, timestamp, input_bytes,
    ):
        """A linked-chain batch of posted transfers (limit accounts
        allowed) to K5 (reference: tpu.py:1836-1894); None when the
        tiered hot set cannot hold its accounts."""
        tr = self._tier_translate(dr_slot, cr_slot)
        if tr is None:
            return None
        t_dr_slot, t_cr_slot = tr
        pk = self._device_pack_base(
            n, events, id_lo, id_hi, dr_lo, dr_hi, cr_lo, cr_hi,
            flags, timeout, t_dr_slot, t_cr_slot,
        )
        amount_lo = np.asarray(events["amount_lo"])
        amount_hi = np.asarray(events["amount_hi"])
        created = self._created_cols(
            events, n, flags, timeout, dr_slot, cr_slot, amount_lo, amount_hi
        )
        # The router proved pending_id == 0 for no event; the store keeps
        # zeros, as the reference's does.
        created["pending_lo"] = np.zeros(n, np.uint64)
        created["pending_hi"] = np.zeros(n, np.uint64)

        def finish(summary) -> bytes:
            results = np.zeros(n, np.uint32)
            results[summary["fail_idx"]] = summary["fail_codes"]
            self.stat_linked_batches += 1
            self.stat_resolve_iters += summary["iters"]
            deltas = self._mirror.try_apply_adds(
                dr_slot, cr_slot, amount_lo, amount_hi, np.zeros(n, bool), results == 0,
            )
            if deltas is None:
                raise AssertionError("device/mirror admission divergence")
            return self._finish_fast(
                n, ts_base, id_lo, id_hi, flags, timeout, results, created,
                last_applied=summary["last_applied"],
            )

        # Small-amount specialization: a batch whose total contribution
        # fits i32 (by the host's wrapping u64 sum, as the reference's)
        # runs one int32 prefix per lane; K5 re-verifies the bound and a
        # wrong pick falls back exactly.
        kind = (
            "linked_small"
            if int(amount_lo.sum(dtype=np.uint64)) < (1 << 31)
            else "linked"
        )
        return self._dev.submit(
            kind, pk, n, ts_base, finish,
            self._device_fallback(timestamp, input_bytes),
            id_keys=keys_sorted,
            bound=_amount_bound_total(amount_lo, amount_hi),
        )

    def _submit_device_two_phase(
        self, events, n, ts_base, id_lo, id_hi, dr_lo, dr_hi, cr_lo, cr_hi,
        flags, timeout, dr_slot, cr_slot, keys_sorted, timestamp, input_bytes,
    ):
        """A pending-create + post/void batch to K6 with its target joins
        (reference: tpu.py:1896-2093).  Returns None — the batch takes
        the host path — for an in-batch reference to a non-pending
        create, for a durable target with a timeout or on a limit or
        history account, and when the tiered hot set cannot hold the
        batch's accounts."""
        pend_lo = np.asarray(events["pending_id_lo"])
        pend_hi = np.asarray(events["pending_id_hi"])
        is_pv = (flags & np.uint32(TF.post_pending_transfer | TF.void_pending_transfer)) != 0

        # In-batch pending references (ids unique: the creator is the
        # unique event with that id).
        id_key = pack_u128(id_lo, id_hi)
        order = np.argsort(id_key, kind="stable")
        sorted_keys = id_key[order]
        pend_key = pack_u128(pend_lo, pend_hi)
        pos_c = np.minimum(np.searchsorted(sorted_keys, pend_key), n - 1)
        tgt_ev = np.where(
            is_pv & (sorted_keys[pos_c] == pend_key), order[pos_c], -1
        ).astype(np.int64)
        ib = is_pv & (tgt_ev >= 0) & (tgt_ev < np.arange(n))
        if (ib & ((flags[np.clip(tgt_ev, 0, None)] & np.uint32(TF.pending)) == 0)).any():
            return None

        # Durable pending-target join.
        if is_pv.any():
            p_found, p_row = self._tdir.lookup(pend_lo, pend_hi)
            p_found = p_found & is_pv & ~ib
        else:
            p_found = np.zeros(n, bool)
            p_row = np.zeros(n, np.uint64)
        p_rows_valid = p_row[p_found].astype(np.int64)
        p_tgt = np.full(n, -1, np.int64)
        if len(p_rows_valid):
            uniq_rows, tgt_inverse = np.unique(p_rows_valid, return_inverse=True)
            join = self._store.gather_many(
                ["flags", "dr_slot", "cr_slot", "amount_lo", "amount_hi", "ledger",
                 "code", "ud128_lo", "ud128_hi", "ud64", "ud32", "timeout", "status"],
                uniq_rows,
            )
            if (join["timeout"] != 0).any():
                return None
            pj_acct_flags = (
                self._attrs["flags"][np.clip(join["dr_slot"].astype(np.int64), 0, None)]
                | self._attrs["flags"][np.clip(join["cr_slot"].astype(np.int64), 0, None)]
            ).astype(np.uint32)
            if (pj_acct_flags & _LIMH).any():
                return None
            p_tgt[p_found] = tgt_inverse
            uniq_status = join["status"].astype(np.uint32)

            def jcol(name, dtype):
                out = np.zeros(n, dtype)
                out[p_found] = join[name][tgt_inverse].astype(dtype)
                return out
        else:
            uniq_rows = np.zeros(0, np.int64)
            uniq_status = np.zeros(0, np.uint32)

            def jcol(name, dtype):
                return np.zeros(n, dtype)

        pj_dr_slot = jcol("dr_slot", np.int64)
        pj_cr_slot = jcol("cr_slot", np.int64)
        # Tiered prefetch over the whole touched set: the events' and the
        # durable targets' accounts (an in-batch target's are its
        # creator's).  Only the packed columns take hot slots.
        tr = self._tier_translate(
            dr_slot, cr_slot, np.where(p_found, pj_dr_slot, -1), np.where(p_found, pj_cr_slot, -1),
        )
        if tr is None:
            return None
        t_dr_slot, t_cr_slot, t_pj_dr, t_pj_cr = tr
        pk = self._device_pack_base(
            n, events, id_lo, id_hi, dr_lo, dr_hi, cr_lo, cr_hi,
            flags, timeout, t_dr_slot, t_cr_slot,
            p_found=p_found, p_tgt=p_tgt, n_cols=dk.N_COLS_TP,
        )
        # Target account-id equality predicates (u128 byte compares
        # against the in-batch creator's or the durable target's ids).
        tgt_c = np.clip(tgt_ev, 0, None)
        p_drs = np.where(ib, dr_slot[tgt_c], pj_dr_slot)
        p_crs = np.where(ib, cr_slot[tgt_c], pj_cr_slot)
        pd = np.clip(p_drs, 0, None)
        pc = np.clip(p_crs, 0, None)
        dr_eq = (dr_lo == self._attrs["id_lo"][pd]) & (dr_hi == self._attrs["id_hi"][pd])
        cr_eq = (cr_lo == self._attrs["id_lo"][pc]) & (cr_hi == self._attrs["id_hi"][pc])
        bits_extra = (
            np.where((dr_lo != 0) | (dr_hi != 0), np.uint64(dk.BIT_T_DR_SET), np.uint64(0))
            | np.where((cr_lo != 0) | (cr_hi != 0), np.uint64(dk.BIT_T_CR_SET), np.uint64(0))
            | np.where(dr_eq, np.uint64(dk.BIT_DR_EQ_P), np.uint64(0))
            | np.where(cr_eq, np.uint64(dk.BIT_CR_EQ_P), np.uint64(0))
        )
        p_amt_lo_d = jcol("amount_lo", np.uint64)
        p_amt_hi_d = jcol("amount_hi", np.uint64)
        dstat_ev = np.zeros(n, np.uint32)
        if len(uniq_rows):
            dstat_ev[p_found] = uniq_status[p_tgt[p_found]]
        pk = dk.pack_two_phase_ext(
            pk, n, bits_extra_mask=bits_extra,
            p_flags=jcol("flags", np.uint32).astype(np.uint16),
            p_code=jcol("code", np.uint32).astype(np.uint16),
            p_ledger=jcol("ledger", np.uint32),
            p_dr_slot=np.where(p_found, t_pj_dr, 0),
            p_cr_slot=np.where(p_found, t_pj_cr, 0),
            p_amt_lo=p_amt_lo_d, p_amt_hi=p_amt_hi_d,
            tgt_ev=tgt_ev, dstat_init_ev=dstat_ev,
        )
        amount_lo = np.asarray(events["amount_lo"])
        amount_hi = np.asarray(events["amount_hi"])
        p_amt_lo = np.where(ib, amount_lo[tgt_c], p_amt_lo_d)
        p_amt_hi = np.where(ib, amount_hi[tgt_c], p_amt_hi_d)
        ud128_lo = np.asarray(events["user_data_128_lo"])
        ud128_hi = np.asarray(events["user_data_128_hi"])
        ud64 = np.asarray(events["user_data_64"])
        ud32 = np.asarray(events["user_data_32"]).astype(np.uint32)
        ledger_arr = np.asarray(events["ledger"])
        code_arr = events["code"].astype(np.uint32)
        ctx = dict(
            n=n, ts_base=ts_base, is_pv=is_pv, ib=ib, tgt_ev=tgt_ev,
            p_drs=p_drs, p_crs=p_crs, p_amt_lo=p_amt_lo, p_amt_hi=p_amt_hi,
            p_ud128_lo=np.where(ib, ud128_lo[tgt_c], jcol("ud128_lo", np.uint64)),
            p_ud128_hi=np.where(ib, ud128_hi[tgt_c], jcol("ud128_hi", np.uint64)),
            p_ud64=np.where(ib, ud64[tgt_c], jcol("ud64", np.uint64)),
            p_ud32=np.where(ib, ud32[tgt_c], jcol("ud32", np.uint32)),
            p_ledger=np.where(ib, ledger_arr[tgt_c].astype(np.uint32), jcol("ledger", np.uint32)),
            p_code=np.where(ib, code_arr[tgt_c], jcol("code", np.uint32)),
            uniq_rows=uniq_rows, uniq_status=uniq_status, p_tgt=p_tgt,
            pend_flag=(flags & np.uint32(TF.pending)) != 0,
            post=(flags & np.uint32(TF.post_pending_transfer)) != 0,
        )

        def finish(summary) -> bytes:
            return self._finish_device_two_phase(
                summary, events, id_lo, id_hi, flags, timeout, amount_lo, amount_hi,
                pend_lo, pend_hi, ud128_lo, ud128_hi, ud64, ud32, ledger_arr,
                code_arr, dr_slot, cr_slot, ctx,
            )

        self.stat_two_phase_batches += 1
        kind = "two_phase_lo" if not (amount_hi.any() or p_amt_hi.any()) else "two_phase"
        # In-flight bound: creates add their amount through two slots,
        # finalizers at most max(t.amount, pending.amount) — twice the
        # amounts plus the joined pending amounts covers both.
        bound = 2 * _amount_bound_total(amount_lo, amount_hi) + _amount_bound_total(
            p_amt_lo, p_amt_hi
        )
        return self._dev.submit(
            kind, pk, n, ts_base, finish,
            self._device_fallback(timestamp, input_bytes),
            id_keys=keys_sorted, bound=bound,
        )

    def _finish_device_two_phase(
        self, summary, events, id_lo, id_hi, flags, timeout, amount_lo, amount_hi,
        pend_lo, pend_hi, ud128_lo, ud128_hi, ud64, ud32, ledger_arr, code_arr,
        dr_slot, cr_slot, ctx,
    ) -> bytes:
        """Bookkeeping from K6's codes (reference: tpu.py:2095-2212): the
        mirror takes the adds (a tripwire: the device admitted them) and
        the winners' releases, the store the created transfers and the
        new pending statuses."""
        n = ctx["n"]
        ts_base = ctx["ts_base"]
        is_pv = ctx["is_pv"]
        results = np.zeros(n, np.uint32)
        results[summary["fail_idx"]] = summary["fail_codes"]
        ok = results == 0
        winner = ok & is_pv
        post = ctx["post"]
        pend_flag = ctx["pend_flag"]
        p_drs, p_crs = ctx["p_drs"], ctx["p_crs"]
        p_amt_lo, p_amt_hi = ctx["p_amt_lo"], ctx["p_amt_hi"]
        t_amt_set = (amount_lo != 0) | (amount_hi != 0)
        res_amt_lo = np.where(is_pv & ~t_amt_set, p_amt_lo, amount_lo)
        res_amt_hi = np.where(is_pv & ~t_amt_set, p_amt_hi, amount_hi)

        pend_ok = ok & pend_flag
        plain_ok = ok & ~pend_flag & ~is_pv
        post_win = winner & post
        groups = ((pend_ok, 0, 2, dr_slot, cr_slot, amount_lo, amount_hi),
                  (plain_ok, 1, 3, dr_slot, cr_slot, amount_lo, amount_hi),
                  (post_win, 1, 3, p_drs, p_crs, res_amt_lo, res_amt_hi))
        add_slots, add_cols, add_lo, add_hi = [], [], [], []
        for m, dcol, ccol, drs, crs, lo, hi in groups:
            k = int(m.sum())
            add_slots += [drs[m], crs[m]]
            add_cols += [np.full(k, dcol, np.int64), np.full(k, ccol, np.int64)]
            add_lo += [lo[m], lo[m]]
            add_hi += [hi[m], hi[m]]
        deltas = self._mirror.try_apply_deltas(
            np.concatenate(add_slots), np.concatenate(add_cols),
            np.concatenate(add_lo), np.concatenate(add_hi),
        )
        if deltas is None:
            raise AssertionError("device/mirror admission divergence")
        n_win = int(winner.sum())
        if n_win:
            self._mirror.apply_subs(
                np.concatenate([p_drs[winner], p_crs[winner]]),
                np.concatenate([np.zeros(n_win, np.int64), np.full(n_win, 2, np.int64)]),
                np.concatenate([p_amt_lo[winner]] * 2),
                np.concatenate([p_amt_hi[winner]] * 2),
            )

        ud128_set = (ud128_lo != 0) | (ud128_hi != 0)
        created = {
            "flags": flags,
            "dr_slot": np.where(is_pv, p_drs, dr_slot).astype(np.int32),
            "cr_slot": np.where(is_pv, p_crs, cr_slot).astype(np.int32),
            "amount_lo": np.where(is_pv, res_amt_lo, amount_lo),
            "amount_hi": np.where(is_pv, res_amt_hi, amount_hi),
            "pending_lo": pend_lo, "pending_hi": pend_hi,
            "ud128_lo": np.where(is_pv & ~ud128_set, ctx["p_ud128_lo"], ud128_lo),
            "ud128_hi": np.where(is_pv & ~ud128_set, ctx["p_ud128_hi"], ud128_hi),
            "ud64": np.where(is_pv & (ud64 == 0), ctx["p_ud64"], ud64),
            "ud32": np.where(is_pv & (ud32 == 0), ctx["p_ud32"], ud32),
            "timeout": np.zeros(n, np.uint64),
            "ledger": np.where(is_pv, ctx["p_ledger"], ledger_arr).astype(np.uint32),
            "code": np.where(is_pv, ctx["p_code"], code_arr).astype(np.uint32),
        }
        final = np.where(post, np.uint32(kernel.S_POSTED), np.uint32(kernel.S_VOIDED))
        inb_status = np.where(pend_ok, np.uint32(kernel.S_PENDING), np.uint32(0))
        ib_win = winner & ctx["ib"]
        inb_status[ctx["tgt_ev"][ib_win]] = final[ib_win]
        uniq_status = ctx["uniq_status"]
        dstat = uniq_status.copy()
        dur_win = winner & ~ctx["ib"]
        dstat[ctx["p_tgt"][dur_win]] = final[dur_win]
        zeros_u64 = np.zeros(n, np.uint64)
        self._post_process_transfers(
            n, ts_base, id_lo, id_hi, flags, timeout, results, ok, created,
            inb_status, uniq_status, dstat, ctx["uniq_rows"], None, None,
            summary["last_applied"], zeros_u64, zeros_u64, no_history=True,
        )
        fail_idx = np.flatnonzero(results != 0)
        reply = np.zeros(len(fail_idx), dtype=CREATE_RESULT_DTYPE)
        reply["index"] = fail_idx.astype(np.uint32)
        reply["result"] = results[fail_idx]
        return reply.tobytes()

    def _lookup_accounts_device(self, input_bytes: bytes):
        """lookup_accounts with balances gathered from the DEVICE table
        (rides the stream, so in-flight batches are visible without
        draining)."""
        ids = np.frombuffer(input_bytes, dtype=types.U128_PAIR_DTYPE)
        found, slots = self._acct_dir.lookup(
            ids["lo"].astype(np.uint64), ids["hi"].astype(np.uint64)
        )
        hit = np.flatnonzero(found)
        if len(hit) == 0:
            return ReplyFuture(value=b"")
        slots_hit = slots[hit].astype(np.int64)
        return self._dev.lookup(
            slots_hit, lambda rows: self._account_rows(slots_hit, rows[: len(slots_hit)])
        )

    # ------------------------------------------------------------------
    # The exact host lane: the host engine's create_transfers, the
    # device engine's host path and the re-execution of a flagged batch.

    def _commit_create_transfers(self, timestamp: int, input_bytes: bytes,
                                 decoded: dict | None = None) -> bytes:
        """`decoded`: the batch's _decode_static, when a declined wave
        dispatch already made it (account attributes are immutable and
        the decode reads nothing else, so it is still current)."""
        events = np.frombuffer(input_bytes, dtype=TRANSFER_DTYPE)
        n = len(events)
        if n == 0:
            return b""
        self.stat_host_semantic_events += n
        ts_base = timestamp - n + 1
        # The native lanes first (reference: tpu.py:2266-2298): each
        # covers decode, ladder, account resolution, duplicates and
        # admission in one call, and None means it mutated nothing.
        # TB_WAVES=1/exact/scan bypasses them, so the exact path on the
        # device sees the whole stream.
        if self._native is not None and waves.mode() not in ("1", "exact", "scan"):
            native_out = self._native.commit_transfers(input_bytes, n, ts_base)
            if native_out is not None:
                self.stat_device_events += n
                return self._finish_native_fast(events, n, ts_base, *native_out)
            nl = self._native.commit_linked(input_bytes, n, ts_base)
            if nl is not None:
                results, dr_slot, cr_slot, deltas, last_applied = nl
                self.stat_device_events += n
                self.stat_linked_batches += 1
                return self._finish_native_fast(
                    events, n, ts_base, results, dr_slot, cr_slot, deltas,
                    last_applied=last_applied,
                )
            reply = self._try_native_two_phase(input_bytes, events, n, ts_base)
            if reply is not None:
                self.stat_device_events += n
                self.stat_two_phase_batches += 1
                return reply
        d = decoded if decoded is not None else self._decode_static(events, n)
        return self._commit_transfers_resolved(
            n, ts_base, events, d["id_lo"], d["id_hi"], d["pend_lo"],
            d["pend_hi"], d["flags"], d["timeout"], d["dr_slot"],
            d["cr_slot"], d["amount_lo"], d["amount_hi"], d["ledger"],
            d["code"], d["static"], d["is_pv"], d["dr_flags"],
            d["cr_flags"], d["dr_zero"], d["cr_zero"],
        )

    def _decode_static(self, events: np.ndarray, n: int) -> dict:
        """Column decode + account resolution + the static precedence
        ladder — everything about a batch that is independent of
        balances and durable joins."""
        id_lo = np.asarray(events["id_lo"])
        id_hi = np.asarray(events["id_hi"])
        dr_lo = np.asarray(events["debit_account_id_lo"])
        dr_hi = np.asarray(events["debit_account_id_hi"])
        cr_lo = np.asarray(events["credit_account_id_lo"])
        cr_hi = np.asarray(events["credit_account_id_hi"])
        pend_lo = np.asarray(events["pending_id_lo"])
        pend_hi = np.asarray(events["pending_id_hi"])
        amount_lo = np.asarray(events["amount_lo"])
        amount_hi = np.asarray(events["amount_hi"])
        flags = events["flags"].astype(np.uint32)
        timeout = events["timeout"].astype(np.uint64)
        ledger = np.asarray(events["ledger"])
        code = events["code"].astype(np.uint32)

        is_pv = (flags & (dk.F_POST | dk.F_VOID)) != 0

        dr_found, dr_slot_u = self._acct_dir.lookup(dr_lo, dr_hi)
        cr_found, cr_slot_u = self._acct_dir.lookup(cr_lo, cr_hi)
        dr_slot = np.where(dr_found, dr_slot_u.astype(np.int64), -1).astype(np.int32)
        cr_slot = np.where(cr_found, cr_slot_u.astype(np.int64), -1).astype(np.int32)
        dr_c = np.clip(dr_slot, 0, None)
        cr_c = np.clip(cr_slot, 0, None)
        attrs = self._attrs
        dr_flags = np.where(dr_found, attrs["flags"][dr_c], 0).astype(np.uint32)
        cr_flags = np.where(cr_found, attrs["flags"][cr_c], 0).astype(np.uint32)
        dr_ledger = np.where(dr_found, attrs["ledger"][dr_c], 0).astype(np.uint32)
        cr_ledger = np.where(cr_found, attrs["ledger"][cr_c], 0).astype(np.uint32)

        id_zero = (id_lo == 0) & (id_hi == 0)
        id_max = (id_lo == np.uint64(U64_MAX)) & (id_hi == np.uint64(U64_MAX))
        reserved = (flags & ~np.uint32(0x3F)) != 0
        dr_zero = (dr_lo == 0) & (dr_hi == 0)
        dr_max = (dr_lo == np.uint64(U64_MAX)) & (dr_hi == np.uint64(U64_MAX))
        cr_zero = (cr_lo == 0) & (cr_hi == 0)
        cr_max = (cr_lo == np.uint64(U64_MAX)) & (cr_hi == np.uint64(U64_MAX))
        same_acct = (dr_lo == cr_lo) & (dr_hi == cr_hi)
        pend_zero = (pend_lo == 0) & (pend_hi == 0)
        not_pending_flag = (flags & dk.F_PENDING) == 0
        not_balancing = (flags & (dk.F_BAL_DR | dk.F_BAL_CR)) == 0
        amount_zero = (amount_lo == 0) & (amount_hi == 0)

        static = np.zeros(n, np.uint32)
        _apply_code(static, reserved, CTR.reserved_flag)
        _apply_code(static, id_zero, CTR.id_must_not_be_zero)
        _apply_code(static, id_max, CTR.id_must_not_be_int_max)

        # Post/void static prefix.
        post = (flags & dk.F_POST) != 0
        void = (flags & dk.F_VOID) != 0
        pv_excl = (
            (post & void)
            | (is_pv & ((flags & dk.F_PENDING) != 0))
            | (is_pv & ((flags & dk.F_BAL_DR) != 0))
            | (is_pv & ((flags & dk.F_BAL_CR) != 0))
        )
        pend_max = (pend_lo == np.uint64(U64_MAX)) & (pend_hi == np.uint64(U64_MAX))
        pend_self = (pend_lo == id_lo) & (pend_hi == id_hi)
        _apply_code(static, is_pv & pv_excl, CTR.flags_are_mutually_exclusive)
        _apply_code(static, is_pv & pend_zero, CTR.pending_id_must_not_be_zero)
        _apply_code(static, is_pv & pend_max, CTR.pending_id_must_not_be_int_max)
        _apply_code(static, is_pv & pend_self, CTR.pending_id_must_be_different)
        _apply_code(static, is_pv & (timeout != 0), CTR.timeout_reserved_for_pending_transfer)

        # Normal static ladder (reference: src/state_machine.zig:1465-1504).
        nm = ~is_pv
        _apply_code(static, nm & dr_zero, CTR.debit_account_id_must_not_be_zero)
        _apply_code(static, nm & dr_max, CTR.debit_account_id_must_not_be_int_max)
        _apply_code(static, nm & cr_zero, CTR.credit_account_id_must_not_be_zero)
        _apply_code(static, nm & cr_max, CTR.credit_account_id_must_not_be_int_max)
        _apply_code(static, nm & same_acct, CTR.accounts_must_be_different)
        _apply_code(static, nm & ~pend_zero, CTR.pending_id_must_be_zero)
        _apply_code(
            static, nm & not_pending_flag & (timeout != 0),
            CTR.timeout_reserved_for_pending_transfer,
        )
        _apply_code(static, nm & not_balancing & amount_zero, CTR.amount_must_not_be_zero)
        _apply_code(static, nm & (ledger == 0), CTR.ledger_must_not_be_zero)
        _apply_code(static, nm & (code == 0), CTR.code_must_not_be_zero)
        _apply_code(static, nm & ~dr_found, CTR.debit_account_not_found)
        _apply_code(static, nm & ~cr_found, CTR.credit_account_not_found)
        _apply_code(
            static, nm & (dr_ledger != cr_ledger), CTR.accounts_must_have_the_same_ledger
        )
        _apply_code(
            static, nm & (ledger != dr_ledger),
            CTR.transfer_must_have_the_same_ledger_as_accounts,
        )
        return dict(
            id_lo=id_lo, id_hi=id_hi, dr_lo=dr_lo, dr_hi=dr_hi, cr_lo=cr_lo,
            cr_hi=cr_hi, pend_lo=pend_lo, pend_hi=pend_hi, amount_lo=amount_lo,
            amount_hi=amount_hi, flags=flags, timeout=timeout, ledger=ledger,
            code=code, is_pv=is_pv, dr_slot=dr_slot, cr_slot=cr_slot,
            dr_flags=dr_flags, cr_flags=cr_flags, dr_zero=dr_zero,
            cr_zero=cr_zero, static=static,
        )

    def _commit_transfers_resolved(
        self, n, ts_base, events, id_lo, id_hi, pend_lo, pend_hi,
        flags, timeout, dr_slot, cr_slot, amount_lo, amount_hi,
        ledger, code, static, is_pv, dr_flags, cr_flags, dr_zero, cr_zero,
    ) -> bytes:
        """The Python lanes and the exact path (reference:
        tpu.py:2445-2656): order-free batches apply through the mirror's
        admission (_commit_fast), linked chains of plain posted transfers
        through linked_resolve (_commit_linked_fast) and post/void
        batches through two_phase_resolve (_try_two_phase_fast); the
        rest, and a batch a lane declines, runs the exact path: the
        native serial engine when the library is loaded, else a wave
        plan when TB_WAVES admits one, else the whole scan K3."""
        wave_mode = waves.mode()
        # "1" / "exact" / "scan" route every batch to the exact path on
        # the device; "1" also forces the plan past its profitability
        # gate.
        wave_force = wave_mode in ("1", "exact", "scan")
        native_exact = self._native is not None and not wave_force
        # The native engine takes any length; K3 and the waves take the
        # batch buckets.
        B = n if native_exact else next(b for b in _BATCH_BUCKETS if b >= n)
        e_found, e_row = self._tdir.lookup(id_lo, id_hi)
        order_free = not (
            flags
            & np.uint32(
                TF.linked | TF.post_pending_transfer | TF.void_pending_transfer
                | TF.balancing_debit | TF.balancing_credit
            )
        ).any()
        ascending = n == 1 or bool(
            (
                (id_hi[1:] > id_hi[:-1])
                | ((id_hi[1:] == id_hi[:-1]) & (id_lo[1:] > id_lo[:-1]))
            ).all()
        )
        # The resolvers exclude only balancing batches (order_free already
        # implies none).  In-batch duplicates: ascending ids prove
        # uniqueness, else a 64-bit key mix (a collision only costs the
        # exact path).
        route_candidate = not (flags & np.uint32(TF.balancing_debit | TF.balancing_credit)).any()
        ids_unique = False
        if route_candidate:
            ids_unique = ascending
            if not ids_unique:
                id_mix = id_lo * np.uint64(0x9E3779B97F4A7C15) + id_hi * np.uint64(
                    0xC2B2AE3D27D4EB4F
                )
                ids_unique = len(np.unique(id_mix)) == n
        if order_free and ids_unique and not e_found.any() and not wave_force:
            if not ((dr_flags | cr_flags) & _LIMH).any():
                reply = self._commit_fast(
                    n, ts_base, events, id_lo, id_hi, pend_lo, pend_hi,
                    flags, timeout, dr_slot, cr_slot, amount_lo, amount_hi,
                    ledger, code, static,
                )
                if reply is not None:
                    self.stat_device_events += n
                    return reply

        # Linked chains and limit accounts over plain posted transfers (a
        # chain-free batch is chains of length 1): exact verdicts from the
        # fixpoint resolver, then the mirror's admission.
        if (
            ids_unique
            and not wave_force
            and not (
                flags
                & np.uint32(
                    TF.pending | TF.post_pending_transfer | TF.void_pending_transfer
                    | TF.balancing_debit | TF.balancing_credit
                )
            ).any()
            and not e_found.any()
            and not ((dr_flags | cr_flags) & np.uint32(AF.history)).any()
        ):
            reply = self._commit_linked_fast(
                n, ts_base, events, id_lo, id_hi, flags, timeout,
                dr_slot, cr_slot, amount_lo, amount_hi, ledger, code,
                static, dr_flags, cr_flags,
            )
            if reply is not None:
                self.stat_device_events += n
                self.stat_linked_batches += 1
                return reply

        j = self._exact_joins(
            n, B, id_lo, id_hi, pend_lo, pend_hi, is_pv, ascending, e_found, e_row,
        )
        # Post/void batches whose verdicts do not depend on balances: one
        # closed-form pass (pendings, first-wins finalization, adds).
        if is_pv.any() and ids_unique and not e_found.any() and not wave_force:
            reply = self._try_two_phase_fast(
                n, ts_base, events, id_lo, id_hi, pend_lo, pend_hi, flags,
                timeout, dr_slot, cr_slot, amount_lo, amount_hi, code,
                static, is_pv, dr_flags, cr_flags, j,
            )
            if reply is not None:
                self.stat_device_events += n
                self.stat_two_phase_batches += 1
                return reply
        ev = self._build_scan_events(
            n, B, events, flags, static, amount_lo, amount_hi, pend_lo, pend_hi,
            timeout, ledger, code, dr_slot, cr_slot, dr_flags, cr_flags,
            dr_zero, cr_zero, e_found, j,
        )
        self.stat_exact_events += n
        if native_exact:
            # The serial exact engine in C++ (csrc/host/tb_exact.inc):
            # the scan's inputs and packed outputs; it mutates the shared
            # mirror in place, and its deltas (copied: the buffers are
            # reused per call) ride the write-behind lane.
            packed_np, deltas = self._native.commit_exact(
                ev, kernel.EVENT_FIELDS, j["dstat_init"], B, n, ts_base
            )
            self._dev.enqueue(*[d.copy() for d in deltas])
            return self._finish_exact_outputs(
                kernel.unpack_outputs(packed_np), n, ts_base, id_lo, id_hi, flags,
                timeout, j["uniq_rows"], j["dstat_init"], mirror_from_hist=False,
            )
        wave_plan = None
        if wave_mode not in ("0", "scan"):
            wave_plan = self._plan_wave_execution(
                n, flags, dr_slot, cr_slot, dr_flags, cr_flags, j["id_group"],
                j["p_group"], j["p_tgt"], j["p_found"], j["gather_p"], is_pv,
                amount_lo, amount_hi, force=(wave_mode == "1"),
            )
        if wave_plan is not None:
            # Wave events' snapshots become batch finals at finalize
            # (history events never ride waves).
            packed = self._run_exact(ev, j["dstat_init"], n, ts_base, wave_plan,
                                     _pad(wave_plan.wave_mask, B))
            self.stat_wave_batches += 1
            self.stat_wave_steps += wave_plan.n_steps
            self.stat_wave_events += n
            self.stat_wave_parallel_events += wave_plan.parallel_events
        else:
            self.stat_exact_batches += 1
            packed = self._run_exact(ev, j["dstat_init"], n, ts_base)
        out = kernel.unpack_outputs(packed)
        return self._finish_exact_outputs(
            out, n, ts_base, id_lo, id_hi, flags, timeout, j["uniq_rows"],
            j["dstat_init"],
        )

    def _run_exact(self, ev: dict, dstat_init: np.ndarray, n: int, ts_base: int,
                   plan=None, hist_fix=None) -> np.ndarray:
        """One exact batch over the engine's table (read through its
        flush barrier, written back in place) -> the (B, 37) u64
        outputs: by the wave `plan` when there is one, else one K3
        launch."""
        dev = self._dev
        table = dev.read()
        if plan is not None:
            if self._wave_scratch is None and table.device.type == "cuda":
                self._wave_scratch = waves.WaveScratch(table.device)
            packed = waves.run_create_transfers_waves(
                table, ev, dstat_init, n, ts_base, plan, hist_fix,
                scratch=self._wave_scratch, plain=self.plain,
            )
            touched = waves.touched_slots(ev, n)
        else:
            pk_np = kernel.pack_events(ev)
            touched = kernel.touched_slots(pk_np, n)
            pk = from_u64(pk_np, table.device)
            dstat = torch.from_numpy(dstat_init.astype(np.uint32).view(np.int32)).to(table.device)
            if self.plain:
                packed = kernel.run_exact_plain(table, pk, dstat, n, ts_base)
            else:
                if self._exact_scratch is None and table.device.type == "cuda":
                    self._exact_scratch = kernel.ExactScratch(_BATCH_BUCKETS[-1], table.device)
                _, packed = kernel.run_create_transfers(
                    table, pk, dstat, n, ts_base, scratch=self._exact_scratch
                )
        dev.write_back(table)
        if self.engine == "device":
            # The swap does not move the device digest: fold in every
            # row the batch could have written (a post/void moves its
            # pending's rows, which may differ from its own).
            dev.exact_written(touched)
        return to_u64(packed)

    # ------------------------------------------------------------------
    # Wave routing (reference: tpu.py:2876-3040).

    def _plan_wave_execution(
        self, n, flags, dr_slot, cr_slot, dr_flags, cr_flags,
        id_group, p_group, p_tgt, p_found, gather_p, is_pv,
        amount_lo, amount_hi, force: bool = False, extra_bound: int = 0,
    ):
        """Wave routing of one exact-path batch: dependency metadata ->
        the cheap chain-dominance decline -> per-column overflow
        admission -> level partition + profitability.  Returns the plan,
        or None for the scan (never a wrong answer, only a slower one).
        `extra_bound` is the device window's in-flight bound."""
        meta, _pv_serial = self._wave_metadata(
            n, flags, dr_slot, cr_slot, dr_flags, cr_flags,
            id_group, p_group, p_tgt, p_found, gather_p,
        )
        if self._chain_dominated(n, meta, force):
            return None
        adm = self._wave_admission(
            n, meta, flags, p_found, gather_p, is_pv,
            amount_lo, amount_hi, extra_bound=extra_bound,
        )
        if adm is None:
            return None
        inb_pairs, batch_bound = adm
        return self._grade_plan(n, meta, inb_pairs, batch_bound, force)

    def _grade_plan(self, n, meta, inb_pairs, batch_bound, force: bool):
        """Partition + profitability + bound: the one copy the host path
        and the window submission share."""
        plan = waves.plan_waves(n, meta, inb_pairs=inb_pairs)
        if not (force or plan.profitable()):
            return None
        plan.batch_bound = batch_bound
        return plan

    def _wave_metadata(
        self, n, flags, dr_slot, cr_slot, dr_flags, cr_flags,
        id_group, p_group, p_tgt, p_found, gather_p,
    ):
        """Dependency metadata (resolve.py) and the pv_serial routing
        fact: a post/void whose durable target could sit on a history
        account goes to the scan, as every history event does."""
        p_drs = gather_p["dr_slot"].astype(np.int64)
        p_crs = gather_p["cr_slot"].astype(np.int64)
        hist_ev = ((dr_flags | cr_flags) & np.uint32(AF.history)) != 0
        pv_hist = False
        if p_found.any():
            pj = np.unique(np.concatenate([p_drs[p_found], p_crs[p_found]]))
            pj = pj[pj >= 0]
            pv_hist = bool((self._attrs["flags"][pj] & np.uint32(AF.history)).any())
        pv_serial = bool(hist_ev.any() or pv_hist)
        meta = resolve.wave_dependency_metadata(
            n, flags, dr_slot, cr_slot, dr_flags, cr_flags,
            id_group, p_group, p_tgt, p_found, p_drs, p_crs,
            pv_serial=pv_serial,
        )
        meta["p_drs"] = p_drs
        meta["p_crs"] = p_crs
        return meta, pv_serial

    def _wave_admission(
        self, n, meta, flags, p_found, gather_p, is_pv,
        amount_lo, amount_hi, extra_bound: int = 0,
    ):
        """Per-column overflow admission against the mirror (plus the
        window's in-flight bound): (inb_pairs, batch_bound), or None
        when the batch lacks provable u128 headroom."""
        p_drs = meta["p_drs"]
        p_crs = meta["p_crs"]
        # Per-event amount upper bounds: balancing zero-amount means
        # maxInt u64, a post/void applies at most max(t.amount,
        # pending.amount), an in-batch inherit at most the largest
        # create bound.
        is_balancing = (flags & np.uint32(TF.balancing_debit | TF.balancing_credit)) != 0
        amount_zero = (amount_lo == 0) & (amount_hi == 0)
        bound_lo = np.where(is_balancing & amount_zero, np.uint64(U64_MAX), amount_lo)
        bound_hi = np.where(is_balancing & amount_zero, np.uint64(0), amount_hi)
        p_amt_lo = gather_p["amount_lo"].astype(np.uint64)
        p_amt_hi = gather_p["amount_hi"].astype(np.uint64)
        p_bigger = is_pv & (
            (p_amt_hi > bound_hi) | ((p_amt_hi == bound_hi) & (p_amt_lo > bound_lo))
        )
        bound_lo = np.where(p_bigger, p_amt_lo, bound_lo)
        bound_hi = np.where(p_bigger, p_amt_hi, bound_hi)
        inb_inherit = is_pv & amount_zero & ~p_found
        if inb_inherit.any():
            nm = ~is_pv
            if nm.any():
                mx_hi = bound_hi[nm].max()
                at = bound_hi[nm] == mx_hi
                mx_lo = bound_lo[nm][at].max()
                bound_lo = np.where(inb_inherit, mx_lo, bound_lo)
                bound_hi = np.where(inb_inherit, mx_hi, bound_hi)
        inb_ev, inb_slot = waves._inb_pv_write_pairs(n, meta)
        slots = np.concatenate(
            [meta["ev_dr"], meta["ev_cr"], p_drs[p_found], p_crs[p_found], inb_slot]
        )
        bounds_lo = np.concatenate(
            [bound_lo, bound_lo, bound_lo[p_found], bound_lo[p_found], bound_lo[inb_ev]]
        )
        bounds_hi = np.concatenate(
            [bound_hi, bound_hi, bound_hi[p_found], bound_hi[p_found], bound_hi[inb_ev]]
        )
        if not waves.admission_ok(
            self._mirror.lo, self._mirror.hi, slots, bounds_lo, bounds_hi,
            extra=extra_bound,
        ):
            return None
        return (inb_ev, inb_slot), _amount_bound_total(bound_lo, bound_hi)

    @staticmethod
    def _chain_dominated(n, meta, force: bool) -> bool:
        """Cheap pre-admission decline: chain members cost one exact step
        each unless they can ride a chain wave."""
        n_chain = int(meta["chain_member"].sum())
        chain_wave_possible = (
            waves.chain_max() >= 2
            and not meta["chain_serial"].any()
            and not (meta["chain_linked"] & meta["is_pv"]).any()
        )
        return (
            not force
            and bool(n_chain)
            and not chain_wave_possible
            and n < waves.min_ratio() * n_chain
        )

    def _observe_plan_time(self, t0: float) -> None:
        """One wave-routing pass's host seconds (decode, joins,
        admission and the partitioner when it ran)."""
        self.stat_dev_wave_plan_s += _time.perf_counter() - t0

    def _dev_wave_decline(self, reason: str) -> None:
        self.stat_dev_wave_declined += 1
        reasons = self.stat_dev_wave_decline_reasons
        reasons[reason] = reasons.get(reason, 0) + 1

    def _try_submit_device_waves(self, events, n, timestamp, input_bytes):
        """Wave-dispatch one window batch that fell off the semantic
        kernels (reference: tpu.py:1546-1720): host joins and overflow
        admission now, then either SPECULATIVE submission (the whole
        batch as one validated step at launch, only a conflicted
        residue planned: DeviceEngine._exec_spec) or the wave plan
        (DeviceEngine._exec_waves), against the device table at window
        launch; the exact path's bookkeeping runs from the fetched
        packed outputs at materialization.  Returns (reply_future,
        None), or (None, decoded) on decline, and the caller drains to
        the host path reusing the decode.

        Planning against a LAGGING mirror is sound: the hazard probe
        drains on any id or pending-reference overlap with in-flight
        records, and the admission charges every in-flight record's
        amount bound on top of the mirror (DeviceEngine.inflight_bound).
        A tiered table declines ("tier"): the wave records index the
        table by logical slot.  A row-sharded engine declines a mesh that
        does not divide its capacity ("mesh") and a plan with scan
        segments ("shard_plan": the sharded executor runs wave and chain
        segments only), and never speculates.  A degraded engine
        declines, and the hazard probe's drain may demote it
        ("degraded")."""
        dev = self._dev
        dm = waves.dev_mode()
        if dm == "0" or n == 0 or n > _BATCH_BUCKETS[-1]:
            return None, None
        if dev.state is not EngineState.healthy:
            return None, None
        if dev.hot is not None:
            self._dev_wave_decline("tier")
            return None, None
        is_sharded = dev.sharding is not None
        if is_sharded and dev.wave_mesh() is None:
            self._dev_wave_decline("mesh")
            return None, None
        t0 = _time.perf_counter()
        d = self._decode_static(events, n)
        ts_base = timestamp - n + 1

        keys = pack_u128(d["id_lo"], d["id_hi"])
        probe = keys
        if d["is_pv"].any():
            ref = (d["pend_lo"] != 0) | (d["pend_hi"] != 0)
            probe = np.concatenate([probe, pack_u128(d["pend_lo"][ref], d["pend_hi"][ref])])
        if dev.inflight_ids_hit(probe):
            self._engine_drain()
            if dev.state is not EngineState.healthy:
                self._dev_wave_decline("degraded")
                return None, d

        e_found, e_row = self._tdir.lookup(d["id_lo"], d["id_hi"])
        id_lo, id_hi = d["id_lo"], d["id_hi"]
        ascending = n == 1 or bool(
            (
                (id_hi[1:] > id_hi[:-1])
                | ((id_hi[1:] == id_hi[:-1]) & (id_lo[1:] > id_lo[:-1]))
            ).all()
        )
        B = next(b for b in _BATCH_BUCKETS if b >= n)
        j = self._exact_joins(
            n, B, id_lo, id_hi, d["pend_lo"], d["pend_hi"], d["is_pv"],
            ascending, e_found, e_row,
        )
        meta, pv_serial = self._wave_metadata(
            n, d["flags"], d["dr_slot"], d["cr_slot"], d["dr_flags"],
            d["cr_flags"], j["id_group"], j["p_group"], j["p_tgt"],
            j["p_found"], j["gather_p"],
        )
        # Speculate unless the host already knows too much of the batch
        # must replay (chain members, history events, serialized
        # post/voids); "force" speculates regardless.
        sm_mode = waves.spec_mode()
        speculate = sm_mode != "0" and not is_sharded
        if speculate and sm_mode != "force":
            speculate = int(meta["chain_member"].sum()) <= waves.spec_residue_cap() * n
        if not speculate and self._chain_dominated(n, meta, force=(dm == "1")):
            self._observe_plan_time(t0)
            self._dev_wave_decline("plan")
            return None, d
        adm = self._wave_admission(
            n, meta, d["flags"], j["p_found"], j["gather_p"], d["is_pv"],
            d["amount_lo"], d["amount_hi"], extra_bound=dev.inflight_bound(),
        )
        if adm is None:
            self._observe_plan_time(t0)
            self._dev_wave_decline("plan")
            return None, d
        inb_pairs, batch_bound = adm
        plan = None
        if not speculate:
            plan = self._grade_plan(n, meta, inb_pairs, batch_bound, force=(dm == "1"))
        self._observe_plan_time(t0)
        if not speculate:
            if plan is None:
                self._dev_wave_decline("plan")
                return None, d
            if is_sharded and not waves.plan_shardable(plan):
                self._dev_wave_decline("shard_plan")
                return None, d

        ev = self._build_scan_events(
            n, B, events, d["flags"], d["static"], d["amount_lo"], d["amount_hi"],
            d["pend_lo"], d["pend_hi"], d["timeout"], d["ledger"], d["code"],
            d["dr_slot"], d["cr_slot"], d["dr_flags"], d["cr_flags"], d["dr_zero"],
            d["cr_zero"], e_found, j,
        )
        if d["timeout"].any():
            self._inflight_timeouts = True
        flags, timeout = d["flags"], d["timeout"]
        uniq_rows, dstat_init = j["uniq_rows"], j["dstat_init"]

        def finish(packed_np) -> bytes:
            return self._finish_exact_outputs(
                kernel.unpack_outputs(packed_np), n, ts_base, id_lo, id_hi, flags,
                timeout, uniq_rows, dstat_init,
            )

        self.stat_dev_wave_batches += 1
        self.stat_dev_wave_events += n
        fallback = self._device_fallback(timestamp, input_bytes)
        if speculate:
            # The in-flight charge is the WHOLE batch's bound, never the
            # committed subset's.
            return dev.submit_speculative(
                ev, dstat_init, n, ts_base, meta["chain_member"], pv_serial, finish,
                fallback, id_keys=np.sort(probe), bound=batch_bound,
            ), None
        self.stat_dev_wave_steps += plan.n_steps
        return dev.submit_waves(
            ev, dstat_init, n, ts_base, plan, _pad(plan.wave_mask, B), finish, fallback,
            id_keys=np.sort(probe), bound=plan.batch_bound,
        ), None

    def _finish_exact_outputs(self, out, n, ts_base, id_lo, id_hi, flags, timeout,
                              uniq_rows, dstat_init, mirror_from_hist: bool = True) -> bytes:
        """Exact-path bookkeeping from the unpacked scan outputs: the
        mirror rebuilt from the applied events' row snapshots (unless
        `mirror_from_hist` is False: the native engine updated it), the
        store, statuses, expiry, pulses and history (reference:
        tpu.py:2677)."""
        results = out["results"][:n]
        created_mask = out["created_mask"][:n]
        created = {f: out["created"][f][:n] for f in kernel.CREATED_FIELDS}
        inb_status = out["inb_status"][:n]
        hist_dr = out["hist_dr"][:n]
        hist_cr = out["hist_cr"][:n]

        # Events whose effects persisted (results == 0: rollback rewrote
        # failed chain members) carry post-apply snapshots of both rows;
        # interleaved in event order, the last write wins.
        ok_idx = np.flatnonzero(results == 0)
        if mirror_from_hist and len(ok_idx):
            slots2 = np.empty(2 * len(ok_idx), np.int64)
            slots2[0::2] = created["dr_slot"][ok_idx]
            slots2[1::2] = created["cr_slot"][ok_idx]
            rows2 = np.empty((2 * len(ok_idx), 8), np.uint64)
            rows2[0::2] = hist_dr[ok_idx]
            rows2[1::2] = hist_cr[ok_idx]
            self._mirror.set_rows8(slots2, rows2)

        self._post_process_transfers(
            n, ts_base, id_lo, id_hi, flags, timeout, results, created_mask,
            created, inb_status, dstat_init, out["dstat"], uniq_rows,
            hist_dr, hist_cr, int(out["last_applied"]),
            out["pulse_create"][:n], out["pulse_remove"][:n],
        )
        fail_idx = np.flatnonzero(results != 0)
        reply = np.zeros(len(fail_idx), dtype=CREATE_RESULT_DTYPE)
        reply["index"] = fail_idx.astype(np.uint32)
        reply["result"] = results[fail_idx]
        return reply.tobytes()

    def _exact_joins(self, n, B, id_lo, id_hi, pend_lo, pend_hi, is_pv, ascending,
                     e_found, e_row) -> dict:
        """Exact-path joins: compact id groups, in-batch pending
        reference groups, durable duplicate / pending-target gathers and
        the deduplicated durable-status seed (reference: tpu.py:2725)."""
        id_key = pack_u128(id_lo, id_hi)
        if ascending:
            unique_ids = id_key
            id_group = np.arange(n)
        else:
            unique_ids, id_group = np.unique(id_key, return_inverse=True)
        pend_key = pack_u128(pend_lo, pend_hi)
        pos = np.searchsorted(unique_ids, pend_key)
        pos_c = np.minimum(pos, len(unique_ids) - 1)
        p_group = np.where(is_pv & (unique_ids[pos_c] == pend_key), pos_c, -1).astype(np.int32)

        if is_pv.any():
            p_found, p_row = self._tdir.lookup(pend_lo, pend_hi)
            p_found = p_found & is_pv
        else:
            p_found = np.zeros(n, bool)
            p_row = np.zeros(n, np.uint64)
        er = np.clip(e_row, 0, None).astype(np.int64)
        pr = np.clip(p_row, 0, None).astype(np.int64)

        def gather(found, rows):
            full = {f: np.zeros(n, np.dtype(_STORE_FIELDS[f])) for f in _JOIN_FIELDS}
            idx = np.flatnonzero(found)
            if len(idx):
                got = self._store.gather_many(list(_JOIN_FIELDS), rows[idx])
                for f in _JOIN_FIELDS:
                    full[f][idx] = got[f]
            return full

        gather_e = gather(e_found, er)
        gather_p = gather(p_found, pr)
        p_rows_valid = p_row[p_found].astype(np.int64)
        if len(p_rows_valid):
            uniq_rows, first_idx, tgt_inverse = np.unique(
                p_rows_valid, return_index=True, return_inverse=True
            )
            rep_event = np.flatnonzero(p_found)[first_idx]
            uniq_status = gather_p["status"][rep_event].astype(np.uint32)
        else:
            uniq_rows = np.zeros(0, np.int64)
            tgt_inverse = np.zeros(0, np.int64)
            uniq_status = np.zeros(0, np.uint32)
        p_tgt = np.full(n, -1, np.int32)
        p_tgt[p_found] = tgt_inverse.astype(np.int32)
        dstat_init = np.zeros(B, np.uint32)
        dstat_init[: len(uniq_rows)] = uniq_status
        return dict(
            unique_ids=unique_ids, id_group=id_group, p_group=p_group, p_found=p_found,
            gather_e=gather_e, gather_p=gather_p, uniq_rows=uniq_rows,
            uniq_status=uniq_status, p_tgt=p_tgt, dstat_init=dstat_init,
        )

    def _build_scan_events(self, n, B, events, flags, static, amount_lo, amount_hi,
                           pend_lo, pend_hi, timeout, ledger, code, dr_slot, cr_slot,
                           dr_flags, cr_flags, dr_zero, cr_zero, e_found, j) -> dict:
        """The (B,)-padded event columns per kernel.EVENT_FIELDS
        (reference: tpu.py:2817)."""
        ge, gp = j["gather_e"], j["gather_p"]
        ev = {
            "i": np.arange(B, dtype=np.int32),
            "flags": flags,
            "ts_nonzero": events["timestamp"] != 0,
            "static_result": static,
            "amount_lo": amount_lo, "amount_hi": amount_hi,
            "pending_lo": pend_lo, "pending_hi": pend_hi,
            "ud128_lo": events["user_data_128_lo"], "ud128_hi": events["user_data_128_hi"],
            "ud64": events["user_data_64"], "ud32": events["user_data_32"],
            "timeout": timeout, "ledger": ledger, "code": code,
            "dr_slot": dr_slot, "cr_slot": cr_slot,
            "dr_flags": dr_flags, "cr_flags": cr_flags,
            "dr_id_zero": dr_zero, "cr_id_zero": cr_zero,
            "id_group": j["id_group"], "p_group": j["p_group"],
            "e_found": e_found, "p_found": j["p_found"], "p_tgt": j["p_tgt"],
        }
        for pre, g in (("e", ge), ("p", gp)):
            for f in _JOIN_FIELDS:
                if f != "status":
                    ev[f"{pre}_{f}"] = g[f]
        dtypes = dict(kernel.EVENT_FIELDS)
        return {name: _pad(np.asarray(ev[name]).astype(dtypes[name]), B)
                for name in dtypes}

    # ------------------------------------------------------------------
    # The native lanes' tails and the Python resolvers (reference:
    # tpu.py:3046-3530).

    def _try_native_two_phase(self, input_bytes, events, n, ts_base) -> bytes | None:
        """Two-phase batch via the native serial resolver
        (csrc/host/tb_two_phase.inc).  Python gathers the durable pending
        targets' columns and finishes the store and expiry bookkeeping;
        the resolver owns decode, ladders, reference resolution and the
        balance effects."""
        flags16 = np.asarray(events["flags"])
        pv_mask = (flags16 & np.uint16(TF.post_pending_transfer | TF.void_pending_transfer)) != 0
        if not pv_mask.any():
            return None
        # Cheap shape gate before the durable join (the resolver would
        # refuse these too, after the join).
        if (flags16 & np.uint16(TF.linked)).any():
            return None
        pv_idx = np.flatnonzero(pv_mask)
        found, rows = self._tdir.lookup(
            np.asarray(events["pending_id_lo"])[pv_idx], np.asarray(events["pending_id_hi"])[pv_idx]
        )
        join = None
        if found.any():
            hit = pv_idx[found]
            hit_rows = rows[found].astype(np.int64)
            fields = (
                ("flags", np.uint32), ("dr_slot", np.int32), ("cr_slot", np.int32),
                ("amount_lo", np.uint64), ("amount_hi", np.uint64), ("ledger", np.uint32),
                ("code", np.uint32), ("ud128_lo", np.uint64), ("ud128_hi", np.uint64),
                ("ud64", np.uint64), ("ud32", np.uint32), ("timeout", np.uint32),
                ("status", np.uint32),
            )
            got = self._store.gather_many([f for f, _ in fields], hit_rows)
            join = {"row": np.full(n, -1, np.int64)}
            join["row"][hit] = hit_rows
            for f, dt in fields:
                arr = np.zeros(n, dt)
                arr[hit] = got[f].astype(dt)
                join[f] = arr
        r = self._native.commit_two_phase(input_bytes, n, ts_base, join)
        if r is None:
            return None
        self._dev.enqueue(*[d.copy() for d in r["deltas"]])
        # Durable finalizations: status bytes (the resolver takes only
        # timeout-free targets, so no expiry entry to deactivate).
        if len(r["dur_rows"]):
            self._store["status"][r["dur_rows"].copy()] = r["dur_status"].astype(np.uint8)
        flags = flags16.astype(np.uint32)
        timeout = np.asarray(events["timeout"]).astype(np.uint64)
        created = {
            "flags": flags,
            "dr_slot": r["row_dr"], "cr_slot": r["row_cr"],
            "amount_lo": r["amt_lo"], "amount_hi": r["amt_hi"],
            "pending_lo": np.asarray(events["pending_id_lo"]),
            "pending_hi": np.asarray(events["pending_id_hi"]),
            "ud128_lo": r["ud128_lo"], "ud128_hi": r["ud128_hi"],
            "ud64": r["ud64"], "ud32": r["ud32"],
            "timeout": timeout,
            "ledger": r["ledger"], "code": r["code"],
        }
        return self._finish_fast(
            n, ts_base, np.asarray(events["id_lo"]), np.asarray(events["id_hi"]), flags,
            timeout, r["results"], created, last_applied=r["last_applied"],
            inb_status=r["inb_status"],
        )

    def _finish_native_fast(self, events, n, ts_base, results, dr_slot, cr_slot, deltas,
                            last_applied: int | None = None) -> bytes:
        """Bookkeeping after a native order-free or linked apply: the
        write-behind enqueue, the store, expiry and pulses, the reply.
        `results` and the slots are views into the library's reusable
        buffers, consumed before its next call."""
        # Copies: the lane holds the deltas past this call.
        self._dev.enqueue(*[d.copy() for d in deltas])
        timeout = np.asarray(events["timeout"])
        if not (results != 0).any() and not timeout.any():
            # Hot tail: every event applied, no timeouts.  One C pass
            # decodes the wire records into the store's columns; the id
            # directories and commit_timestamp remain.
            self.stat_hot_tail_batches += 1
            st = self._store
            st._ensure(n)
            lo = st.count
            fastpath.decode_store(events, n, ts_base, st._cols, lo)
            st._cols["dr_slot"][lo : lo + n] = dr_slot
            st._cols["cr_slot"][lo : lo + n] = cr_slot
            st.count = lo + n
            id_lo = st._cols["id_lo"][lo : lo + n]
            id_hi = st._cols["id_hi"][lo : lo + n]
            self._tdir.insert(id_lo, id_hi, np.arange(lo, lo + n, dtype=np.uint64))
            self._native.add_transfer_ids(id_lo, id_hi, lo)
            self.commit_timestamp = ts_base + n - 1
            return b""
        self.stat_slow_tail_batches += 1
        flags = events["flags"].astype(np.uint32)
        timeout = timeout.astype(np.uint64)
        created = {
            "flags": flags,
            "dr_slot": dr_slot, "cr_slot": cr_slot,
            "amount_lo": np.asarray(events["amount_lo"]),
            "amount_hi": np.asarray(events["amount_hi"]),
            "pending_lo": np.asarray(events["pending_id_lo"]),
            "pending_hi": np.asarray(events["pending_id_hi"]),
            "ud128_lo": np.asarray(events["user_data_128_lo"]),
            "ud128_hi": np.asarray(events["user_data_128_hi"]),
            "ud64": np.asarray(events["user_data_64"]),
            "ud32": np.asarray(events["user_data_32"]),
            "timeout": timeout,
            "ledger": np.asarray(events["ledger"]),
            "code": events["code"].astype(np.uint32),
        }
        return self._finish_fast(
            n, ts_base, np.asarray(events["id_lo"]), np.asarray(events["id_hi"]), flags,
            timeout, results, created, last_applied=last_applied,
        )

    def _commit_linked_fast(
        self, n, ts_base, events, id_lo, id_hi, flags, timeout,
        dr_slot, cr_slot, amount_lo, amount_hi, ledger, code,
        static, dr_flags, cr_flags,
    ) -> bytes | None:
        """Linked-chain batch via the fixpoint resolver.  The router
        checked the preconditions (plain posted transfers, unique fresh
        ids, no history accounts); the superset admission below proves no
        overflow code can fire for any subset of the batch (the deltas
        are non-negative), which leaves the limit checks that
        linked_resolve models exactly."""
        ts_nonzero = np.asarray(events["timestamp"] != 0)
        # Every event that could apply (static failures, account not
        # found included, never touch balances, so these slots are valid).
        may_apply = (static == 0) & ~ts_nonzero
        if may_apply.any() and self._mirror.try_apply_adds(
            dr_slot.astype(np.int64), cr_slot.astype(np.int64),
            amount_lo, amount_hi, np.zeros(n, bool), may_apply, commit=False,
        ) is None:
            return None
        r = resolve.linked_resolve(
            static, ts_nonzero, flags, dr_slot, cr_slot,
            amount_lo, amount_hi, dr_flags, cr_flags, self._mirror,
        )
        if r is None:
            return None
        results, last_applied, iters = r
        self.stat_resolve_iters += iters
        deltas = self._mirror.try_apply_adds(
            dr_slot.astype(np.int64), cr_slot.astype(np.int64),
            amount_lo, amount_hi, np.zeros(n, bool), results == 0,
        )
        assert deltas is not None  # a subset of the admitted superset
        self._dev.enqueue(*deltas, refresh_twin=False)
        created = {
            "flags": flags,
            "dr_slot": dr_slot.astype(np.int32),
            "cr_slot": cr_slot.astype(np.int32),
            "amount_lo": amount_lo, "amount_hi": amount_hi,
            "pending_lo": np.zeros(n, np.uint64),
            "pending_hi": np.zeros(n, np.uint64),
            "ud128_lo": np.asarray(events["user_data_128_lo"]),
            "ud128_hi": np.asarray(events["user_data_128_hi"]),
            "ud64": np.asarray(events["user_data_64"]),
            "ud32": np.asarray(events["user_data_32"]),
            "timeout": timeout,
            "ledger": ledger, "code": code,
        }
        return self._finish_fast(
            n, ts_base, id_lo, id_hi, flags, timeout, results, created,
            last_applied=last_applied,
        )

    def _try_two_phase_fast(
        self, n, ts_base, events, id_lo, id_hi, pend_lo, pend_hi, flags,
        timeout, dr_slot, cr_slot, amount_lo, amount_hi, code,
        static, is_pv, dr_flags, cr_flags, j,
    ) -> bytes | None:
        """Two-phase batch via the closed-form resolver.  Beyond the
        router's unique fresh ids: no linked or balancing flags, zero
        timeouts (the events' and the durable targets'), no limit or
        history account anywhere (the durable targets' accounts too), and
        in-batch references that point at pending creates.  Anything else
        returns None and takes the exact path.  `j`: the exact joins."""
        if (flags & np.uint32(TF.linked | TF.balancing_debit | TF.balancing_credit)).any():
            return None
        if timeout.any():
            return None
        if ((dr_flags | cr_flags) & _LIMH).any():
            return None
        attrs = self._attrs
        gather_p, p_found, p_tgt = j["gather_p"], j["p_found"], j["p_tgt"]
        uniq_status = j["uniq_status"]
        if p_found.any():
            if (gather_p["timeout"] != 0).any():
                return None
            pj_dr = np.clip(gather_p["dr_slot"].astype(np.int64), 0, None)
            pj_cr = np.clip(gather_p["cr_slot"].astype(np.int64), 0, None)
            pj_flags = np.where(
                p_found, attrs["flags"][pj_dr] | attrs["flags"][pj_cr], 0
            ).astype(np.uint32)
            if (pj_flags & _LIMH).any():
                return None

        # In-batch references: the creator event of each distinct id (ids
        # are unique, so a permutation).
        creator = np.empty(len(j["unique_ids"]), np.int64)
        creator[j["id_group"]] = np.arange(n)
        p_group = j["p_group"]
        tgt_ev = np.where(p_group >= 0, creator[np.clip(p_group, 0, None)], -1)
        ib = is_pv & (tgt_ev >= 0) & (tgt_ev < np.arange(n))
        if (ib & ((flags[np.clip(tgt_ev, 0, None)] & np.uint32(TF.pending)) == 0)).any():
            # A reference to a non-pending in-batch row couples the pv
            # verdicts to each other: the exact engine decides.
            return None

        ts_nonzero = np.asarray(events["timestamp"] != 0)
        p_join = {
            f: gather_p[f]
            for f in ("flags", "dr_slot", "cr_slot", "amount_lo", "amount_hi", "ledger",
                      "code", "ud128_lo", "ud128_hi", "ud64", "ud32")
        }
        ud128_lo = np.asarray(events["user_data_128_lo"])
        ud128_hi = np.asarray(events["user_data_128_hi"])
        ud64 = np.asarray(events["user_data_64"])
        ud32 = np.asarray(events["user_data_32"]).astype(np.uint32)
        r = resolve.two_phase_resolve(
            static, ts_nonzero, flags, is_pv,
            np.asarray(events["debit_account_id_lo"]),
            np.asarray(events["debit_account_id_hi"]),
            np.asarray(events["credit_account_id_lo"]),
            np.asarray(events["credit_account_id_hi"]),
            amount_lo, amount_hi, ud128_lo, ud128_hi, ud64, ud32,
            np.asarray(events["ledger"]), code,
            tgt_ev, p_found, p_tgt, p_join, uniq_status, attrs,
        )
        if r is None:
            return None

        results = r["results"]
        ok = r["ok"]
        winner = r["winner"]
        post = r["post"]
        pend_flag = r["pend_flag"]
        tgt_c = np.clip(tgt_ev, 0, None)
        in_batch = r["in_batch"]
        # Target slots: the in-batch event's columns or the durable join.
        p_drs = np.where(in_batch, dr_slot[tgt_c].astype(np.int64),
                         np.clip(p_join["dr_slot"].astype(np.int64), 0, None))
        p_crs = np.where(in_batch, cr_slot[tgt_c].astype(np.int64),
                         np.clip(p_join["cr_slot"].astype(np.int64), 0, None))

        # Balance deltas: the adds are admission-checked together; a
        # pending's release cannot underflow (its amount is inside dp/cp).
        pend_ok = ok & pend_flag
        plain_ok = ok & ~pend_flag & ~is_pv
        post_win = winner & post
        add_slots = np.concatenate([
            dr_slot[pend_ok].astype(np.int64), cr_slot[pend_ok].astype(np.int64),
            dr_slot[plain_ok].astype(np.int64), cr_slot[plain_ok].astype(np.int64),
            p_drs[post_win], p_crs[post_win],
        ])
        n_pend = int(pend_ok.sum())
        n_plain = int(plain_ok.sum())
        n_post = int(post_win.sum())
        add_cols = np.concatenate([
            np.zeros(n_pend, np.int64), np.full(n_pend, 2, np.int64),
            np.ones(n_plain, np.int64), np.full(n_plain, 3, np.int64),
            np.ones(n_post, np.int64), np.full(n_post, 3, np.int64),
        ])
        add_lo = np.concatenate([
            amount_lo[pend_ok], amount_lo[pend_ok], amount_lo[plain_ok], amount_lo[plain_ok],
            r["res_amt_lo"][post_win], r["res_amt_lo"][post_win],
        ])
        add_hi = np.concatenate([
            amount_hi[pend_ok], amount_hi[pend_ok], amount_hi[plain_ok], amount_hi[plain_ok],
            r["res_amt_hi"][post_win], r["res_amt_hi"][post_win],
        ])
        deltas = self._mirror.try_apply_deltas(add_slots, add_cols, add_lo, add_hi)
        if deltas is None:
            return None  # overflow codes in play: the exact engine decides
        n_win = int(winner.sum())
        if n_win:
            sub_slots = np.concatenate([p_drs[winner], p_crs[winner]])
            sub_cols = np.concatenate([np.zeros(n_win, np.int64), np.full(n_win, 2, np.int64)])
            sub_lo = np.concatenate([r["p_amt_lo"][winner]] * 2)
            sub_hi = np.concatenate([r["p_amt_hi"][winner]] * 2)
            self._mirror.apply_subs(sub_slots, sub_cols, sub_lo, sub_hi)
            zero = np.zeros(2 * n_win, np.uint64)
            neg_lo, neg_hi, _ = _sub_u128(zero, zero, sub_lo, sub_hi)
            self._dev.enqueue(
                np.concatenate([deltas[0], sub_slots]), np.concatenate([deltas[1], sub_cols]),
                np.concatenate([deltas[2], neg_lo]), np.concatenate([deltas[3], neg_hi]),
                refresh_twin=False,
            )
        else:
            self._dev.enqueue(*deltas, refresh_twin=False)

        # Durable store rows: zero means inherit for created pv rows
        # (reference: src/state_machine.zig:1697-1720).
        ud128_set = (ud128_lo != 0) | (ud128_hi != 0)
        created = {
            "flags": flags,
            "dr_slot": np.where(is_pv, p_drs, dr_slot.astype(np.int64)).astype(np.int32),
            "cr_slot": np.where(is_pv, p_crs, cr_slot.astype(np.int64)).astype(np.int32),
            "amount_lo": np.where(is_pv, r["res_amt_lo"], amount_lo),
            "amount_hi": np.where(is_pv, r["res_amt_hi"], amount_hi),
            "pending_lo": pend_lo, "pending_hi": pend_hi,
            "ud128_lo": np.where(is_pv & ~ud128_set, r["p_ud128_lo"], ud128_lo),
            "ud128_hi": np.where(is_pv & ~ud128_set, r["p_ud128_hi"], ud128_hi),
            "ud64": np.where(is_pv & (ud64 == 0), r["p_ud64"], ud64),
            "ud32": np.where(is_pv & (ud32 == 0), r["p_ud32"], ud32),
            "timeout": np.zeros(n, np.uint64),
            "ledger": np.where(is_pv, r["p_ledger"], np.asarray(events["ledger"])).astype(np.uint32),
            "code": np.where(is_pv, r["p_code"], code).astype(np.uint32),
        }
        inb_status = np.where(pend_ok, np.uint32(kernel.S_PENDING), np.uint32(0))
        ib_win = winner & in_batch
        if ib_win.any():
            inb_status[tgt_ev[ib_win]] = np.where(
                post[ib_win], np.uint32(kernel.S_POSTED), np.uint32(kernel.S_VOIDED)
            )
        dstat = uniq_status.copy()
        dur_win = winner & r["durable"]
        if dur_win.any():
            dstat[p_tgt[dur_win]] = np.where(
                post[dur_win], np.uint32(kernel.S_POSTED), np.uint32(kernel.S_VOIDED)
            )
        zeros_u64 = np.zeros(n, np.uint64)
        self._post_process_transfers(
            n, ts_base, id_lo, id_hi, flags, timeout, results, ok, created, inb_status,
            uniq_status, dstat, j["uniq_rows"], None, None,
            r["last_applied"], zeros_u64, zeros_u64, no_history=True,
        )
        fail_idx = np.flatnonzero(results != 0)
        reply = np.zeros(len(fail_idx), dtype=CREATE_RESULT_DTYPE)
        reply["index"] = fail_idx.astype(np.uint32)
        reply["result"] = results[fail_idx]
        return reply.tobytes()

    def _commit_fast(
        self, n, ts_base, events, id_lo, id_hi, pend_lo, pend_hi,
        flags, timeout, dr_slot, cr_slot, amount_lo, amount_hi, ledger, code,
        static,
    ) -> bytes | None:
        """Parallel apply for order-independent batches; None when a
        balance overflow is possible (only the exact sequential path
        ranks the overflow codes — reference:
        src/state_machine.zig:1531-1545)."""
        # timestamp_must_be_zero precedes the static ladder (reference:
        # src/state_machine.zig:1251-1256).
        results = np.where(
            events["timestamp"] != 0, np.uint32(CTR.timestamp_must_be_zero), static
        )
        ts_i = np.uint64(ts_base) + np.arange(n, dtype=np.uint64)
        expires = ts_i + timeout * np.uint64(NS_PER_S)
        if (expires < ts_i).any():
            return None  # overflows_timeout ranks below the overflow codes
        apply_mask = results == 0
        is_pending = (flags & np.uint32(TF.pending)) != 0
        deltas = self._mirror.try_apply_adds(
            dr_slot.astype(np.int64), cr_slot.astype(np.int64),
            amount_lo, amount_hi, is_pending, apply_mask,
        )
        if deltas is None:
            return None
        self._dev.enqueue(*deltas, refresh_twin=False)
        created = {
            "flags": flags,
            "dr_slot": dr_slot.astype(np.int32),
            "cr_slot": cr_slot.astype(np.int32),
            "amount_lo": amount_lo, "amount_hi": amount_hi,
            "pending_lo": pend_lo, "pending_hi": pend_hi,
            "ud128_lo": np.asarray(events["user_data_128_lo"]),
            "ud128_hi": np.asarray(events["user_data_128_hi"]),
            "ud64": np.asarray(events["user_data_64"]),
            "ud32": np.asarray(events["user_data_32"]),
            "timeout": timeout,
            "ledger": ledger, "code": code,
        }
        return self._finish_fast(n, ts_base, id_lo, id_hi, flags, timeout, results, created)

    def _finish_fast(self, n, ts_base, id_lo, id_hi, flags, timeout, results, created,
                     last_applied: int | None = None,
                     inb_status: np.ndarray | None = None) -> bytes:
        """Shared fast-path tail of the native and Python lanes: pulse
        signals, store bookkeeping and the failure reply (reference:
        tpu.py:3532).  `inb_status` overrides the created pendings'
        statuses when the caller finalized pendings within the batch
        (the native two-phase resolver)."""
        apply_mask = results == 0
        is_pending = (flags & np.uint32(TF.pending)) != 0
        ts_i = np.uint64(ts_base) + np.arange(n, dtype=np.uint64)
        expires = ts_i + timeout * np.uint64(NS_PER_S)
        if inb_status is None:
            inb_status = np.where(
                apply_mask & is_pending, np.uint32(kernel.S_PENDING), np.uint32(0)
            )
        if last_applied is None:
            applied_idx = np.flatnonzero(apply_mask)
            last_applied = int(applied_idx[-1]) if len(applied_idx) else -1
        pulse_create = np.where(
            apply_mask & is_pending & (timeout > 0), expires, np.uint64(0)
        )
        self._post_process_transfers(
            n, ts_base, id_lo, id_hi, flags, timeout, results, apply_mask,
            created, inb_status, np.zeros(0, np.uint32), np.zeros(0, np.uint32),
            np.zeros(0, np.int64), None, None, last_applied, pulse_create,
            np.zeros(n, np.uint64), no_history=True,
        )
        fail_idx = np.flatnonzero(results != 0)
        reply = np.zeros(len(fail_idx), dtype=CREATE_RESULT_DTYPE)
        reply["index"] = fail_idx.astype(np.uint32)
        reply["result"] = results[fail_idx]
        return reply.tobytes()

    def _post_process_transfers(
        self, n, ts_base, id_lo, id_hi, flags, timeout,
        results, created_mask, created, inb_status,
        dstat_init, dstat, uniq_rows,
        hist_dr, hist_cr, last_applied, pulse_create, pulse_remove,
        no_history: bool = False,
    ) -> None:
        """Durable effects of a resolved batch (reference: tpu.py:3576):
        the created transfers into the store and id directory, durable
        pending-status updates, the expires index, pulse_next_timestamp,
        history rows (no_history: the caller proved no history account
        is touched), and commit_timestamp."""
        ok = results == 0
        # 1. Created transfers into the columnar store.
        cm_ = created_mask
        row_of_event = np.full(n, -1, np.int64)
        if cm_.any():
            idx = np.arange(n) if cm_.all() else np.flatnonzero(cm_)
            ts = np.uint64(ts_base) + idx.astype(np.uint64)
            rows = self._store.append(
                id_lo=id_lo[idx], id_hi=id_hi[idx],
                dr_slot=created["dr_slot"][idx], cr_slot=created["cr_slot"][idx],
                amount_lo=created["amount_lo"][idx], amount_hi=created["amount_hi"][idx],
                pending_lo=created["pending_lo"][idx], pending_hi=created["pending_hi"][idx],
                ud128_lo=created["ud128_lo"][idx], ud128_hi=created["ud128_hi"][idx],
                ud64=created["ud64"][idx], ud32=created["ud32"][idx],
                timeout=created["timeout"][idx].astype(np.uint32, copy=False),
                ledger=created["ledger"][idx], code=created["code"][idx],
                flags=flags[idx], timestamp=ts,
                status=inb_status[idx].astype(np.uint8),
            )
            self._tdir.insert(id_lo[idx], id_hi[idx], rows.astype(np.uint64))
            if self._native is not None:
                # The native duplicate-id set in lockstep (rows are
                # contiguous: base_row + i == row).
                self._native.add_transfer_ids(id_lo[idx], id_hi[idx], int(rows[0]))
            row_of_event[idx] = rows

        # 2. Durable pending-status updates (+ expires index removal).
        k = len(uniq_rows)
        changed = np.flatnonzero(dstat[:k] != dstat_init[:k])
        if len(changed):
            ch_rows = uniq_rows[changed]
            self._store["status"][ch_rows] = dstat[changed].astype(np.uint8)
            timed = ch_rows[self._store["timeout"][ch_rows] > 0]
            self._exp_deactivate(timed)

        # 3. Expires entries for in-batch creations still pending.
        pend_created = np.flatnonzero(
            cm_ & (inb_status == kernel.S_PENDING) & (timeout > 0)
        )
        if len(pend_created):
            self._exp.append(
                expires_at=(
                    np.uint64(ts_base) + pend_created.astype(np.uint64)
                    + timeout[pend_created] * np.uint64(NS_PER_S)
                ),
                row=row_of_event[pend_created].astype(np.uint32),
                active=np.ones(len(pend_created), bool),
            )

        # 4. pulse_next_timestamp from the apply-time signals, recorded
        # before any rollback (reference: src/state_machine.zig:
        # 1576-1580,1704-1708).
        for i in np.flatnonzero((pulse_create != 0) | (pulse_remove != 0)):
            create_at = int(pulse_create[i])
            remove_at = int(pulse_remove[i])
            if create_at and create_at < self.pulse_next_timestamp:
                self.pulse_next_timestamp = create_at
            if remove_at and self.pulse_next_timestamp == remove_at:
                self.pulse_next_timestamp = TIMESTAMP_MIN

        # 5. Historical balances of applied events on history accounts.
        applied = cm_ & ok
        if not no_history and applied.any():
            idx = np.flatnonzero(applied)
            drs = created["dr_slot"][idx]
            crs = created["cr_slot"][idx]
            dr_hist = (self._attrs["flags"][drs] & AF.history) != 0
            cr_hist = (self._attrs["flags"][crs] & AF.history) != 0
            want = dr_hist | cr_hist
            if want.any():
                sel = idx[want]
                drs, crs = drs[want], crs[want]
                dr_hist, cr_hist = dr_hist[want], cr_hist[want]
                zero8 = np.zeros((len(sel), 8), np.uint64)
                self._history.append(
                    timestamp=np.uint64(ts_base) + sel.astype(np.uint64),
                    dr_id_lo=np.where(dr_hist, self._attrs["id_lo"][drs], 0),
                    dr_id_hi=np.where(dr_hist, self._attrs["id_hi"][drs], 0),
                    cr_id_lo=np.where(cr_hist, self._attrs["id_lo"][crs], 0),
                    cr_id_hi=np.where(cr_hist, self._attrs["id_hi"][crs], 0),
                    dr_bal=np.where(dr_hist[:, None], hist_dr[sel], zero8),
                    cr_bal=np.where(cr_hist[:, None], hist_cr[sel], zero8),
                )

        # 6. commit_timestamp advances to the last event that reached the
        # apply point, chain events later rolled back included
        # (reference: src/state_machine.zig:1583).
        if last_applied >= 0:
            self.commit_timestamp = ts_base + last_applied

    # ------------------------------------------------------------------
    # Expiry pulse (reference: tpu.py:3697-3774).

    def _exp_deactivate(self, rows: np.ndarray) -> None:
        """Deactivate the expires entries of store `rows`; compact once
        tombstones dominate, keeping scans O(live)."""
        if len(rows) == 0:
            return
        active = self._exp.col("active")
        matches = np.flatnonzero(np.isin(self._exp.col("row"), rows) & active)
        self._exp["active"][matches] = False
        self._exp_dead += len(matches)
        if self._exp_dead * 2 > self._exp.count and self._exp.count > 64:
            live = np.flatnonzero(self._exp.col("active"))
            cols = {
                name: self._exp.col(name)[live].copy()
                for name in ("expires_at", "row", "active")
            }
            self._exp.truncate(0)
            self._exp.append(**cols)
            self._exp_dead = 0

    def _scan_expired(self, expires_at_max: int) -> np.ndarray:
        """Store rows of the live pendings due at `expires_at_max`, in
        (expires_at, timestamp) order, at most one batch of them, and the
        next pulse's timestamp."""
        limit = self.config.batch_max_create_transfers
        exp_at = self._exp.col("expires_at")
        rows = self._exp.col("row")
        live = np.flatnonzero(self._exp.col("active"))
        if len(live) == 0:
            self.pulse_next_timestamp = TIMESTAMP_MAX
            return np.zeros(0, np.int64)
        ts = self._store["timestamp"][rows[live]]
        order = np.lexsort((ts, exp_at[live]))
        ordered = live[order]
        ordered_exp = exp_at[live][order]
        due_idx = np.flatnonzero(ordered_exp <= expires_at_max)
        if len(due_idx) > limit:
            taken = ordered[due_idx[:limit]]
            # The next pulse rescans from the overflow point (reference:
            # src/state_machine.zig:2136-2140).
            self.pulse_next_timestamp = int(ordered_exp[due_idx[limit]])
        elif len(due_idx) == len(ordered_exp):
            taken = ordered[due_idx]
            self.pulse_next_timestamp = TIMESTAMP_MAX
        else:
            taken = ordered[due_idx]
            self.pulse_next_timestamp = int(ordered_exp[len(due_idx)])
        return rows[taken].astype(np.int64)

    def _commit_expire(self, timestamp: int) -> bytes:
        """Expire the pendings the pulse's prefetch found: release their
        amounts (dp -= amount on the debit side, cp -= amount on the
        credit side; reference: src/state_machine.zig:1874-1929) on the
        mirror exactly and on the device as two's-complement deltas
        through the write-behind lane (K4)."""
        assert self._expiry_rows is not None
        rows, self._expiry_rows = self._expiry_rows, None
        if len(rows) == 0:
            return b""
        st = self._store
        slots = np.concatenate([st["dr_slot"][rows], st["cr_slot"][rows]]).astype(np.int64)
        cols = np.concatenate(
            [np.zeros(len(rows), np.int64), np.full(len(rows), 2, np.int64)]
        )
        amt_lo = np.concatenate([st["amount_lo"][rows]] * 2)
        amt_hi = np.concatenate([st["amount_hi"][rows]] * 2)
        self._mirror.apply_subs(slots, cols, amt_lo, amt_hi)
        zero = np.zeros(len(slots), np.uint64)
        neg_lo, neg_hi, _ = _sub_u128(zero, zero, amt_lo, amt_hi)
        self._dev.enqueue(slots, cols, neg_lo, neg_hi, refresh_twin=False)
        st["status"][rows] = np.uint8(TransferPendingStatus.expired)
        self._exp_deactivate(rows)
        return b""

    # ------------------------------------------------------------------
    # Lookups.

    def _account_rows(self, slots: np.ndarray, balances: np.ndarray) -> bytes:
        out = np.zeros(len(slots), dtype=ACCOUNT_DTYPE)
        a = self._attrs
        out["id_lo"], out["id_hi"] = a["id_lo"][slots], a["id_hi"][slots]
        out["debits_pending_lo"], out["debits_pending_hi"] = balances[:, 0], balances[:, 1]
        out["debits_posted_lo"], out["debits_posted_hi"] = balances[:, 2], balances[:, 3]
        out["credits_pending_lo"], out["credits_pending_hi"] = balances[:, 4], balances[:, 5]
        out["credits_posted_lo"], out["credits_posted_hi"] = balances[:, 6], balances[:, 7]
        out["user_data_128_lo"] = a["ud128_lo"][slots]
        out["user_data_128_hi"] = a["ud128_hi"][slots]
        out["user_data_64"] = a["ud64"][slots]
        out["user_data_32"] = a["ud32"][slots]
        out["ledger"] = a["ledger"][slots]
        out["code"] = a["code"][slots]
        out["flags"] = a["flags"][slots]
        out["timestamp"] = a["timestamp"][slots]
        return out.tobytes()

    def _lookup_accounts(self, input_bytes: bytes) -> bytes:
        ids = np.frombuffer(input_bytes, dtype=types.U128_PAIR_DTYPE)
        found, slots = self._acct_dir.lookup(
            ids["lo"].astype(np.uint64), ids["hi"].astype(np.uint64)
        )
        hit = np.flatnonzero(found)
        if len(hit) == 0:
            return b""
        slots = slots[hit].astype(np.int64)
        return self._account_rows(slots, self._mirror.rows8(slots))

    def _transfer_rows_to_np(self, rows: np.ndarray) -> np.ndarray:
        rows = np.asarray(rows, np.int64)
        out = np.zeros(len(rows), dtype=TRANSFER_DTYPE)
        if len(rows) == 0:
            return out
        cols = self._store.gather_many(
            [
                "id_lo", "id_hi", "dr_slot", "cr_slot", "amount_lo",
                "amount_hi", "pending_lo", "pending_hi", "ud128_lo",
                "ud128_hi", "ud64", "ud32", "timeout", "ledger", "code",
                "flags", "timestamp",
            ],
            rows,
        )
        out["id_lo"], out["id_hi"] = cols["id_lo"], cols["id_hi"]
        dr = cols["dr_slot"].astype(np.int64)
        cr = cols["cr_slot"].astype(np.int64)
        out["debit_account_id_lo"] = self._attrs["id_lo"][dr]
        out["debit_account_id_hi"] = self._attrs["id_hi"][dr]
        out["credit_account_id_lo"] = self._attrs["id_lo"][cr]
        out["credit_account_id_hi"] = self._attrs["id_hi"][cr]
        out["amount_lo"], out["amount_hi"] = cols["amount_lo"], cols["amount_hi"]
        out["pending_id_lo"], out["pending_id_hi"] = cols["pending_lo"], cols["pending_hi"]
        out["user_data_128_lo"] = cols["ud128_lo"]
        out["user_data_128_hi"] = cols["ud128_hi"]
        out["user_data_64"] = cols["ud64"]
        out["user_data_32"] = cols["ud32"]
        out["timeout"] = cols["timeout"]
        out["ledger"] = cols["ledger"]
        out["code"] = cols["code"]
        out["flags"] = cols["flags"]
        out["timestamp"] = cols["timestamp"]
        return out

    def _lookup_transfers(self, input_bytes: bytes) -> bytes:
        ids = np.frombuffer(input_bytes, dtype=types.U128_PAIR_DTYPE)
        found, rows = self._tdir.lookup(
            ids["lo"].astype(np.uint64), ids["hi"].astype(np.uint64)
        )
        return self._transfer_rows_to_np(rows[found].astype(np.int64)).tobytes()

    # ------------------------------------------------------------------
    # Queries (reference: tpu.py:3849-3985; src/state_machine.zig:931-996
    # for the filter, :1806-1841 for historical balances).

    def _parse_filter(self, input_bytes: bytes):
        return np.frombuffer(input_bytes, dtype=ACCOUNT_FILTER_DTYPE)[0]

    def _filter_rows(self, filter_row) -> np.ndarray | None:
        """Validated filter -> matching store rows in timestamp order
        (None for an invalid filter)."""
        account_id = types.u128_get(filter_row, "account_id")
        ts_min = int(filter_row["timestamp_min"])
        ts_max = int(filter_row["timestamp_max"])
        limit = int(filter_row["limit"])
        fflags = int(filter_row["flags"])
        FF = AccountFilterFlags
        valid = (
            account_id != 0
            and account_id != U128_MAX
            and ts_min != U64_MAX
            and ts_max != U64_MAX
            and (ts_max == 0 or ts_min <= ts_max)
            and limit != 0
            and (fflags & (FF.debits | FF.credits))
            and not (fflags & ~int(FF._valid_mask))
            and bytes(filter_row["reserved"]) == b"\x00" * 24
        )
        if not valid:
            return None
        slot = self._account_slot(account_id)
        if slot is None:
            return np.zeros(0, np.int64)
        st = self._store
        lo = TIMESTAMP_MIN if ts_min == 0 else ts_min
        hi = TIMESTAMP_MAX if ts_max == 0 else ts_max
        # The reference first composes its spilled rows through the LSM
        # ScanBuilder here (eq / union over the (slot, timestamp) index
        # trees); the TailStore keeps every row in RAM, so that branch
        # waits for the LSM tier (ROADMAP queue 1, item 5).
        mask = np.zeros(st.count, bool)
        if fflags & FF.debits:
            mask |= st.col("dr_slot") == slot
        if fflags & FF.credits:
            mask |= st.col("cr_slot") == slot
        ts = st.col("timestamp")
        mask &= (ts >= lo) & (ts <= hi)
        rows = np.flatnonzero(mask)
        if fflags & FF.reversed:
            rows = rows[::-1]
        return rows

    def _get_account_transfers(self, input_bytes: bytes) -> bytes:
        filter_row = self._parse_filter(input_bytes)
        rows = self._filter_rows(filter_row)
        if rows is None:
            return b""
        batch_max = self.config.batch_max(ACCOUNT_FILTER_DTYPE.itemsize, TRANSFER_DTYPE.itemsize)
        rows = rows[: min(int(filter_row["limit"]), batch_max)]
        return self._transfer_rows_to_np(rows).tobytes()

    def _get_account_balances(self, input_bytes: bytes) -> bytes:
        filter_row = self._parse_filter(input_bytes)
        account_id = types.u128_get(filter_row, "account_id")
        slot = self._account_slot(account_id)
        if slot is None or not (int(self._attrs["flags"][slot]) & AF.history):
            return b""
        rows = self._filter_rows(filter_row)
        if rows is None:
            return b""
        batch_max = self.config.batch_max(
            ACCOUNT_FILTER_DTYPE.itemsize, ACCOUNT_BALANCE_DTYPE.itemsize
        )
        rows = rows[: min(int(filter_row["limit"]), batch_max)]
        # Transfer timestamps -> history rows (the same timestamps; the
        # history rows are in store order too, all in RAM).
        want_ts = np.asarray(self._store["timestamp"][rows], np.uint64)
        h = self._history
        h_ts = h.col("timestamp")
        bal = np.zeros((len(rows), 8), np.uint64)
        if len(rows):
            assert len(h_ts), "history row missing"
            pos = np.minimum(np.searchsorted(h_ts, want_ts), len(h_ts) - 1)
            assert (h_ts[pos] == want_ts).all(), "history row missing"
            is_dr = (h["dr_id_lo"][pos] == np.uint64(account_id & U64_MAX)) & (
                h["dr_id_hi"][pos] == np.uint64(account_id >> 64)
            )
            bal[:] = np.where(is_dr[:, None], h["dr_bal"][pos], h["cr_bal"][pos])
        out = np.zeros(len(rows), dtype=ACCOUNT_BALANCE_DTYPE)
        out["debits_pending_lo"], out["debits_pending_hi"] = bal[:, 0], bal[:, 1]
        out["debits_posted_lo"], out["debits_posted_hi"] = bal[:, 2], bal[:, 3]
        out["credits_pending_lo"], out["credits_pending_hi"] = bal[:, 4], bal[:, 5]
        out["credits_posted_lo"], out["credits_posted_hi"] = bal[:, 6], bal[:, 7]
        out["timestamp"] = want_ts
        return out.tobytes()

    # ------------------------------------------------------------------
    # Introspection helpers shared with the reference's machines.

    def _transfer_row(self, id_value: int) -> int | None:
        found, row = self._tdir.lookup(
            np.array([id_value & U64_MAX], np.uint64), np.array([id_value >> 64], np.uint64)
        )
        return int(row[0]) if found[0] else None

    def transfer_timestamp(self, id_value: int) -> int | None:
        row = self._transfer_row(id_value)
        return None if row is None else int(self._store["timestamp"][row])

    def pending_status(self, id_value: int) -> TransferPendingStatus | None:
        row = self._transfer_row(id_value)
        if row is None:
            return None
        status = int(self._store["status"][row])
        return None if status == 0 else TransferPendingStatus(status)

    def account_balances_raw(self, id_value: int) -> tuple | None:
        """(debits_pending, debits_posted, credits_pending,
        credits_posted) without going through a commit (the engine
        drained: the mirror then holds every materialized batch)."""
        slot = self._account_slot(id_value)
        if slot is None:
            return None
        self._engine_drain()
        row = self._mirror.rows8(np.array([slot]))[0]
        u = lambda i: int(row[i]) | (int(row[i + 1]) << 64)  # noqa: E731
        return (u(0), u(2), u(4), u(6))

    # ------------------------------------------------------------------
    # Checkpoint snapshot / restore (reference: tpu.py:3989-4164), in the
    # reference's blob layout (utils/snapshot.py: fixed-layout, no
    # pickle).  The store has no spilled part here: store_base is 0.

    def snapshot(self) -> bytes:
        """Serialize the durable state: the columnar stores and the
        balance mirror, which equals the device table once the stream is
        drained and the write-behind lane flushed.  The checkpoint
        barrier runs the tripwire (verify_device_mirror) on the device
        engine, and on the host engine under TB_CKPT_VERIFY=1."""
        if self.engine == "device":
            self._dev.drain()
        self._dev.flush()
        if self.engine == "device" or envcheck.ckpt_verify():
            self.verify_device_mirror()
        count = self._attrs.count
        state = {
            "commit_timestamp": self.commit_timestamp,
            "pulse_next_timestamp": self.pulse_next_timestamp,
            "exp_dead": self._exp_dead,
            "store_base": 0,
            "attrs": {k: self._attrs.col(k) for k in _ATTR_FIELDS},
            "store": {k: self._store.col(k) for k in _STORE_FIELDS},
            "exp": {k: self._exp.col(k) for k in ("expires_at", "row", "active")},
            "history": {k: self._history.col(k) for k in _HISTORY_FIELDS},
            "mirror_lo": self._mirror.lo[:count],
            "mirror_hi": self._mirror.hi[:count],
        }
        return snapcodec.encode_tree(state)

    def restore(self, data: bytes) -> None:
        """Replace the whole state from a snapshot blob.  The id
        directories and the commitment twin are rebuilt from it; the
        device tables are re-uploaded from the restored mirror (device
        engine: both tables and the K2 rebuild, a lost link demoting
        it; host engine: write_back of the logical table), and a tiered
        table starts from an empty hot set that admissions refill."""
        state = snapcodec.decode_tree(data)
        if state.get("store_base", 0) or "forest" in state:
            raise ValueError("a snapshot with spilled rows needs the LSM tier, not ported")
        self.commit_timestamp = state["commit_timestamp"]
        self.pulse_next_timestamp = state["pulse_next_timestamp"]
        self._exp_dead = state["exp_dead"]
        self.prepare_timestamp = self.commit_timestamp

        self._attrs = Columns(_ATTR_FIELDS)
        self._attrs.append(**state["attrs"])
        self._store = TailStore(_STORE_FIELDS)
        self._store.append(**state["store"])
        self._exp = Columns({"expires_at": np.uint64, "row": np.uint32, "active": np.bool_})
        self._exp.append(**state["exp"])
        self._history = Columns(_HISTORY_FIELDS)
        self._history.append(**state["history"])

        n_acct = self._attrs.count
        self._acct_dir = RunIndex(_dir_capacity(n_acct))
        self._acct_dir.insert(
            self._attrs.col("id_lo"), self._attrs.col("id_hi"), np.arange(n_acct, dtype=np.uint64)
        )
        self._tdir = RunIndex(_dir_capacity(self._store.count))
        self._tdir.insert(
            self._store.col("id_lo"), self._store.col("id_hi"),
            np.arange(self._store.count, dtype=np.uint64),
        )

        cap = max(1 << 12, 1 << (n_acct - 1).bit_length() if n_acct else 1)
        self._mirror = BalanceMirror(cap)
        self._mirror.lo[:n_acct] = state["mirror_lo"]
        self._mirror.hi[:n_acct] = state["mirror_hi"]
        if self._native is not None:
            self._rebuild_native(cap)
        if self._commitment is not None:
            # A fresh twin over the restored mirror and attributes.
            self._commitment = cm.HostCommitment(cap, meta_fn=self._commit_meta_cols)
            self._commitment.rebuild(self._mirror)
            self._mirror.commitment = self._commitment
        if self.engine == "device":
            self._dev = DeviceEngine(
                cap, self._mirror, self.device, plain=self.plain, devices=self._devices,
                link=self._device_link,
            )
            self._dev.restore_tables(self._attrs.col("flags"), self._attrs.col("ledger"))
        else:
            self._dev = DeviceTable(cap, self.device, self._mirror, plain=self.plain,
                                    devices=self._devices)
            self._dev.write_back(from_u64(self._mirror.table8(cap), self.device))
        self._inflight_timeouts = False
        self._expiry_rows = None

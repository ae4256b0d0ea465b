"""GPU-backed state machine: host orchestration around the CUDA kernels.

Counterpart of ``tigerbeetle_tpu/state_machine/tpu.py:TpuStateMachine``
with the device-authoritative engine (``engine="device"``) only.  Same
external interface (``input_valid`` / ``prepare`` / ``pulse_needed`` /
``prefetch`` / ``commit`` / ``commit_async`` over wire bytes), so the
two are interchangeable under the test harness and diffable bit for
bit; method names follow the reference.

State split:
- DEVICE (DeviceEngine): the authoritative balance table (A, 8) and
  account-meta table (A, 2), the summary ring, and the state
  commitment.  Kernel K1 computes create_transfers result codes and
  applies balances; kernel K2 keeps the commitment current.
- HOST: id directories, immutable account attributes, the columnar
  transfer store, and the balance mirror (bookkeeping and recovery).

Slice scope: create_transfers batches of the order-free class run on
the device.  Every other class — linked chains, post/void, balancing,
limit or history accounts, timeouts, duplicate or already-existing ids,
more events than the device bucket — needs the exact sequential
residual, which is not ported: such a batch raises ResidualNotPorted
instead of being approximated.  So does a flagged batch whose exact
re-execution cannot rule out a balance overflow.
"""

from __future__ import annotations

import numpy as np

from tigerbeetle_tpu_torch import constants as cfg
from tigerbeetle_tpu_torch import envcheck, types
from tigerbeetle_tpu_torch.device import resolve_device
from tigerbeetle_tpu_torch.state_machine import commitment as cm
from tigerbeetle_tpu_torch.state_machine import device_kernels as dk
from tigerbeetle_tpu_torch.state_machine.device_engine import (
    DeviceEngine,
    ReplyFuture,
)
from tigerbeetle_tpu_torch.state_machine.mirror import BalanceMirror
from tigerbeetle_tpu_torch.types import (
    ACCOUNT_DTYPE,
    ACCOUNT_FILTER_DTYPE,
    CREATE_RESULT_DTYPE,
    NS_PER_S,
    TIMESTAMP_MAX,
    TIMESTAMP_MIN,
    TRANSFER_DTYPE,
    U64_MAX,
    U128_MAX,
    AccountFlags,
    CreateAccountResult,
    CreateTransferResult,
    Operation,
    TransferFlags,
)
from tigerbeetle_tpu_torch.utils import RunIndex

AF = AccountFlags
TF = TransferFlags
CAR = CreateAccountResult
CTR = CreateTransferResult

# Tight device-input gate: amounts must fit u32 (tests shrink this to
# force the wide format on the same stream).
_TIGHT_AMOUNT_LIMIT = 1 << 32

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

_ATTR_FIELDS = {
    "id_lo": np.uint64, "id_hi": np.uint64,
    "ud128_lo": np.uint64, "ud128_hi": np.uint64,
    "ud64": np.uint64, "ud32": np.uint32,
    "ledger": np.uint32, "code": np.uint32, "flags": np.uint32,
    "timestamp": np.uint64,
}

S_PENDING = 1  # TransferPendingStatus.pending


class ResidualNotPorted(NotImplementedError):
    """A create_transfers batch outside the order-free class: it needs
    the exact sequential residual (ROADMAP slice 2), which this port
    does not have yet."""

    def __init__(self, batch_class: str) -> None:
        self.batch_class = batch_class
        super().__init__(
            f"create_transfers batch of class {batch_class!r} needs the "
            "exact residual: ROADMAP slice 2"
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
        self._cols = {name: np.zeros(capacity, dt) for name, dt in fields.items()}

    def _ensure(self, extra: int) -> None:
        need = self.count + extra
        if need <= self._cap:
            return
        while self._cap < need:
            self._cap *= 4
        for name, col in self._cols.items():
            new = np.zeros(self._cap, col.dtype)
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


class TorchStateMachine:
    """Accounting state machine whose create_transfers codes are
    computed on the GPU by the device-authoritative engine."""

    def __init__(
        self,
        config: cfg.Config = cfg.PRODUCTION,
        account_capacity: int = 1 << 16,
        transfer_capacity: int = 1 << 16,
        device=None,
        plain: bool = False,
    ) -> None:
        """`device`: None = the first CUDA card (raises without one);
        "cpu" runs the kernels' plain PyTorch versions on the CPU.
        `plain` runs the plain versions on `device` (a reference run)."""
        self.config = config
        self.device = resolve_device(device)
        self.prepare_timestamp = 0
        self.commit_timestamp = 0
        self.pulse_next_timestamp = TIMESTAMP_MIN

        # Work-split counters (the reference's names).
        self.stat_device_events = 0
        self.stat_host_semantic_events = 0
        self.stat_fallback_events = 0

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
        self._dev = DeviceEngine(
            account_capacity, self._mirror, self.device, plain=plain
        )
        self._tdir = RunIndex(_dir_capacity(transfer_capacity))
        self._store = TailStore(_STORE_FIELDS, capacity=max(1024, transfer_capacity))
        self._expiry_rows: np.ndarray | None = None

    @property
    def stat_device_semantic_events(self) -> int:
        """Events whose result codes were computed on the device."""
        return self._dev.stat_semantic_events

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
        """Crash loudly unless the device tables equal the host copies.

        With the commitment live: the device's maintained digest, its
        from-scratch recompute (K2 probe), the host twin, and a
        from-scratch host digest of the mirror must all agree.
        Without it: the drained device tables are compared whole."""
        dev = self._dev
        dev.drain()
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
                and (pair[1] == twin).all()
                and (twin == host_scratch).all()
            ):
                return
            bal, meta, _, _ = dev.to_numpy_tables()
            rows = np.flatnonzero(
                (bal != self._mirror.table8(dev.capacity)).any(axis=1)
                | (meta != dev._meta_host).any(axis=1)
            )
            raise AssertionError(
                "device/mirror commitment divergence: "
                f"{len(rows)} rows diverged (first: {rows[:8].tolist()}); "
                f"device(maintained, scratch)={pair.tolist()} "
                f"twin={twin.tolist()} host_scratch={host_scratch.tolist()}"
            )
        bal, meta, _, _ = dev.to_numpy_tables()
        if not (
            (bal == self._mirror.table8(dev.capacity)).all()
            and (meta == dev._meta_host).all()
        ):
            raise AssertionError("device/mirror table divergence")

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
        return self.pulse_next_timestamp <= self.prepare_timestamp

    def prefetch(
        self, operation: Operation, input_bytes: bytes, prefetch_timestamp: int
    ) -> None:
        if operation == Operation.pulse:
            self._dev.drain()
            self._expiry_rows = self._scan_expired(prefetch_timestamp)

    def commit(self, client: int, op: int, timestamp: int,
               operation: Operation, input_bytes: bytes) -> bytes:
        return self.commit_async(client, op, timestamp, operation, input_bytes).result()

    def commit_async(self, client: int, op: int, timestamp: int,
                     operation: Operation, input_bytes: bytes):
        """Dispatch one committed operation; returns a ReplyFuture.
        create_transfers batches (and lookup_accounts gathers behind
        in-flight batches) resolve at the next ring fetch."""
        assert op != 0
        assert self.input_valid(operation, input_bytes)
        assert timestamp > self.commit_timestamp
        if operation == Operation.create_transfers:
            return self._commit_create_transfers_device(timestamp, input_bytes)
        if operation == Operation.lookup_accounts:
            if self._dev.has_inflight():
                return self._lookup_accounts_device(input_bytes)
            return ReplyFuture(value=self._lookup_accounts(input_bytes))
        if operation == Operation.pulse:
            return ReplyFuture(value=self._commit_expire(timestamp))
        if operation == Operation.create_accounts:
            return ReplyFuture(value=self._commit_create_accounts(timestamp, input_bytes))
        self._dev.drain()
        if operation == Operation.lookup_transfers:
            return ReplyFuture(value=self._lookup_transfers(input_bytes))
        raise NotImplementedError(
            f"{operation.name} is not ported yet (ROADMAP: query operations)"
        )

    # ------------------------------------------------------------------
    # Accounts (cold path: per-event, exact oracle semantics).

    def _account_slot(self, id_value: int) -> int | None:
        found, slot = self._acct_dir.lookup(
            np.array([id_value & U64_MAX], np.uint64),
            np.array([id_value >> 64], np.uint64),
        )
        return int(slot[0]) if found[0] else None

    def _sync_engine_meta(self, n0: int) -> None:
        """Register accounts created since slot n0 with the engine's
        meta table (the device ladder's ledger input)."""
        if self._attrs.count <= n0:
            return
        slots = np.arange(n0, self._attrs.count, dtype=np.int64)
        self._dev.add_accounts(
            slots, self._attrs.col("flags")[n0:], self._attrs.col("ledger")[n0:]
        )

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
        self._ensure_balance_capacity(self._attrs.count)
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
        self._mirror.grow(cap)

    # ------------------------------------------------------------------
    # Device-authoritative create_transfers.

    def _commit_create_transfers_device(self, timestamp: int, input_bytes: bytes):
        """Route a batch to K1; the host does joins, the device computes
        the result codes.  Shapes outside the order-free class raise
        ResidualNotPorted (the reference routes them to its host path)."""
        events = np.frombuffer(input_bytes, dtype=TRANSFER_DTYPE)
        n = len(events)
        ts_base = timestamp - n + 1

        if n == 0:
            self._dev.drain()
            return ReplyFuture(value=b"")
        if n > dk.B:
            raise ResidualNotPorted(f"more than {dk.B} events")

        id_lo = np.asarray(events["id_lo"])
        id_hi = np.asarray(events["id_hi"])
        flags16 = np.asarray(events["flags"])
        flags = flags16.astype(np.uint32)
        timeout = events["timeout"].astype(np.uint64)

        has_linked = bool((flags16 & np.uint16(TF.linked)).any())
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
        if not ids_unique:
            raise ResidualNotPorted("duplicate ids in batch")
        if has_bal:
            raise ResidualNotPorted("balancing")

        # In-flight hazard: this batch's ids must not collide with
        # batches whose bookkeeping has not materialized yet.
        keys = pack_u128(id_lo, id_hi)
        keys_sorted = keys if ascending else np.sort(keys)
        if self._dev.inflight_ids_hit(keys):
            self._dev.drain()

        e_found, _e_row = self._tdir.lookup(id_lo, id_hi)
        if e_found.any():
            raise ResidualNotPorted("id already exists")

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
        dr_flags = np.where(dr_found, attrs["flags"][np.clip(dr_slot, 0, None)], 0)
        cr_flags = np.where(cr_found, attrs["flags"][np.clip(cr_slot, 0, None)], 0)
        LIMH = np.uint32(
            AF.debits_must_not_exceed_credits
            | AF.credits_must_not_exceed_debits
            | AF.history
        )
        touch_limit_hist = bool(
            ((dr_flags.astype(np.uint32) | cr_flags.astype(np.uint32)) & LIMH).any()
        )

        if has_linked:
            raise ResidualNotPorted("linked")
        if has_pv:
            raise ResidualNotPorted("post/void")
        if touch_limit_hist:
            raise ResidualNotPorted("limit or history account")
        if timeout.any():
            raise ResidualNotPorted("timeout")
        return self._submit_device_orderfree(
            events=events, n=n, ts_base=ts_base, id_lo=id_lo, id_hi=id_hi,
            dr_lo=dr_lo, dr_hi=dr_hi, cr_lo=cr_lo, cr_hi=cr_hi, flags=flags,
            timeout=timeout, dr_slot=dr_slot, cr_slot=cr_slot,
            keys_sorted=keys_sorted, timestamp=timestamp,
            input_bytes=input_bytes,
        )

    def _device_pack_base(self, n, events, id_lo, id_hi, dr_lo, dr_hi,
                          cr_lo, cr_hi, flags, timeout, dr_slot, cr_slot):
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

    def _submit_device_orderfree(
        self, events, n, ts_base, id_lo, id_hi, dr_lo, dr_hi, cr_lo, cr_hi,
        flags, timeout, dr_slot, cr_slot, keys_sorted, timestamp, input_bytes,
    ):
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
                dr_slot=dr_slot, cr_slot=cr_slot,
            )
        else:
            pk = self._device_pack_base(
                n, events, id_lo, id_hi, dr_lo, dr_hi, cr_lo, cr_hi,
                flags, timeout, dr_slot, cr_slot,
            )
        created = {
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
                n, ts_base, id_lo, id_hi, flags, results, created,
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
        )

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
    # Exact host lane: the re-execution of a flagged batch.

    def _commit_create_transfers(self, timestamp: int, input_bytes: bytes) -> bytes:
        """Exact host execution of a batch, ported for the order-free
        class only (static ladder + mirror admission); everything else
        raises ResidualNotPorted."""
        events = np.frombuffer(input_bytes, dtype=TRANSFER_DTYPE)
        n = len(events)
        if n == 0:
            return b""
        self.stat_host_semantic_events += n
        ts_base = timestamp - n + 1
        d = self._decode_static(events, n)
        order_free = not (
            d["flags"]
            & np.uint32(
                TF.linked | TF.post_pending_transfer | TF.void_pending_transfer
                | TF.balancing_debit | TF.balancing_credit
            )
        ).any()
        e_found, _ = self._tdir.lookup(d["id_lo"], d["id_hi"])
        limit_hist = (
            (d["dr_flags"] | d["cr_flags"])
            & np.uint32(
                AF.debits_must_not_exceed_credits
                | AF.credits_must_not_exceed_debits | AF.history
            )
        ).any()
        if not order_free or e_found.any() or limit_hist:
            raise ResidualNotPorted("exact re-execution outside the order-free class")
        reply = self._commit_fast(
            n, ts_base, events, d["id_lo"], d["id_hi"], d["pend_lo"],
            d["pend_hi"], d["flags"], d["timeout"], d["dr_slot"], d["cr_slot"],
            d["amount_lo"], d["amount_hi"], d["ledger"], d["code"], d["static"],
        )
        if reply is None:
            raise ResidualNotPorted("possible balance overflow")
        self.stat_device_events += n
        return reply

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
        return self._finish_fast(n, ts_base, id_lo, id_hi, flags, results, created)

    def _finish_fast(self, n, ts_base, id_lo, id_hi, flags, results, created,
                     last_applied: int | None = None) -> bytes:
        """Shared fast-path tail: store bookkeeping + failure reply."""
        apply_mask = results == 0
        is_pending = (flags & np.uint32(TF.pending)) != 0
        inb_status = np.where(apply_mask & is_pending, np.uint32(S_PENDING), np.uint32(0))
        if last_applied is None:
            applied_idx = np.flatnonzero(apply_mask)
            last_applied = int(applied_idx[-1]) if len(applied_idx) else -1
        self._post_process_transfers(
            n, ts_base, id_lo, id_hi, flags, apply_mask, created, inb_status,
            last_applied,
        )
        fail_idx = np.flatnonzero(results != 0)
        reply = np.zeros(len(fail_idx), dtype=CREATE_RESULT_DTYPE)
        reply["index"] = fail_idx.astype(np.uint32)
        reply["result"] = results[fail_idx]
        return reply.tobytes()

    def _post_process_transfers(self, n, ts_base, id_lo, id_hi, flags,
                                created_mask, created, inb_status,
                                last_applied) -> None:
        """Insert the created transfers into the store and the id
        directory, and advance commit_timestamp to the last event that
        reached the apply point (reference: src/state_machine.zig:1583).
        Expiry and history bookkeeping belong to classes this slice
        refuses (timeouts, history accounts)."""
        cm_ = created_mask
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
        if last_applied >= 0:
            self.commit_timestamp = ts_base + last_applied

    # ------------------------------------------------------------------
    # Expiry pulse.  No pending transfer with a timeout is ever created
    # in this slice (timeouts raise ResidualNotPorted), so the expiry
    # index stays empty: a pulse finds nothing and parks the next one.

    def _scan_expired(self, expires_at_max: int) -> np.ndarray:
        self.pulse_next_timestamp = TIMESTAMP_MAX
        return np.zeros(0, np.int64)

    def _commit_expire(self, timestamp: int) -> bytes:
        assert self._expiry_rows is not None
        assert len(self._expiry_rows) == 0
        self._expiry_rows = None
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

"""CPU reference ("oracle") accounting state machine.

Implements the exact commit semantics of the reference state machine
(reference: src/state_machine.zig) on plain Python data structures. This
is the parity oracle the TPU kernel is diffed against bit-for-bit, and
doubles as the executable specification of every result code.

Python ints model u128 exactly (masked where the reference wraps);
grooves are dict-backed with the same secondary indexes the LSM forest
maintains, and scoped rollback mirrors ``scope_open``/``scope_close``
(reference: src/lsm/tree.zig:202-222, src/state_machine.zig:1190-1218).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

import numpy as np

from tigerbeetle_tpu_torch import constants as cfg
from tigerbeetle_tpu_torch import types
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
    Operation,
    TransferFlags,
    TransferPendingStatus,
)

AF = AccountFlags
TF = TransferFlags
CAR = CreateAccountResult
CTR = CreateTransferResult


@dataclasses.dataclass(slots=True)
class AccountRec:
    """In-memory Account (reference: src/tigerbeetle.zig:7-29)."""

    id: int = 0
    debits_pending: int = 0
    debits_posted: int = 0
    credits_pending: int = 0
    credits_posted: int = 0
    user_data_128: int = 0
    user_data_64: int = 0
    user_data_32: int = 0
    reserved: int = 0
    ledger: int = 0
    code: int = 0
    flags: int = 0
    timestamp: int = 0

    @classmethod
    def from_np(cls, row: np.void) -> "AccountRec":
        g = types.u128_get
        return cls(
            id=g(row, "id"),
            debits_pending=g(row, "debits_pending"),
            debits_posted=g(row, "debits_posted"),
            credits_pending=g(row, "credits_pending"),
            credits_posted=g(row, "credits_posted"),
            user_data_128=g(row, "user_data_128"),
            user_data_64=int(row["user_data_64"]),
            user_data_32=int(row["user_data_32"]),
            reserved=int(row["reserved"]),
            ledger=int(row["ledger"]),
            code=int(row["code"]),
            flags=int(row["flags"]),
            timestamp=int(row["timestamp"]),
        )

    def to_np(self, row: np.void) -> None:
        s = types.u128_set
        s(row, "id", self.id)
        s(row, "debits_pending", self.debits_pending)
        s(row, "debits_posted", self.debits_posted)
        s(row, "credits_pending", self.credits_pending)
        s(row, "credits_posted", self.credits_posted)
        s(row, "user_data_128", self.user_data_128)
        row["user_data_64"] = self.user_data_64
        row["user_data_32"] = self.user_data_32
        row["reserved"] = self.reserved
        row["ledger"] = self.ledger
        row["code"] = self.code
        row["flags"] = self.flags
        row["timestamp"] = self.timestamp

    def copy(self) -> "AccountRec":
        return dataclasses.replace(self)

    def debits_exceed_credits(self, amount: int) -> bool:
        # reference: src/tigerbeetle.zig:31-34
        return bool(self.flags & AF.debits_must_not_exceed_credits) and (
            self.debits_pending + self.debits_posted + amount > self.credits_posted
        )

    def credits_exceed_debits(self, amount: int) -> bool:
        # reference: src/tigerbeetle.zig:36-39
        return bool(self.flags & AF.credits_must_not_exceed_debits) and (
            self.credits_pending + self.credits_posted + amount > self.debits_posted
        )


@dataclasses.dataclass(slots=True)
class TransferRec:
    """In-memory Transfer (reference: src/tigerbeetle.zig:80-111)."""

    id: int = 0
    debit_account_id: int = 0
    credit_account_id: int = 0
    amount: int = 0
    pending_id: int = 0
    user_data_128: int = 0
    user_data_64: int = 0
    user_data_32: int = 0
    timeout: int = 0
    ledger: int = 0
    code: int = 0
    flags: int = 0
    timestamp: int = 0

    @classmethod
    def from_np(cls, row: np.void) -> "TransferRec":
        g = types.u128_get
        return cls(
            id=g(row, "id"),
            debit_account_id=g(row, "debit_account_id"),
            credit_account_id=g(row, "credit_account_id"),
            amount=g(row, "amount"),
            pending_id=g(row, "pending_id"),
            user_data_128=g(row, "user_data_128"),
            user_data_64=int(row["user_data_64"]),
            user_data_32=int(row["user_data_32"]),
            timeout=int(row["timeout"]),
            ledger=int(row["ledger"]),
            code=int(row["code"]),
            flags=int(row["flags"]),
            timestamp=int(row["timestamp"]),
        )

    def to_np(self, row: np.void) -> None:
        s = types.u128_set
        s(row, "id", self.id)
        s(row, "debit_account_id", self.debit_account_id)
        s(row, "credit_account_id", self.credit_account_id)
        s(row, "amount", self.amount)
        s(row, "pending_id", self.pending_id)
        s(row, "user_data_128", self.user_data_128)
        row["user_data_64"] = self.user_data_64
        row["user_data_32"] = self.user_data_32
        row["timeout"] = self.timeout
        row["ledger"] = self.ledger
        row["code"] = self.code
        row["flags"] = self.flags
        row["timestamp"] = self.timestamp

    def copy(self) -> "TransferRec":
        return dataclasses.replace(self)

    def timeout_ns(self) -> int:
        # reference: src/tigerbeetle.zig:101-104
        return self.timeout * NS_PER_S


@dataclasses.dataclass(slots=True)
class BalanceRec:
    """reference: src/state_machine.zig:296-315 (AccountBalancesGrooveValue)."""

    dr_account_id: int = 0
    dr_debits_pending: int = 0
    dr_debits_posted: int = 0
    dr_credits_pending: int = 0
    dr_credits_posted: int = 0
    cr_account_id: int = 0
    cr_debits_pending: int = 0
    cr_debits_posted: int = 0
    cr_credits_pending: int = 0
    cr_credits_posted: int = 0
    timestamp: int = 0


def sum_overflows(a: int, b: int, limit: int = U128_MAX) -> bool:
    # reference: src/state_machine.zig:2002-2007
    return a + b > limit


class UndoLog:
    """Command-log undo for scoped rollback.

    Every groove mutation made while a scope is open registers an
    inverse closure; ``scope_close(.discard)`` replays them in reverse
    (reference: src/lsm/groove.zig scope machinery).
    """

    def __init__(self) -> None:
        self._entries: list[Callable[[], None]] | None = None

    @property
    def active(self) -> bool:
        return self._entries is not None

    def record(self, inverse: Callable[[], None]) -> None:
        if self._entries is not None:
            self._entries.append(inverse)

    def open(self) -> None:
        assert self._entries is None
        self._entries = []

    def close(self, persist: bool) -> None:
        entries = self._entries
        assert entries is not None
        self._entries = None
        if not persist:
            for inverse in reversed(entries):
                inverse()


class CpuStateMachine:
    """Single-node oracle with the reference's commit-time semantics.

    Interface mirrors ``StateMachineType`` (reference:
    src/state_machine.zig:341-350,543,575,589,1107): ``input_valid``,
    ``prepare``, ``pulse_needed``, ``prefetch`` + ``commit``.
    """

    def __init__(self, config: cfg.Config = cfg.PRODUCTION) -> None:
        self.config = config
        self.prepare_timestamp = 0
        self.commit_timestamp = 0

        # Grooves (reference: src/state_machine.zig:178-324).
        self.accounts: dict[int, AccountRec] = {}
        self.accounts_by_timestamp: dict[int, int] = {}  # timestamp -> id
        self.transfers: dict[int, TransferRec] = {}
        self.transfers_by_timestamp: dict[int, int] = {}  # timestamp -> id
        # Secondary indexes used by queries: account id -> [timestamps].
        # Timestamps are assigned monotonically so appends keep order.
        self.transfers_by_dr: dict[int, list[int]] = {}
        self.transfers_by_cr: dict[int, list[int]] = {}
        # Derived index (reference: src/state_machine.zig:229-238):
        # set of (expires_at, pending_transfer_timestamp).
        self.expires_at_index: set[tuple[int, int]] = set()
        # reference: src/state_machine.zig:259-269
        self.transfers_pending: dict[int, TransferPendingStatus] = {}
        # timestamp -> BalanceRec (reference: src/state_machine.zig:296)
        self.account_balances: dict[int, BalanceRec] = {}

        self._undo = UndoLog()

        # reference: src/state_machine.zig:2058-2063
        self.pulse_next_timestamp = TIMESTAMP_MIN
        # Buffer filled by prefetch(pulse); consumed by commit(pulse).
        self._expiry_buffer: list[TransferRec] | None = None

    # ------------------------------------------------------------------
    # Introspection helpers shared with TpuStateMachine (tests use these
    # instead of reaching into either implementation's internals).

    def transfer_timestamp(self, id_value: int) -> int | None:
        t = self.transfers.get(id_value)
        return None if t is None else t.timestamp

    def pending_status(self, id_value: int) -> TransferPendingStatus | None:
        t = self.transfers.get(id_value)
        if t is None:
            return None
        return self.transfers_pending.get(t.timestamp)

    @property
    def history_count(self) -> int:
        return len(self.account_balances)

    def account_balances_raw(self, id_value: int) -> tuple | None:
        a = self.accounts.get(id_value)
        if a is None:
            return None
        return (a.debits_pending, a.debits_posted, a.credits_pending, a.credits_posted)

    def state_root(self) -> bytes:
        """16-byte state commitment of the account table — the same
        value TpuStateMachine.state_root reports for the same commit
        stream (commitment.py; row index = creation order, which is
        the TPU build's slot assignment).  Recomputed from scratch:
        the oracle optimizes for simplicity, not update cost."""
        from tigerbeetle_tpu_torch.state_machine import commitment as cm

        n = len(self.accounts)
        bal8 = np.zeros((n, 8), np.uint64)
        meta = np.zeros((n, 2), np.uint32)
        mask = (1 << 64) - 1
        for i, a in enumerate(self.accounts.values()):
            for j, v in enumerate(
                (a.debits_pending, a.debits_posted,
                 a.credits_pending, a.credits_posted)
            ):
                bal8[i, 2 * j] = v & mask
                bal8[i, 2 * j + 1] = v >> 64
            meta[i, 0] = a.flags
            meta[i, 1] = a.ledger
        return cm.root_bytes(cm.table_digest(bal8, meta))

    # ------------------------------------------------------------------
    # Groove mutations (undo-aware).

    def _account_insert(self, a: AccountRec) -> None:
        key, ts = a.id, a.timestamp
        self.accounts[key] = a
        self.accounts_by_timestamp[ts] = key
        self._undo.record(
            lambda: (self.accounts.pop(key), self.accounts_by_timestamp.pop(ts))
        )

    def _account_update(self, new: AccountRec) -> None:
        key = new.id
        old = self.accounts[key]
        self.accounts[key] = new
        self._undo.record(lambda: self.accounts.__setitem__(key, old))

    def _transfer_insert(self, t: TransferRec) -> None:
        key, ts = t.id, t.timestamp
        self.transfers[key] = t
        self.transfers_by_timestamp[ts] = key
        self.transfers_by_dr.setdefault(t.debit_account_id, []).append(ts)
        self.transfers_by_cr.setdefault(t.credit_account_id, []).append(ts)

        def undo() -> None:
            self.transfers.pop(key)
            self.transfers_by_timestamp.pop(ts)
            self.transfers_by_dr[t.debit_account_id].pop()
            self.transfers_by_cr[t.credit_account_id].pop()

        self._undo.record(undo)
        # Derived expires_at index (reference: src/state_machine.zig:230-238).
        if (t.flags & TF.pending) and t.timeout > 0:
            self._expires_at_insert(t.timestamp + t.timeout_ns(), ts)

    def _expires_at_insert(self, expires_at: int, ts: int) -> None:
        entry = (expires_at, ts)
        self.expires_at_index.add(entry)
        self._undo.record(lambda: self.expires_at_index.discard(entry))

    def _expires_at_remove(self, expires_at: int, ts: int) -> None:
        entry = (expires_at, ts)
        assert entry in self.expires_at_index
        self.expires_at_index.remove(entry)
        self._undo.record(lambda: self.expires_at_index.add(entry))

    def _pending_insert(self, ts: int, status: TransferPendingStatus) -> None:
        self.transfers_pending[ts] = status
        self._undo.record(lambda: self.transfers_pending.pop(ts))

    def _pending_update(self, ts: int, status: TransferPendingStatus) -> None:
        old = self.transfers_pending[ts]
        assert old == TransferPendingStatus.pending
        assert status not in (TransferPendingStatus.none, TransferPendingStatus.pending)
        self.transfers_pending[ts] = status
        self._undo.record(lambda: self.transfers_pending.__setitem__(ts, old))

    def _balance_insert(self, b: BalanceRec) -> None:
        ts = b.timestamp
        self.account_balances[ts] = b
        self._undo.record(lambda: self.account_balances.pop(ts))

    # ------------------------------------------------------------------
    # Operation plumbing (reference: src/state_machine.zig:543-596).

    def input_valid(self, operation: Operation, input_bytes: bytes) -> bool:
        # reference: src/state_machine.zig:543-572
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
        if len(input_bytes) > batch_max * event_size:
            return False
        return True

    def prepare(self, operation: Operation, input_bytes: bytes) -> None:
        # reference: src/state_machine.zig:575-587
        assert self.input_valid(operation, input_bytes)
        if operation in (Operation.create_accounts, Operation.create_transfers):
            event_size = types.EVENT_DTYPE[operation].itemsize
            self.prepare_timestamp += len(input_bytes) // event_size

    def pulse_needed(self) -> bool:
        # reference: src/state_machine.zig:589-596
        return self.pulse_next_timestamp <= self.prepare_timestamp

    def prefetch(
        self, operation: Operation, input_bytes: bytes, prefetch_timestamp: int
    ) -> None:
        """Synchronous equivalent of the async prefetch chain.

        Only the pulse path has observable state here: the expiry scan
        (reference: src/state_machine.zig:1010-1060) snapshots the
        expired-transfer batch and updates ``pulse_next_timestamp``.
        """
        if operation == Operation.pulse:
            assert len(input_bytes) == 0
            self._expiry_buffer = self._scan_expired(prefetch_timestamp)

    def _scan_expired(self, expires_at_max: int) -> list[TransferRec]:
        # reference: src/state_machine.zig:2071-2145 (ExpirePendingTransfers)
        limit = self.config.batch_max_create_transfers
        ordered = sorted(self.expires_at_index)
        results: list[TransferRec] = []
        value_next_expired_at: int | None = None
        buffer_finished = False
        for expires_at, ts in ordered:
            value_next_expired_at = expires_at
            if expires_at <= expires_at_max:
                if len(results) == limit:
                    buffer_finished = True
                    break
                results.append(self.transfers[self.transfers_by_timestamp[ts]])
            else:
                break  # exclude_and_stop (reference: :2162-2165)
        # finish() (reference: src/state_machine.zig:2112-2145)
        if buffer_finished:
            self.pulse_next_timestamp = value_next_expired_at
        else:
            if value_next_expired_at is None or value_next_expired_at <= expires_at_max:
                self.pulse_next_timestamp = TIMESTAMP_MAX
            else:
                self.pulse_next_timestamp = value_next_expired_at
        return results

    # Read-only operations a follower may answer out of band (the
    # shared definition lives in types.READ_OPERATIONS) — every one
    # dispatches to a pure executor below (no timestamp advance, no
    # expiry scan, no mutation), so serving them outside the commit
    # stream cannot perturb replayed state.
    READ_OPERATIONS = types.READ_OPERATIONS

    def execute_read(self, operation: Operation, input_bytes: bytes) -> bytes:
        """Serve a read WITHOUT committing it (round 19, the follower
        read path): byte-identical to what commit() would reply for
        the same operation at the current state, but with zero state
        effects — commit_timestamp, pulse scheduling, and the history
        tables are untouched, so interleaved replay stays bit-exact."""
        operation = Operation(operation)
        assert operation in self.READ_OPERATIONS, operation
        assert self.input_valid(operation, input_bytes)
        if operation == Operation.lookup_accounts:
            return self._execute_lookup_accounts(input_bytes)
        if operation == Operation.lookup_transfers:
            return self._execute_lookup_transfers(input_bytes)
        if operation == Operation.get_account_transfers:
            return self._execute_get_account_transfers(input_bytes)
        return self._execute_get_account_balances(input_bytes)

    def commit(
        self,
        client: int,
        op: int,
        timestamp: int,
        operation: Operation,
        input_bytes: bytes,
    ) -> bytes:
        # reference: src/state_machine.zig:1107-1146
        assert op != 0
        assert self.input_valid(operation, input_bytes)
        assert timestamp > self.commit_timestamp

        if operation == Operation.pulse:
            return self._execute_expire_pending_transfers(timestamp)
        if operation == Operation.create_accounts:
            return self._execute_create(Operation.create_accounts, timestamp, input_bytes)
        if operation == Operation.create_transfers:
            return self._execute_create(Operation.create_transfers, timestamp, input_bytes)
        if operation == Operation.lookup_accounts:
            return self._execute_lookup_accounts(input_bytes)
        if operation == Operation.lookup_transfers:
            return self._execute_lookup_transfers(input_bytes)
        if operation == Operation.get_account_transfers:
            return self._execute_get_account_transfers(input_bytes)
        if operation == Operation.get_account_balances:
            return self._execute_get_account_balances(input_bytes)
        raise AssertionError(operation)

    # ------------------------------------------------------------------
    # execute() — the chain/rollback loop (reference: src/state_machine.zig:1220-1306).

    def _execute_create(
        self, operation: Operation, timestamp: int, input_bytes: bytes
    ) -> bytes:
        dtype = (
            ACCOUNT_DTYPE
            if operation == Operation.create_accounts
            else TRANSFER_DTYPE
        )
        events = np.frombuffer(input_bytes, dtype=dtype)
        n = len(events)
        results: list[tuple[int, int]] = []

        chain: int | None = None
        chain_broken = False

        for index in range(n):
            if operation == Operation.create_accounts:
                event: AccountRec | TransferRec = AccountRec.from_np(events[index])
                linked = bool(event.flags & AF.linked)
            else:
                event = TransferRec.from_np(events[index])
                linked = bool(event.flags & TF.linked)

            result: int | None = None
            if linked:
                if chain is None:
                    chain = index
                    assert not chain_broken
                    self._undo.open()
                if index == n - 1:
                    result = CTR.linked_event_chain_open  # same value for accounts

            if result is None and chain_broken:
                result = CTR.linked_event_failed
            if result is None and event.timestamp != 0:
                result = CTR.timestamp_must_be_zero

            if result is None:
                event.timestamp = timestamp - n + index + 1
                if operation == Operation.create_accounts:
                    result = self._create_account(event)
                else:
                    result = self._create_transfer(event)

            if result != 0:
                if chain is not None:
                    if not chain_broken:
                        chain_broken = True
                        self._undo.close(persist=False)
                        # FIFO error emission for rolled-back events
                        # (reference: src/state_machine.zig:1276-1284).
                        for chain_index in range(chain, index):
                            results.append((chain_index, CTR.linked_event_failed))
                    else:
                        assert result in (
                            CTR.linked_event_failed,
                            CTR.linked_event_chain_open,
                        )
                results.append((index, int(result)))

            if chain is not None and (
                not linked or result == CTR.linked_event_chain_open
            ):
                if not chain_broken:
                    self._undo.close(persist=True)
                chain = None
                chain_broken = False

        assert chain is None
        assert not chain_broken

        out = np.zeros(len(results), dtype=CREATE_RESULT_DTYPE)
        for i, (index, result) in enumerate(results):
            out[i]["index"] = index
            out[i]["result"] = result
        return out.tobytes()

    # ------------------------------------------------------------------
    # create_account (reference: src/state_machine.zig:1421-1459).

    def _create_account(self, a: AccountRec) -> CAR:
        assert a.timestamp > self.commit_timestamp

        if a.reserved != 0:
            return CAR.reserved_field
        if a.flags & ~int(AF._valid_mask):
            return CAR.reserved_flag
        if a.id == 0:
            return CAR.id_must_not_be_zero
        if a.id == U128_MAX:
            return CAR.id_must_not_be_int_max
        if (a.flags & AF.debits_must_not_exceed_credits) and (
            a.flags & AF.credits_must_not_exceed_debits
        ):
            return CAR.flags_are_mutually_exclusive
        if a.debits_pending != 0:
            return CAR.debits_pending_must_be_zero
        if a.debits_posted != 0:
            return CAR.debits_posted_must_be_zero
        if a.credits_pending != 0:
            return CAR.credits_pending_must_be_zero
        if a.credits_posted != 0:
            return CAR.credits_posted_must_be_zero
        if a.ledger == 0:
            return CAR.ledger_must_not_be_zero
        if a.code == 0:
            return CAR.code_must_not_be_zero

        e = self.accounts.get(a.id)
        if e is not None:
            return self._create_account_exists(a, e)

        self._account_insert(a)
        self.commit_timestamp = a.timestamp
        return CAR.ok

    @staticmethod
    def _create_account_exists(a: AccountRec, e: AccountRec) -> CAR:
        # reference: src/state_machine.zig:1450-1460
        assert a.id == e.id
        if a.flags != e.flags:
            return CAR.exists_with_different_flags
        if a.user_data_128 != e.user_data_128:
            return CAR.exists_with_different_user_data_128
        if a.user_data_64 != e.user_data_64:
            return CAR.exists_with_different_user_data_64
        if a.user_data_32 != e.user_data_32:
            return CAR.exists_with_different_user_data_32
        if a.ledger != e.ledger:
            return CAR.exists_with_different_ledger
        if a.code != e.code:
            return CAR.exists_with_different_code
        return CAR.exists

    # ------------------------------------------------------------------
    # create_transfer (reference: src/state_machine.zig:1462-1585).

    def _create_transfer(self, t: TransferRec) -> CTR:
        assert t.timestamp > self.commit_timestamp

        if t.flags & ~int(TF._valid_mask):
            return CTR.reserved_flag
        if t.id == 0:
            return CTR.id_must_not_be_zero
        if t.id == U128_MAX:
            return CTR.id_must_not_be_int_max

        if t.flags & (TF.post_pending_transfer | TF.void_pending_transfer):
            return self._post_or_void_pending_transfer(t)

        if t.debit_account_id == 0:
            return CTR.debit_account_id_must_not_be_zero
        if t.debit_account_id == U128_MAX:
            return CTR.debit_account_id_must_not_be_int_max
        if t.credit_account_id == 0:
            return CTR.credit_account_id_must_not_be_zero
        if t.credit_account_id == U128_MAX:
            return CTR.credit_account_id_must_not_be_int_max
        if t.credit_account_id == t.debit_account_id:
            return CTR.accounts_must_be_different

        if t.pending_id != 0:
            return CTR.pending_id_must_be_zero
        if not (t.flags & TF.pending):
            if t.timeout != 0:
                return CTR.timeout_reserved_for_pending_transfer
        if not (t.flags & (TF.balancing_debit | TF.balancing_credit)):
            if t.amount == 0:
                return CTR.amount_must_not_be_zero

        if t.ledger == 0:
            return CTR.ledger_must_not_be_zero
        if t.code == 0:
            return CTR.code_must_not_be_zero

        dr_account = self.accounts.get(t.debit_account_id)
        if dr_account is None:
            return CTR.debit_account_not_found
        cr_account = self.accounts.get(t.credit_account_id)
        if cr_account is None:
            return CTR.credit_account_not_found
        assert t.timestamp > dr_account.timestamp
        assert t.timestamp > cr_account.timestamp

        if dr_account.ledger != cr_account.ledger:
            return CTR.accounts_must_have_the_same_ledger
        if t.ledger != dr_account.ledger:
            return CTR.transfer_must_have_the_same_ledger_as_accounts

        # Existing transfers must not influence overflow/limit checks
        # (reference: src/state_machine.zig:1506-1507) — note the raw
        # (unclamped) t.amount is compared here.
        e = self.transfers.get(t.id)
        if e is not None:
            return self._create_transfer_exists(t, e)

        # Balancing clamp (reference: src/state_machine.zig:1509-1529).
        amount = t.amount
        if t.flags & (TF.balancing_debit | TF.balancing_credit):
            if amount == 0:
                amount = U64_MAX  # reference uses maxInt(u64) here
        else:
            assert amount != 0
        if t.flags & TF.balancing_debit:
            dr_balance = dr_account.debits_posted + dr_account.debits_pending
            amount = min(amount, max(0, dr_account.credits_posted - dr_balance))
            if amount == 0:
                return CTR.exceeds_credits
        if t.flags & TF.balancing_credit:
            cr_balance = cr_account.credits_posted + cr_account.credits_pending
            amount = min(amount, max(0, cr_account.debits_posted - cr_balance))
            if amount == 0:
                return CTR.exceeds_debits

        # Overflow ladder (reference: src/state_machine.zig:1531-1545).
        if t.flags & TF.pending:
            if sum_overflows(amount, dr_account.debits_pending):
                return CTR.overflows_debits_pending
            if sum_overflows(amount, cr_account.credits_pending):
                return CTR.overflows_credits_pending
        if sum_overflows(amount, dr_account.debits_posted):
            return CTR.overflows_debits_posted
        if sum_overflows(amount, cr_account.credits_posted):
            return CTR.overflows_credits_posted
        if sum_overflows(amount, dr_account.debits_pending + dr_account.debits_posted):
            return CTR.overflows_debits
        if sum_overflows(amount, cr_account.credits_pending + cr_account.credits_posted):
            return CTR.overflows_credits

        if sum_overflows(t.timestamp, t.timeout * NS_PER_S, U64_MAX):
            return CTR.overflows_timeout

        if dr_account.debits_exceed_credits(amount):
            return CTR.exceeds_credits
        if cr_account.credits_exceed_debits(amount):
            return CTR.exceeds_debits

        # Apply (reference: src/state_machine.zig:1549-1585).
        t2 = t.copy()
        t2.amount = amount
        self._transfer_insert(t2)

        dr_new = dr_account.copy()
        cr_new = cr_account.copy()
        if t.flags & TF.pending:
            dr_new.debits_pending += amount
            cr_new.credits_pending += amount
            self._pending_insert(t2.timestamp, TransferPendingStatus.pending)
        else:
            dr_new.debits_posted += amount
            cr_new.credits_posted += amount
        self._account_update(dr_new)
        self._account_update(cr_new)

        self._historical_balance(t2, dr_new, cr_new)

        if t.timeout > 0:
            expires_at = t.timestamp + t.timeout_ns()
            if expires_at < self.pulse_next_timestamp:
                self.pulse_next_timestamp = expires_at

        self.commit_timestamp = t.timestamp
        return CTR.ok

    @staticmethod
    def _create_transfer_exists(t: TransferRec, e: TransferRec) -> CTR:
        # reference: src/state_machine.zig:1587-1606
        assert t.id == e.id
        if t.flags != e.flags:
            return CTR.exists_with_different_flags
        if t.debit_account_id != e.debit_account_id:
            return CTR.exists_with_different_debit_account_id
        if t.credit_account_id != e.credit_account_id:
            return CTR.exists_with_different_credit_account_id
        if t.amount != e.amount:
            return CTR.exists_with_different_amount
        assert t.pending_id == 0 and e.pending_id == 0
        if t.user_data_128 != e.user_data_128:
            return CTR.exists_with_different_user_data_128
        if t.user_data_64 != e.user_data_64:
            return CTR.exists_with_different_user_data_64
        if t.user_data_32 != e.user_data_32:
            return CTR.exists_with_different_user_data_32
        if t.timeout != e.timeout:
            return CTR.exists_with_different_timeout
        assert t.ledger == e.ledger
        if t.code != e.code:
            return CTR.exists_with_different_code
        return CTR.exists

    # ------------------------------------------------------------------
    # Two-phase post/void (reference: src/state_machine.zig:1608-1741).

    def _post_or_void_pending_transfer(self, t: TransferRec) -> CTR:
        assert t.id != 0
        assert t.timestamp > self.commit_timestamp
        post = bool(t.flags & TF.post_pending_transfer)
        void = bool(t.flags & TF.void_pending_transfer)
        assert post or void

        if post and void:
            return CTR.flags_are_mutually_exclusive
        if t.flags & TF.pending:
            return CTR.flags_are_mutually_exclusive
        if t.flags & TF.balancing_debit:
            return CTR.flags_are_mutually_exclusive
        if t.flags & TF.balancing_credit:
            return CTR.flags_are_mutually_exclusive

        if t.pending_id == 0:
            return CTR.pending_id_must_not_be_zero
        if t.pending_id == U128_MAX:
            return CTR.pending_id_must_not_be_int_max
        if t.pending_id == t.id:
            return CTR.pending_id_must_be_different
        if t.timeout != 0:
            return CTR.timeout_reserved_for_pending_transfer

        p = self.transfers.get(t.pending_id)
        if p is None:
            return CTR.pending_transfer_not_found
        assert p.timestamp < t.timestamp
        if not (p.flags & TF.pending):
            return CTR.pending_transfer_not_pending

        dr_account = self.accounts[p.debit_account_id]
        cr_account = self.accounts[p.credit_account_id]
        assert p.amount > 0

        if t.debit_account_id > 0 and t.debit_account_id != p.debit_account_id:
            return CTR.pending_transfer_has_different_debit_account_id
        if t.credit_account_id > 0 and t.credit_account_id != p.credit_account_id:
            return CTR.pending_transfer_has_different_credit_account_id
        if t.ledger > 0 and t.ledger != p.ledger:
            return CTR.pending_transfer_has_different_ledger
        if t.code > 0 and t.code != p.code:
            return CTR.pending_transfer_has_different_code

        amount = t.amount if t.amount > 0 else p.amount
        if amount > p.amount:
            return CTR.exceeds_pending_transfer_amount
        if void and amount < p.amount:
            return CTR.pending_transfer_has_different_amount

        e = self.transfers.get(t.id)
        if e is not None:
            return self._post_or_void_pending_transfer_exists(t, e, p)

        status = self.transfers_pending[p.timestamp]
        if status == TransferPendingStatus.posted:
            return CTR.pending_transfer_already_posted
        if status == TransferPendingStatus.voided:
            return CTR.pending_transfer_already_voided
        if status == TransferPendingStatus.expired:
            assert p.timeout > 0
            assert t.timestamp >= p.timestamp + p.timeout_ns()
            return CTR.pending_transfer_expired
        assert status == TransferPendingStatus.pending

        t2 = TransferRec(
            id=t.id,
            debit_account_id=p.debit_account_id,
            credit_account_id=p.credit_account_id,
            user_data_128=t.user_data_128 if t.user_data_128 > 0 else p.user_data_128,
            user_data_64=t.user_data_64 if t.user_data_64 > 0 else p.user_data_64,
            user_data_32=t.user_data_32 if t.user_data_32 > 0 else p.user_data_32,
            ledger=p.ledger,
            code=p.code,
            pending_id=t.pending_id,
            timeout=0,
            timestamp=t.timestamp,
            flags=t.flags,
            amount=amount,
        )
        self._transfer_insert(t2)

        if p.timeout > 0:
            expires_at = p.timestamp + p.timeout_ns()
            if expires_at <= t.timestamp:
                # QUIRK preserved from the reference: t2 was already
                # inserted above, and this error return leaks it outside
                # a linked chain (reference: src/state_machine.zig:1687-1696).
                return CTR.pending_transfer_expired
            self._expires_at_remove(expires_at, p.timestamp)
            # reference: src/state_machine.zig:1704-1708
            if self.pulse_next_timestamp == expires_at:
                self.pulse_next_timestamp = TIMESTAMP_MIN

        self._pending_update(
            p.timestamp,
            TransferPendingStatus.posted if post else TransferPendingStatus.voided,
        )

        dr_new = dr_account.copy()
        cr_new = cr_account.copy()
        dr_new.debits_pending -= p.amount
        cr_new.credits_pending -= p.amount
        assert dr_new.debits_pending >= 0
        assert cr_new.credits_pending >= 0
        if post:
            assert 0 < amount <= p.amount
            dr_new.debits_posted += amount
            cr_new.credits_posted += amount
        self._account_update(dr_new)
        self._account_update(cr_new)

        self._historical_balance(t2, dr_new, cr_new)

        self.commit_timestamp = t.timestamp
        return CTR.ok

    @staticmethod
    def _post_or_void_pending_transfer_exists(
        t: TransferRec, e: TransferRec, p: TransferRec
    ) -> CTR:
        # reference: src/state_machine.zig:1743-1804
        assert t.id == e.id
        assert t.id != p.id
        assert t.pending_id == p.id

        if t.flags != e.flags:
            return CTR.exists_with_different_flags
        if t.amount == 0:
            if e.amount != p.amount:
                return CTR.exists_with_different_amount
        else:
            if t.amount != e.amount:
                return CTR.exists_with_different_amount
        if t.pending_id != e.pending_id:
            return CTR.exists_with_different_pending_id

        if t.user_data_128 == 0:
            if e.user_data_128 != p.user_data_128:
                return CTR.exists_with_different_user_data_128
        else:
            if t.user_data_128 != e.user_data_128:
                return CTR.exists_with_different_user_data_128
        if t.user_data_64 == 0:
            if e.user_data_64 != p.user_data_64:
                return CTR.exists_with_different_user_data_64
        else:
            if t.user_data_64 != e.user_data_64:
                return CTR.exists_with_different_user_data_64
        if t.user_data_32 == 0:
            if e.user_data_32 != p.user_data_32:
                return CTR.exists_with_different_user_data_32
        else:
            if t.user_data_32 != e.user_data_32:
                return CTR.exists_with_different_user_data_32
        return CTR.exists

    # ------------------------------------------------------------------
    # Historical balances (reference: src/state_machine.zig:1806-1841).

    def _historical_balance(
        self, transfer: TransferRec, dr: AccountRec, cr: AccountRec
    ) -> None:
        assert transfer.timestamp > 0
        assert transfer.debit_account_id == dr.id
        assert transfer.credit_account_id == cr.id
        if (dr.flags & AF.history) or (cr.flags & AF.history):
            b = BalanceRec(timestamp=transfer.timestamp)
            if dr.flags & AF.history:
                b.dr_account_id = dr.id
                b.dr_debits_pending = dr.debits_pending
                b.dr_debits_posted = dr.debits_posted
                b.dr_credits_pending = dr.credits_pending
                b.dr_credits_posted = dr.credits_posted
            if cr.flags & AF.history:
                b.cr_account_id = cr.id
                b.cr_debits_pending = cr.debits_pending
                b.cr_debits_posted = cr.debits_posted
                b.cr_credits_pending = cr.credits_pending
                b.cr_credits_posted = cr.credits_posted
            self._balance_insert(b)

    # ------------------------------------------------------------------
    # Expiry (reference: src/state_machine.zig:1874-1929).

    def _execute_expire_pending_transfers(self, timestamp: int) -> bytes:
        assert self._expiry_buffer is not None
        transfers, self._expiry_buffer = self._expiry_buffer, None

        for expired in transfers:
            assert expired.flags & TF.pending
            assert expired.timeout > 0
            assert expired.amount > 0
            expires_at = expired.timestamp + expired.timeout_ns()
            assert expires_at <= timestamp

            dr_account = self.accounts[expired.debit_account_id]
            cr_account = self.accounts[expired.credit_account_id]
            assert dr_account.debits_pending >= expired.amount
            assert cr_account.credits_pending >= expired.amount

            dr_new = dr_account.copy()
            cr_new = cr_account.copy()
            dr_new.debits_pending -= expired.amount
            cr_new.credits_pending -= expired.amount
            self._account_update(dr_new)
            self._account_update(cr_new)

            assert self.transfers_pending[expired.timestamp] == TransferPendingStatus.pending
            self._pending_update(expired.timestamp, TransferPendingStatus.expired)

            self._expires_at_remove(expires_at, expired.timestamp)

        return b""

    # ------------------------------------------------------------------
    # Lookups (reference: src/state_machine.zig:1309-1344).

    def _execute_lookup_accounts(self, input_bytes: bytes) -> bytes:
        ids = np.frombuffer(input_bytes, dtype=types.U128_PAIR_DTYPE)
        out = np.zeros(len(ids), dtype=ACCOUNT_DTYPE)
        count = 0
        for row in ids:
            account = self.accounts.get(int(row["lo"]) | (int(row["hi"]) << 64))
            if account is not None:
                account.to_np(out[count])
                count += 1
        return out[:count].tobytes()

    def _execute_lookup_transfers(self, input_bytes: bytes) -> bytes:
        ids = np.frombuffer(input_bytes, dtype=types.U128_PAIR_DTYPE)
        out = np.zeros(len(ids), dtype=TRANSFER_DTYPE)
        count = 0
        for row in ids:
            transfer = self.transfers.get(int(row["lo"]) | (int(row["hi"]) << 64))
            if transfer is not None:
                transfer.to_np(out[count])
                count += 1
        return out[:count].tobytes()

    # ------------------------------------------------------------------
    # Index-scan queries (reference: src/state_machine.zig:786-1008,1346-1419).

    def _filter_scan(self, filter_row: np.void) -> list[int] | None:
        """Validated filter -> ordered transfer timestamps, else None.

        reference: src/state_machine.zig:931-996 (get_scan_from_filter).
        """
        account_id = types.u128_get(filter_row, "account_id")
        ts_min = int(filter_row["timestamp_min"])
        ts_max = int(filter_row["timestamp_max"])
        limit = int(filter_row["limit"])
        flags = int(filter_row["flags"])
        reserved = bytes(filter_row["reserved"])

        valid = (
            account_id != 0
            and account_id != U128_MAX
            and ts_min != U64_MAX
            and ts_max != U64_MAX
            and (ts_max == 0 or ts_min <= ts_max)
            and limit != 0
            and (flags & (AccountFilterFlags.debits | AccountFilterFlags.credits))
            and not (flags & ~int(AccountFilterFlags._valid_mask))
            and reserved == b"\x00" * 24
        )
        if not valid:
            return None

        lo = TIMESTAMP_MIN if ts_min == 0 else ts_min
        hi = TIMESTAMP_MAX if ts_max == 0 else ts_max

        timestamps: list[int] = []
        if flags & AccountFilterFlags.debits:
            timestamps += [
                t for t in self.transfers_by_dr.get(account_id, []) if lo <= t <= hi
            ]
        if flags & AccountFilterFlags.credits:
            timestamps += [
                t for t in self.transfers_by_cr.get(account_id, []) if lo <= t <= hi
            ]
        timestamps.sort()
        if flags & AccountFilterFlags.reversed:
            timestamps.reverse()
        return timestamps

    def _execute_get_account_transfers(self, input_bytes: bytes) -> bytes:
        filter_row = np.frombuffer(input_bytes, dtype=ACCOUNT_FILTER_DTYPE)[0]
        timestamps = self._filter_scan(filter_row)
        if timestamps is None:
            return b""
        batch_max = self.config.batch_max(
            ACCOUNT_FILTER_DTYPE.itemsize, TRANSFER_DTYPE.itemsize
        )
        limit = min(int(filter_row["limit"]), batch_max)
        timestamps = timestamps[:limit]
        out = np.zeros(len(timestamps), dtype=TRANSFER_DTYPE)
        for i, ts in enumerate(timestamps):
            self.transfers[self.transfers_by_timestamp[ts]].to_np(out[i])
        return out.tobytes()

    def _execute_get_account_balances(self, input_bytes: bytes) -> bytes:
        filter_row = np.frombuffer(input_bytes, dtype=ACCOUNT_FILTER_DTYPE)[0]
        account_id = types.u128_get(filter_row, "account_id")
        account = self.accounts.get(account_id)
        # reference: src/state_machine.zig:858-902 — account must exist
        # and carry flags.history for the scan to run at all.
        if account is None or not (account.flags & AF.history):
            return b""
        timestamps = self._filter_scan(filter_row)
        if timestamps is None:
            return b""
        batch_max = self.config.batch_max(
            ACCOUNT_FILTER_DTYPE.itemsize, ACCOUNT_BALANCE_DTYPE.itemsize
        )
        limit = min(int(filter_row["limit"]), batch_max)
        timestamps = timestamps[:limit]

        out = np.zeros(len(timestamps), dtype=ACCOUNT_BALANCE_DTYPE)
        count = 0
        for ts in timestamps:
            b = self.account_balances[ts]
            row = out[count]
            if account_id == b.dr_account_id:
                types.u128_set(row, "debits_pending", b.dr_debits_pending)
                types.u128_set(row, "debits_posted", b.dr_debits_posted)
                types.u128_set(row, "credits_pending", b.dr_credits_pending)
                types.u128_set(row, "credits_posted", b.dr_credits_posted)
            elif account_id == b.cr_account_id:
                types.u128_set(row, "debits_pending", b.cr_debits_pending)
                types.u128_set(row, "debits_posted", b.cr_debits_posted)
                types.u128_set(row, "credits_pending", b.cr_credits_pending)
                types.u128_set(row, "credits_posted", b.cr_credits_posted)
            else:
                raise AssertionError("scan returned non-history transfer")
            row["timestamp"] = ts
            count += 1
        return out[:count].tobytes()

    # ------------------------------------------------------------------
    # Checkpoint snapshot (consumed by vsr.checkpointing).

    # prepare_timestamp is primary-only in-memory state (re-derived from
    # commit_timestamp on the next prepare), so it is NOT part of the
    # snapshot — backups never advance it and must still converge.
    # accounts_by_timestamp / transfers_by_timestamp are derived from
    # the row sets and rebuilt on restore.

    def snapshot(self) -> bytes:
        """Serialize all durable state to the fixed-layout binary
        snapshot codec (utils/snapshot.py) — NOT pickle (checkpoint
        blobs travel via state sync; decoding must be safe on
        untrusted bytes and stable across versions).

        Canonical: dict iteration order is commit-replay order, which
        is identical across replicas with identical op streams, and
        the set-backed expiry index is sorted — so equal states give
        byte-equal snapshots (the convergence checkers rely on it).
        """
        from tigerbeetle_tpu_torch.utils import snapshot as snapcodec

        def rows_u8(recs, dtype):
            arr = np.zeros(len(recs), dtype=dtype)
            for i, rec in enumerate(recs):
                rec.to_np(arr[i])
            return arr.view(np.uint8).reshape(len(recs), dtype.itemsize)

        def u128_pairs(values):
            arr = np.zeros((len(values), 2), np.uint64)
            for i, v in enumerate(values):
                arr[i, 0] = v & U64_MAX
                arr[i, 1] = v >> 64
            return arr

        def csr(index: dict[int, list[int]]):
            keys = u128_pairs(list(index))
            lens = np.array([len(v) for v in index.values()], np.uint64)
            flat = np.array(
                [ts for v in index.values() for ts in v], np.uint64
            )
            return {"keys": keys, "lens": lens, "values": flat}

        exp = sorted(self.expires_at_index)
        bal = self.account_balances
        state = {
            "commit_timestamp": self.commit_timestamp,
            "pulse_next_timestamp": self.pulse_next_timestamp,
            "accounts": rows_u8(list(self.accounts.values()), ACCOUNT_DTYPE),
            "transfers": rows_u8(
                list(self.transfers.values()), TRANSFER_DTYPE
            ),
            "by_dr": csr(self.transfers_by_dr),
            "by_cr": csr(self.transfers_by_cr),
            "expires_at": np.array(exp, np.uint64).reshape(len(exp), 2),
            "pending_ts": np.array(list(self.transfers_pending), np.uint64),
            "pending_status": np.array(
                [int(s) for s in self.transfers_pending.values()], np.uint8
            ),
            "balances_ts": np.array(list(bal), np.uint64),
            "balances": {
                f: u128_pairs([getattr(b, f) for b in bal.values()])
                for f in (
                    "dr_account_id", "dr_debits_pending", "dr_debits_posted",
                    "dr_credits_pending", "dr_credits_posted",
                    "cr_account_id", "cr_debits_pending", "cr_debits_posted",
                    "cr_credits_pending", "cr_credits_posted",
                )
            },
        }
        return snapcodec.encode_tree(state)

    def restore(self, data: bytes) -> None:
        from tigerbeetle_tpu_torch.utils import snapshot as snapcodec

        state = snapcodec.decode_tree(data)
        self.commit_timestamp = state["commit_timestamp"]
        self.pulse_next_timestamp = state["pulse_next_timestamp"]

        def recs_of(u8, dtype, cls):
            rows = np.ascontiguousarray(u8).view(dtype).reshape(-1)
            return [cls.from_np(rows[i]) for i in range(len(rows))]

        def uncsr(node) -> dict[int, list[int]]:
            out: dict[int, list[int]] = {}
            at = 0
            for i in range(len(node["keys"])):
                key = int(node["keys"][i, 0]) | (int(node["keys"][i, 1]) << 64)
                n = int(node["lens"][i])
                out[key] = [int(t) for t in node["values"][at : at + n]]
                at += n
            return out

        accounts = recs_of(state["accounts"], ACCOUNT_DTYPE, AccountRec)
        self.accounts = {a.id: a for a in accounts}
        self.accounts_by_timestamp = {a.timestamp: a.id for a in accounts}
        transfers = recs_of(state["transfers"], TRANSFER_DTYPE, TransferRec)
        self.transfers = {t.id: t for t in transfers}
        self.transfers_by_timestamp = {t.timestamp: t.id for t in transfers}
        self.transfers_by_dr = uncsr(state["by_dr"])
        self.transfers_by_cr = uncsr(state["by_cr"])
        self.expires_at_index = {
            (int(r[0]), int(r[1])) for r in state["expires_at"]
        }
        self.transfers_pending = {
            int(ts): TransferPendingStatus(int(s))
            for ts, s in zip(state["pending_ts"], state["pending_status"])
        }
        bal_fields = list(state["balances"])
        self.account_balances = {}
        for i, ts in enumerate(state["balances_ts"]):
            rec = BalanceRec(timestamp=int(ts))
            for f in bal_fields:
                pair = state["balances"][f][i]
                setattr(rec, f, int(pair[0]) | (int(pair[1]) << 64))
            self.account_balances[int(ts)] = rec
        self.prepare_timestamp = self.commit_timestamp
        self._undo = UndoLog()
        self._expiry_buffer = None

"""Single-node commit-pipeline harness + event builders.

This package's own copy of ``tigerbeetle_tpu/testing/harness.py``.

Drives a state machine through prepare -> prefetch -> commit the same
way the replica's commit dispatch does (reference:
src/vsr/replica.zig:5746-5844 for timestamping, :3766 for
prefetch_timestamp, :3126-3143 for pulse injection).
"""

from __future__ import annotations

import numpy as np

from tigerbeetle_tpu_torch import types
from tigerbeetle_tpu_torch.types import (
    ACCOUNT_DTYPE,
    TRANSFER_DTYPE,
    CreateAccountResult,
    CreateTransferResult,
    Operation,
)


def account(
    id: int,
    *,
    ledger: int = 1,
    code: int = 1,
    flags: int = 0,
    debits_pending: int = 0,
    debits_posted: int = 0,
    credits_pending: int = 0,
    credits_posted: int = 0,
    user_data_128: int = 0,
    user_data_64: int = 0,
    user_data_32: int = 0,
    reserved: int = 0,
    timestamp: int = 0,
) -> np.ndarray:
    """One Account event row (wire layout)."""
    row = np.zeros(1, dtype=ACCOUNT_DTYPE)[0]
    types.u128_set(row, "id", id)
    types.u128_set(row, "debits_pending", debits_pending)
    types.u128_set(row, "debits_posted", debits_posted)
    types.u128_set(row, "credits_pending", credits_pending)
    types.u128_set(row, "credits_posted", credits_posted)
    types.u128_set(row, "user_data_128", user_data_128)
    row["user_data_64"] = user_data_64
    row["user_data_32"] = user_data_32
    row["reserved"] = reserved
    row["ledger"] = ledger
    row["code"] = code
    row["flags"] = flags
    row["timestamp"] = timestamp
    return row


def transfer(
    id: int,
    *,
    debit_account_id: int = 0,
    credit_account_id: int = 0,
    amount: int = 0,
    pending_id: int = 0,
    user_data_128: int = 0,
    user_data_64: int = 0,
    user_data_32: int = 0,
    timeout: int = 0,
    ledger: int = 1,
    code: int = 1,
    flags: int = 0,
    timestamp: int = 0,
) -> np.ndarray:
    """One Transfer event row (wire layout)."""
    row = np.zeros(1, dtype=TRANSFER_DTYPE)[0]
    types.u128_set(row, "id", id)
    types.u128_set(row, "debit_account_id", debit_account_id)
    types.u128_set(row, "credit_account_id", credit_account_id)
    types.u128_set(row, "amount", amount)
    types.u128_set(row, "pending_id", pending_id)
    types.u128_set(row, "user_data_128", user_data_128)
    row["user_data_64"] = user_data_64
    row["user_data_32"] = user_data_32
    row["timeout"] = timeout
    row["ledger"] = ledger
    row["code"] = code
    row["flags"] = flags
    row["timestamp"] = timestamp
    return row


def pack(rows) -> bytes:
    """Stack event rows into a wire-format batch."""
    if isinstance(rows, np.ndarray) and rows.shape == ():
        rows = [rows]
    if isinstance(rows, (list, tuple)):
        if not rows:
            return b""
        arr = np.stack([np.asarray(r) for r in rows])
    else:
        arr = np.asarray(rows)
    return arr.tobytes()


def ids_bytes(ids: list[int]) -> bytes:
    arr = np.zeros(len(ids), dtype=types.U128_PAIR_DTYPE)
    for i, v in enumerate(ids):
        arr[i]["lo"] = v & types.U64_MAX
        arr[i]["hi"] = v >> 64
    return arr.tobytes()


class SingleNodeHarness:
    """Mimics the primary's prepare/commit loop around a state machine."""

    def __init__(self, state_machine) -> None:
        self.sm = state_machine
        self.op = 0
        self.realtime = 0

    def tick_pulses(self) -> None:
        """Inject pulse operations while the state machine asks for them
        (reference: src/vsr/replica.zig:3126-3143)."""
        while self.sm.pulse_needed():
            before = self.sm.pulse_next_timestamp
            self._run(Operation.pulse, b"")
            # A pulse that found nothing parks pulse_next_timestamp in
            # the future; avoid spinning forever otherwise.
            if self.sm.pulse_next_timestamp == before:
                break

    def _dispatch(self, operation: Operation, input_bytes: bytes):
        """Shared prepare/prefetch/commit prologue; returns the reply
        future (timestamping reference: src/vsr/replica.zig:5762-5772)."""
        self.sm.prepare_timestamp = max(
            max(self.sm.prepare_timestamp, self.sm.commit_timestamp) + 1,
            self.realtime,
        )
        self.sm.prepare(operation, input_bytes)
        timestamp = self.sm.prepare_timestamp
        self.op += 1
        self.sm.prefetch(operation, input_bytes, prefetch_timestamp=timestamp)
        if hasattr(self.sm, "commit_async"):
            return self.sm.commit_async(
                0, self.op, timestamp, operation, input_bytes
            )
        from tigerbeetle_tpu_torch.state_machine.device_engine import ReplyFuture

        return ReplyFuture(
            value=self.sm.commit(0, self.op, timestamp, operation, input_bytes)
        )

    def _run(self, operation: Operation, input_bytes: bytes) -> bytes:
        return self._dispatch(operation, input_bytes).result()

    def submit(
        self, operation: Operation, input_bytes: bytes, *, realtime: int | None = None
    ) -> bytes:
        return self.submit_async(
            operation, input_bytes, realtime=realtime
        ).result()

    def submit_async(
        self, operation: Operation, input_bytes: bytes, *, realtime: int | None = None
    ):
        """Pipelined submission: returns a reply future (resolved
        immediately for state machines without commit_async).  The
        device-engine path materializes replies in submission order at
        ring-fetch boundaries — the same pipelining the reference's
        async client drives (src/clients/c/tb_client/packet.zig)."""
        if realtime is not None:
            self.realtime = realtime
        if operation != Operation.pulse:
            self.tick_pulses()
        return self._dispatch(operation, input_bytes)

    # Convenience wrappers -------------------------------------------------

    def create_accounts(self, rows, **kw) -> list[tuple[int, CreateAccountResult]]:
        out = self.submit(Operation.create_accounts, pack(rows), **kw)
        arr = np.frombuffer(out, dtype=types.CREATE_RESULT_DTYPE)
        return [(int(r["index"]), CreateAccountResult(int(r["result"]))) for r in arr]

    def create_transfers(self, rows, **kw) -> list[tuple[int, CreateTransferResult]]:
        out = self.submit(Operation.create_transfers, pack(rows), **kw)
        arr = np.frombuffer(out, dtype=types.CREATE_RESULT_DTYPE)
        return [(int(r["index"]), CreateTransferResult(int(r["result"]))) for r in arr]

    def lookup_accounts(self, ids: list[int]) -> np.ndarray:
        out = self.submit(Operation.lookup_accounts, ids_bytes(ids))
        return np.frombuffer(out, dtype=ACCOUNT_DTYPE)

    def lookup_transfers(self, ids: list[int]) -> np.ndarray:
        out = self.submit(Operation.lookup_transfers, ids_bytes(ids))
        return np.frombuffer(out, dtype=TRANSFER_DTYPE)

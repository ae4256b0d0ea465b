"""Wire types, flags and result codes (the subset this port reads).

Byte-for-byte compatible with the reference ``extern struct`` layouts
(reference: src/tigerbeetle.zig:7-322); a u128 field is two
little-endian u64 limbs ``(lo, hi)``.  Kept as this package's own copy
of ``tigerbeetle_tpu/types.py`` so the port imports nothing from the
JAX package.
"""

from __future__ import annotations

import enum

import numpy as np

U128_MAX = (1 << 128) - 1
U64_MAX = (1 << 64) - 1
NS_PER_S = 1_000_000_000

# reference: src/lsm/timestamp_range.zig:4-5
TIMESTAMP_MIN = 1
TIMESTAMP_MAX = (1 << 64) - 2


def _u128(name: str) -> list[tuple[str, str]]:
    """A u128 field as two u64 limbs, little-endian (lo first)."""
    return [(f"{name}_lo", "<u8"), (f"{name}_hi", "<u8")]


# reference: src/tigerbeetle.zig:7-29 (Account, 128 bytes)
ACCOUNT_DTYPE = np.dtype(
    _u128("id")
    + _u128("debits_pending")
    + _u128("debits_posted")
    + _u128("credits_pending")
    + _u128("credits_posted")
    + _u128("user_data_128")
    + [
        ("user_data_64", "<u8"),
        ("user_data_32", "<u4"),
        ("reserved", "<u4"),
        ("ledger", "<u4"),
        ("code", "<u2"),
        ("flags", "<u2"),
        ("timestamp", "<u8"),
    ]
)

# reference: src/tigerbeetle.zig:80-111 (Transfer, 128 bytes)
TRANSFER_DTYPE = np.dtype(
    _u128("id")
    + _u128("debit_account_id")
    + _u128("credit_account_id")
    + _u128("amount")
    + _u128("pending_id")
    + _u128("user_data_128")
    + [
        ("user_data_64", "<u8"),
        ("user_data_32", "<u4"),
        ("timeout", "<u4"),
        ("ledger", "<u4"),
        ("code", "<u2"),
        ("flags", "<u2"),
        ("timestamp", "<u8"),
    ]
)

# reference: src/tigerbeetle.zig:65-78 (AccountBalance, 128 bytes)
ACCOUNT_BALANCE_DTYPE = np.dtype(
    _u128("debits_pending")
    + _u128("debits_posted")
    + _u128("credits_pending")
    + _u128("credits_posted")
    + [("timestamp", "<u8"), ("reserved", "u1", (56,))]
)

# reference: src/tigerbeetle.zig:288-307 (AccountFilter, 64 bytes)
ACCOUNT_FILTER_DTYPE = np.dtype(
    _u128("account_id")
    + [
        ("timestamp_min", "<u8"),
        ("timestamp_max", "<u8"),
        ("limit", "<u4"),
        ("flags", "<u4"),
        ("reserved", "u1", (24,)),
    ]
)

# reference: src/tigerbeetle.zig:267-285
CREATE_RESULT_DTYPE = np.dtype([("index", "<u4"), ("result", "<u4")])

# A bare u128 on the wire (lookup_accounts / lookup_transfers events).
U128_PAIR_DTYPE = np.dtype([("lo", "<u8"), ("hi", "<u8")])

assert ACCOUNT_DTYPE.itemsize == 128
assert TRANSFER_DTYPE.itemsize == 128
assert ACCOUNT_BALANCE_DTYPE.itemsize == 128
assert ACCOUNT_FILTER_DTYPE.itemsize == 64
assert CREATE_RESULT_DTYPE.itemsize == 8


class AccountFlags(enum.IntFlag):
    """reference: src/tigerbeetle.zig:42-63"""

    linked = 1 << 0
    debits_must_not_exceed_credits = 1 << 1
    credits_must_not_exceed_debits = 1 << 2
    history = 1 << 3


class TransferFlags(enum.IntFlag):
    """reference: src/tigerbeetle.zig:127-140"""

    linked = 1 << 0
    pending = 1 << 1
    post_pending_transfer = 1 << 2
    void_pending_transfer = 1 << 3
    balancing_debit = 1 << 4
    balancing_credit = 1 << 5


class TransferPendingStatus(enum.IntEnum):
    """reference: src/tigerbeetle.zig:113-125"""

    none = 0
    pending = 1
    posted = 2
    voided = 3
    expired = 4


class CreateAccountResult(enum.IntEnum):
    """reference: src/tigerbeetle.zig:145-180"""

    ok = 0
    linked_event_failed = 1
    linked_event_chain_open = 2
    timestamp_must_be_zero = 3
    reserved_field = 4
    reserved_flag = 5
    id_must_not_be_zero = 6
    id_must_not_be_int_max = 7
    flags_are_mutually_exclusive = 8
    debits_pending_must_be_zero = 9
    debits_posted_must_be_zero = 10
    credits_pending_must_be_zero = 11
    credits_posted_must_be_zero = 12
    ledger_must_not_be_zero = 13
    code_must_not_be_zero = 14
    exists_with_different_flags = 15
    exists_with_different_user_data_128 = 16
    exists_with_different_user_data_64 = 17
    exists_with_different_user_data_32 = 18
    exists_with_different_ledger = 19
    exists_with_different_code = 20
    exists = 21


class CreateTransferResult(enum.IntEnum):
    """reference: src/tigerbeetle.zig:185-265"""

    ok = 0
    linked_event_failed = 1
    linked_event_chain_open = 2
    timestamp_must_be_zero = 3
    reserved_flag = 4
    id_must_not_be_zero = 5
    id_must_not_be_int_max = 6
    flags_are_mutually_exclusive = 7
    debit_account_id_must_not_be_zero = 8
    debit_account_id_must_not_be_int_max = 9
    credit_account_id_must_not_be_zero = 10
    credit_account_id_must_not_be_int_max = 11
    accounts_must_be_different = 12
    pending_id_must_be_zero = 13
    pending_id_must_not_be_zero = 14
    pending_id_must_not_be_int_max = 15
    pending_id_must_be_different = 16
    timeout_reserved_for_pending_transfer = 17
    amount_must_not_be_zero = 18
    ledger_must_not_be_zero = 19
    code_must_not_be_zero = 20
    debit_account_not_found = 21
    credit_account_not_found = 22
    accounts_must_have_the_same_ledger = 23
    transfer_must_have_the_same_ledger_as_accounts = 24
    pending_transfer_not_found = 25
    pending_transfer_not_pending = 26
    pending_transfer_has_different_debit_account_id = 27
    pending_transfer_has_different_credit_account_id = 28
    pending_transfer_has_different_ledger = 29
    pending_transfer_has_different_code = 30
    exceeds_pending_transfer_amount = 31
    pending_transfer_has_different_amount = 32
    pending_transfer_already_posted = 33
    pending_transfer_already_voided = 34
    pending_transfer_expired = 35
    exists_with_different_flags = 36
    exists_with_different_debit_account_id = 37
    exists_with_different_credit_account_id = 38
    exists_with_different_amount = 39
    exists_with_different_pending_id = 40
    exists_with_different_user_data_128 = 41
    exists_with_different_user_data_64 = 42
    exists_with_different_user_data_32 = 43
    exists_with_different_timeout = 44
    exists_with_different_code = 45
    exists = 46
    overflows_debits_pending = 47
    overflows_credits_pending = 48
    overflows_debits_posted = 49
    overflows_credits_posted = 50
    overflows_debits = 51
    overflows_credits = 52
    overflows_timeout = 53
    exceeds_credits = 54
    exceeds_debits = 55


class Operation(enum.IntEnum):
    """reference: src/state_machine.zig:341-350, src/constants.zig:47"""

    pulse = 128
    create_accounts = 129
    create_transfers = 130
    lookup_accounts = 131
    lookup_transfers = 132
    get_account_transfers = 133
    get_account_balances = 134


# reference: src/state_machine.zig:503-525
EVENT_DTYPE = {
    Operation.pulse: None,
    Operation.create_accounts: ACCOUNT_DTYPE,
    Operation.create_transfers: TRANSFER_DTYPE,
    Operation.lookup_accounts: U128_PAIR_DTYPE,
    Operation.lookup_transfers: U128_PAIR_DTYPE,
    Operation.get_account_transfers: ACCOUNT_FILTER_DTYPE,
    Operation.get_account_balances: ACCOUNT_FILTER_DTYPE,
}

RESULT_DTYPE = {
    Operation.pulse: None,
    Operation.create_accounts: CREATE_RESULT_DTYPE,
    Operation.create_transfers: CREATE_RESULT_DTYPE,
    Operation.lookup_accounts: ACCOUNT_DTYPE,
    Operation.lookup_transfers: TRANSFER_DTYPE,
    Operation.get_account_transfers: TRANSFER_DTYPE,
    Operation.get_account_balances: ACCOUNT_BALANCE_DTYPE,
}


def u128_get(row: np.void, name: str) -> int:
    """Read a u128 field from a structured-array row as a Python int."""
    return int(row[f"{name}_lo"]) | (int(row[f"{name}_hi"]) << 64)


def u128_set(row: np.void, name: str, value: int) -> None:
    """Write a Python int into a u128 (lo, hi) field pair."""
    assert 0 <= value <= U128_MAX
    row[f"{name}_lo"] = value & U64_MAX
    row[f"{name}_hi"] = value >> 64

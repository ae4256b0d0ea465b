"""Wire types, flags and result codes (the subset this port reads).

Byte-for-byte compatible with the reference ``extern struct`` layouts
(reference: src/tigerbeetle.zig:7-322); a u128 field is two
little-endian u64 limbs ``(lo, hi)``.  Kept as this package's own copy
of ``tigerbeetle_tpu/types.py`` so the port imports nothing from the
JAX package.
"""

from __future__ import annotations

import enum
import hashlib

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

# reference: src/state_machine.zig:259-269 (TransferPending, 16 bytes)
TRANSFER_PENDING_DTYPE = np.dtype(
    [("timestamp", "<u8"), ("status", "u1"), ("padding", "u1", (7,))]
)

# reference: src/state_machine.zig:296-315 (AccountBalancesGrooveValue, 256 bytes)
ACCOUNT_BALANCES_GROOVE_DTYPE = np.dtype(
    _u128("dr_account_id")
    + _u128("dr_debits_pending")
    + _u128("dr_debits_posted")
    + _u128("dr_credits_pending")
    + _u128("dr_credits_posted")
    + _u128("cr_account_id")
    + _u128("cr_debits_pending")
    + _u128("cr_debits_posted")
    + _u128("cr_credits_pending")
    + _u128("cr_credits_posted")
    + [("timestamp", "<u8"), ("reserved", "u1", (88,))]
)

assert ACCOUNT_DTYPE.itemsize == 128
assert TRANSFER_DTYPE.itemsize == 128
assert ACCOUNT_BALANCE_DTYPE.itemsize == 128
assert ACCOUNT_FILTER_DTYPE.itemsize == 64
assert CREATE_RESULT_DTYPE.itemsize == 8
assert TRANSFER_PENDING_DTYPE.itemsize == 16
assert ACCOUNT_BALANCES_GROOVE_DTYPE.itemsize == 256


class AccountFlags(enum.IntFlag):
    """reference: src/tigerbeetle.zig:42-63"""

    linked = 1 << 0
    debits_must_not_exceed_credits = 1 << 1
    credits_must_not_exceed_debits = 1 << 2
    history = 1 << 3

    _valid_mask = (1 << 4) - 1


class TransferFlags(enum.IntFlag):
    """reference: src/tigerbeetle.zig:127-140"""

    linked = 1 << 0
    pending = 1 << 1
    post_pending_transfer = 1 << 2
    void_pending_transfer = 1 << 3
    balancing_debit = 1 << 4
    balancing_credit = 1 << 5

    _valid_mask = (1 << 6) - 1


class AccountFilterFlags(enum.IntFlag):
    """reference: src/tigerbeetle.zig:309-322"""

    debits = 1 << 0
    credits = 1 << 1
    reversed = 1 << 2

    _valid_mask = (1 << 3) - 1


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


class EngineState(enum.Enum):
    """Device-authoritative engine lifecycle
    (state_machine/device_engine.py):

    - ``healthy``: the device table is authoritative; semantic kernels
      compute result codes on the device.
    - ``degraded``: the device link was lost (fatal error or retry
      budget exhausted); the host mirror is authoritative and every
      request is served by the exact host engine, bit-identically.
    - ``repromoting``: a health probe succeeded and the engine is
      re-uploading the table from the mirror; it becomes healthy only
      after the checksum handshake passes.
    """

    healthy = "healthy"
    degraded = "degraded"
    repromoting = "repromoting"


class Operation(enum.IntEnum):
    """reference: src/state_machine.zig:341-350, src/constants.zig:47"""

    pulse = 128
    create_accounts = 129
    create_transfers = 130
    lookup_accounts = 131
    lookup_transfers = 132
    get_account_transfers = 133
    get_account_balances = 134


# Read-only operations: pure queries over committed state
# (CpuStateMachine.READ_OPERATIONS).
READ_OPERATIONS = frozenset({
    Operation.lookup_accounts,
    Operation.lookup_transfers,
    Operation.get_account_transfers,
    Operation.get_account_balances,
})

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



# ----------------------------------------------------------------------
# Account-range sharding (runtime/router.py).
#
# A multi-cluster deployment partitions the account space across N
# independent consensus groups; every layer that routes by account
# (router batch split, client hints, recovery scans, the VOPR's
# checkers) must agree on ONE deterministic mapping, so it lives here
# next to the wire types.

# Odd golden-ratio multiplier: a multiplicative mix so sequential
# account ids (the common allocation pattern) spread across shards
# instead of striping modulo N.
_SHARD_MIX = 0x9E3779B97F4A7C15


def shard_of_account(account_id: int, n_shards: int) -> int:
    """Deterministic account -> shard mapping.

    Pure function of (id, n_shards): every router incarnation, client,
    and checker derives the same placement with no directory service.
    """
    assert 0 <= account_id <= U128_MAX
    if n_shards <= 1:
        return 0
    lo = account_id & U64_MAX
    hi = account_id >> 64
    mixed = ((lo ^ hi) * _SHARD_MIX) & U64_MAX
    return int((mixed >> 32) % n_shards)


# Coordinator-owned ledger accounts (cross-shard 2PC): each shard holds
# one settlement account per ledger in a tagged id namespace that real
# clients must not allocate from.  A cross-shard transfer becomes a
# pending hold against the settlement account on each side; the
# coordinator posts or voids both.
COORD_ID_TAG = 0xC0 << 120
# Ledger-registry bookkeeping rides its own ledger so client-visible
# ledgers never see registry rows.
COORD_REGISTRY_LEDGER = 0xC0C0
# Registry accounts (per shard, fixed ids): a posted registry transfer
# whose AMOUNT is the ledger number records "this shard has a
# settlement account for ledger L" durably in the shard's own log —
# a restarted coordinator enumerates ledgers by scanning the registry
# account's transfers (get_account_transfers), with no local state.
COORD_REGISTRY_ACCOUNT = COORD_ID_TAG | (0xEE << 64)
COORD_REGISTRY_FUNDING = COORD_ID_TAG | (0xEF << 64)


def coord_account_id(ledger: int) -> int:
    """The settlement account id for `ledger` (same id on every shard;
    each shard's account table is independent)."""
    assert 0 < ledger <= 0xFFFFFFFF
    return COORD_ID_TAG | ledger


def is_coord_account(account_id: int) -> bool:
    return (account_id >> 120) == 0xC0


# Cross-shard 2PC leg tags, carried in the holds' user_data_64 so a
# recovery scan can reconstruct (tid, leg, peer shard) from the rows
# alone: (peer_shard << 8) | leg.
XLEG_DEBIT = 1  # client debit account -> settlement (debit shard)
XLEG_CREDIT = 2  # settlement -> client credit account (credit shard)


def xleg_tag(leg: int, peer_shard: int) -> int:
    assert leg in (XLEG_DEBIT, XLEG_CREDIT)
    return (peer_shard << 8) | leg


def xleg_untag(tag: int) -> tuple[int, int]:
    """-> (leg, peer_shard)."""
    return tag & 0xFF, tag >> 8


class XShardIds:
    """Deterministic derived transfer ids for one cross-shard transfer.

    The client's transfer id `tid` is the idempotency key; every 2PC
    artifact (the two holds, the post/void resolutions, the
    budget-violation compensation) derives its id from (tid, role) by
    hashing into the upper half of the u128 space.  Determinism is
    what makes the protocol crash-safe: a restarted coordinator
    re-derives the same ids, so re-driving any leg is deduplicated by
    the state machine's id-uniqueness (`exists`) instead of by
    coordinator-local state.
    """

    __slots__ = ("tid", "hold_debit", "hold_credit", "post_debit",
                 "post_credit", "void_debit", "void_credit", "comp")

    _ROLES = ("hold_debit", "hold_credit", "post_debit", "post_credit",
              "void_debit", "void_credit", "comp")

    def __init__(self, tid: int) -> None:
        self.tid = tid
        for role in self._ROLES:
            setattr(self, role, self._derive(tid, role))

    @staticmethod
    def _derive(tid: int, role: str) -> int:
        digest = hashlib.sha256(
            b"tb-xshard-2pc:" + role.encode() + b":"
            + tid.to_bytes(16, "little")
        ).digest()
        value = int.from_bytes(digest[:16], "little") | (1 << 127)
        if value == U128_MAX:  # id_must_not_be_int_max
            value -= 1
        return value



def u128_get(row: np.void, name: str) -> int:
    """Read a u128 field from a structured-array row as a Python int."""
    return int(row[f"{name}_lo"]) | (int(row[f"{name}_hi"]) << 64)


def u128_set(row: np.void, name: str, value: int) -> None:
    """Write a Python int into a u128 (lo, hi) field pair."""
    assert 0 <= value <= U128_MAX
    row[f"{name}_lo"] = value & U64_MAX
    row[f"{name}_hi"] = value >> 64

"""Device-resident semantic kernels: result codes computed on the GPU.

Counterpart of the order-free half of
``tigerbeetle_tpu/state_machine/device_kernels.py``.  The host packs
raw event columns, stateless byte predicates and join results into one
matrix per batch (``pack_base`` / ``pack_tight``); every decision — the
precedence ladder, the exact u128 sums, the all-or-nothing overflow
admission, the apply — happens on the device against the device-
resident tables, and each batch writes one fixed-size failure-sparse
summary row into a device ring that the host fetches once per window
(``unpack_summary``).

``orderfree`` is kernel K1 (``csrc/orderfree.cu``) on CUDA tensors and
its plain PyTorch version ``orderfree_plain`` on CPU tensors.  Tensors
hold u64 lanes as int64 and u32 columns as int32.  Unlike the
reference, which returns new arrays, K1 and its plain version update
the table and the ring IN PLACE (and return them).

``apply_deltas`` is kernel K4 (``csrc/apply_deltas.cu``), the
write-behind lane's modular adds, with its plain version
``apply_deltas_plain``.  Linked-chain and two-phase kernels are not
ported yet (ROADMAP).
"""

from __future__ import annotations

import numpy as np
import torch

from tigerbeetle_tpu_torch import envcheck, kernels
from tigerbeetle_tpu_torch.ops import u128
from tigerbeetle_tpu_torch.ops.u128 import MASK32, s64, shr
from tigerbeetle_tpu_torch.types import CreateTransferResult as CTR

# ---------------------------------------------------------------------------
# Batch geometry and packed layout (identical to the reference).

B = envcheck.dev_b()
SUMMARY_WORDS = 64
FAIL_CAP = SUMMARY_WORDS - 4   # failure entries per batch summary

# Summary flag bits (word [1]).
FLAG_OVERFLOW = 1 << 0     # balance-overflow admission failed
FLAG_CAP = 1 << 1          # more than FAIL_CAP failures
FLAG_PRECOND = 1 << 2      # kernel precondition (linked kernels)
ITERS_SHIFT = 16

# Packed input columns (u64 each, B rows).
COL_BITS = 0
COL_SLOTS = 1      # (dr_slot+1) u32 | (cr_slot+1) << 32 ; 0 = not found
COL_AMT_LO = 2
COL_AMT_HI = 3
COL_MISC = 4       # flags u16 | code u16 << 16 | ledger u32 << 32
COL_TIMEOUT = 5    # timeout u32 | (p_tgt+1) u32 << 32
N_COLS = 6

# COL_BITS bits (host-marshaled stateless predicates + join booleans).
BIT_TS_NONZERO = 1 << 0
BIT_ID_ZERO = 1 << 1
BIT_ID_MAX = 1 << 2
BIT_DR_ZERO = 1 << 3
BIT_DR_MAX = 1 << 4
BIT_CR_ZERO = 1 << 5
BIT_CR_MAX = 1 << 6
BIT_SAME_ACCT = 1 << 7
BIT_PEND_NONZERO = 1 << 8
BIT_PEND_MAX = 1 << 9
BIT_PEND_SELF = 1 << 10
BIT_E_FOUND = 1 << 11

# TransferFlags bits (reference: src/tigerbeetle.zig:127-140).
F_PENDING = 1 << 1
F_POST = 1 << 2
F_VOID = 1 << 3
F_BAL_DR = 1 << 4
F_BAL_CR = 1 << 5

NS_PER_S = 1_000_000_000

# Tight 20-byte/event format (B, 5) u32 for the dominant order-free
# class.  Host-proved facts: amount_hi == 0, amount_lo < 2^32,
# timeout == 0.  Word 0 packs the predicate bits (low 18), the 6
# transfer-flag bits, a code != 0 bit and a reserved-flags bit; words
# 1/2 are slot+1, word 3 the u32 amount, word 4 the ledger.
TIGHT_FLAGS_SHIFT = 18
TIGHT_CODE_BIT = 1 << 24
TIGHT_RESERVED_BIT = 1 << 25
N_COLS_TIGHT = 5

# K1's input formats.
MODE_FULL, MODE_LO, MODE_TIGHT = 0, 1, 2
KIND_MODE = {
    "orderfree": MODE_FULL,
    "orderfree_lo": MODE_LO,
    "orderfree_tight": MODE_TIGHT,
}
PK_SPEC = {
    "orderfree": (N_COLS, np.uint64),
    "orderfree_lo": (N_COLS, np.uint64),
    "orderfree_tight": (N_COLS_TIGHT, np.uint32),
}


# ---------------------------------------------------------------------------
# Plain PyTorch version of K1 (int64 lanes).


def _unpack(pk):
    """(B, 6) int64 packed matrix -> named int64 columns."""
    slots = pk[:, COL_SLOTS]
    misc = pk[:, COL_MISC]
    return {
        "bits": pk[:, COL_BITS],
        "dr_slot": (slots & MASK32) - 1,
        "cr_slot": shr(slots, 32) - 1,
        "amt_lo": pk[:, COL_AMT_LO],
        "amt_hi": pk[:, COL_AMT_HI],
        "flags": misc & 0xFFFF,
        "code": shr(misc, 16) & 0xFFFF,
        "ledger": shr(misc, 32),
        "timeout": pk[:, COL_TIMEOUT] & MASK32,
    }


def _unpack_tight(pk32):
    """(B, 5) int32 tight matrix -> the same named int64 columns."""
    w = pk32.to(torch.int64) & MASK32
    w0 = w[:, 0]
    zero = torch.zeros_like(w0)
    # The reserved-flag predicate rides flag bit 6: the ladder's
    # (flags & ~0x3F) != 0 check then fires exactly for it.
    flags = (shr(w0, TIGHT_FLAGS_SHIFT) & 0x3F) | torch.where(
        (w0 & TIGHT_RESERVED_BIT) != 0, 0x40, zero
    )
    return {
        "bits": w0,
        "dr_slot": w[:, 1] - 1,
        "cr_slot": w[:, 2] - 1,
        "amt_lo": w[:, 3],
        "amt_hi": zero,
        "flags": flags,
        "code": ((w0 & TIGHT_CODE_BIT) != 0).to(torch.int64),
        "ledger": w[:, 4],
        "timeout": zero,
    }


def _bit(bits, mask):
    return (bits & mask) != 0


def _static_ladder_normal(ev, meta, active):
    """Static precedence ladder for non-post/void transfers
    (reference: src/state_machine.zig:1465-1504); `meta` is the
    (A, 2) int32 device table [flags, ledger]."""
    bits = ev["bits"]
    flags = ev["flags"]
    A = meta.shape[0]
    dr_found = ev["dr_slot"] >= 0
    cr_found = ev["cr_slot"] >= 0
    ledger_of = meta[:, 1].to(torch.int64) & MASK32
    zero = torch.zeros_like(bits)
    dr_ledger = torch.where(dr_found, ledger_of[ev["dr_slot"].clamp(0, A - 1)], zero)
    cr_ledger = torch.where(cr_found, ledger_of[ev["cr_slot"].clamp(0, A - 1)], zero)
    not_pending = (flags & F_PENDING) == 0
    not_balancing = (flags & (F_BAL_DR | F_BAL_CR)) == 0
    amount_zero = (ev["amt_lo"] == 0) & (ev["amt_hi"] == 0)
    ladder = [
        (_bit(bits, BIT_TS_NONZERO), CTR.timestamp_must_be_zero),
        ((flags & ~0x3F) != 0, CTR.reserved_flag),
        (_bit(bits, BIT_ID_ZERO), CTR.id_must_not_be_zero),
        (_bit(bits, BIT_ID_MAX), CTR.id_must_not_be_int_max),
        (_bit(bits, BIT_DR_ZERO), CTR.debit_account_id_must_not_be_zero),
        (_bit(bits, BIT_DR_MAX), CTR.debit_account_id_must_not_be_int_max),
        (_bit(bits, BIT_CR_ZERO), CTR.credit_account_id_must_not_be_zero),
        (_bit(bits, BIT_CR_MAX), CTR.credit_account_id_must_not_be_int_max),
        (_bit(bits, BIT_SAME_ACCT), CTR.accounts_must_be_different),
        (_bit(bits, BIT_PEND_NONZERO), CTR.pending_id_must_be_zero),
        (not_pending & (ev["timeout"] != 0), CTR.timeout_reserved_for_pending_transfer),
        (not_balancing & amount_zero, CTR.amount_must_not_be_zero),
        (ev["ledger"] == 0, CTR.ledger_must_not_be_zero),
        (ev["code"] == 0, CTR.code_must_not_be_zero),
        (~dr_found, CTR.debit_account_not_found),
        (~cr_found, CTR.credit_account_not_found),
        (dr_ledger != cr_ledger, CTR.accounts_must_have_the_same_ledger),
        (ev["ledger"] != dr_ledger, CTR.transfer_must_have_the_same_ledger_as_accounts),
    ]
    r = torch.zeros(bits.shape, dtype=torch.int32, device=bits.device)
    for cond, code in reversed(ladder):  # first matching rung wins
        r = torch.where(cond, int(code), r)
    # Inactive (padding) rows: poisoned so they never apply.
    return torch.where(active, r, int(CTR.linked_event_failed))


def _accum_cols(ev, ok, A, lo_only):
    """Exact per-(touched slot, column) u128 sums of the ok events'
    amounts: 32-bit limbs summed in int64 lanes (below 2^46 for 2B
    rows), recombined with carries.  Returns (touched slots, d_lo,
    d_hi, limb_ov), the deltas (U, 4).  `lo_only` ignores the high
    amount limb, as the reference's lo_only specialization does."""
    is_pending = (ev["flags"] & F_PENDING) != 0
    slots = torch.cat([ev["dr_slot"], ev["cr_slot"]]).clamp(0, A - 1)
    cols = torch.cat(
        [torch.where(is_pending, 0, 1), torch.where(is_pending, 2, 3)]
    ).to(torch.int64)
    valid = torch.cat([ok, ok])
    amt_lo = torch.cat([ev["amt_lo"]] * 2)[valid]
    amt_hi = torch.cat([ev["amt_hi"]] * 2)[valid]
    if lo_only:
        amt_hi = torch.zeros_like(amt_hi)
    touched, inv = torch.unique(slots[valid], return_inverse=True)
    acc = torch.zeros((len(touched) * 4, 4), dtype=torch.int64, device=slots.device)
    acc.index_add_(0, inv * 4 + cols[valid], u128.limbs32(amt_lo, amt_hi))
    d_lo, d_hi, carry = u128.from_limbs32(acc.view(-1, 4, 4))
    return touched, d_lo, d_hi, carry != 0


def _admit_apply(table, touched, d_lo, d_hi, limb_ov):
    """Admission + apply over the touched rows: add the column deltas
    iff no column u128 add overflows and no account's combined dp+dpo /
    cp+cpo total overflows.  Returns the overflow flag (bool tensor).

    Touched rows only: equal to the reference's whole-table admission
    whenever no untouched row already overflows its totals (true of
    every reachable state) and equal to the host mirror's admission."""
    old = table[touched]
    (new_lo, new_hi), add_ov = u128.add(
        (old[:, 0::2], old[:, 1::2]), (d_lo, d_hi)
    )
    _, dr_tot_ov = u128.add(
        (new_lo[:, 0], new_hi[:, 0]), (new_lo[:, 1], new_hi[:, 1])
    )
    _, cr_tot_ov = u128.add(
        (new_lo[:, 2], new_hi[:, 2]), (new_lo[:, 3], new_hi[:, 3])
    )
    ov = limb_ov.any() | add_ov.any() | dr_tot_ov.any() | cr_tot_ov.any()
    new_rows = torch.stack([new_lo, new_hi], dim=-1).reshape(-1, 8)
    table[touched] = torch.where(ov, old, new_rows)
    return ov


def _summary(r, active, ov, last_applied):
    """Failure-sparse summary row: [n_fail, flags, last_applied+1,
    n_active, (idx << 32 | code) x FAIL_CAP] as (SUMMARY_WORDS,) int64."""
    fail = active & (r != 0)
    n_fail = fail.sum()
    idx = torch.nonzero(fail).flatten()[:FAIL_CAP]
    entries = torch.zeros(FAIL_CAP, dtype=torch.int64, device=r.device)
    entries[: len(idx)] = (idx << 32) | r[idx].to(torch.int64)
    flags = torch.where(ov, FLAG_OVERFLOW, 0) | torch.where(
        n_fail > FAIL_CAP, FLAG_CAP, 0
    )
    head = torch.stack([n_fail, flags, last_applied + 1, active.sum()])
    return torch.cat([head.to(torch.int64), entries])


def orderfree_plain(table, meta, ring, ring_at, pk, n, ts_base, mode=MODE_FULL,
                    scratch=None):
    """Plain PyTorch version of K1: one order-independent batch — full
    static ladder, overflows_timeout, exact sums, all-or-nothing
    overflow admission, apply, summary row — updating `table` and
    `ring[ring_at]` in place.  `scratch` is unused (orderfree's
    signature).

    Host routing guarantees (the class the reference's _orderfree
    takes): no linked/post/void/balancing flags, unique fresh ids, no
    limit/history accounts touched; the only dynamic codes are then the
    overflow family, excluded wholesale by the total-sum admission
    (reference: src/state_machine.zig:1531-1545), and overflows_timeout."""
    ev = _unpack_tight(pk) if mode == MODE_TIGHT else _unpack(pk)
    A = table.shape[0]
    iota = torch.arange(pk.shape[0], dtype=torch.int64, device=pk.device)
    active = iota < n
    r = _static_ladder_normal(ev, meta, active)

    ts_i = s64(ts_base) + iota
    expires = ts_i + ev["timeout"] * NS_PER_S
    ov_timeout = (ev["timeout"] != 0) & u128.ult(expires, ts_i)
    r = torch.where((r == 0) & ov_timeout, int(CTR.overflows_timeout), r)

    ok = active & (r == 0)
    touched, d_lo, d_hi, limb_ov = _accum_cols(ev, ok, A, mode != MODE_FULL)
    ov = _admit_apply(table, touched, d_lo, d_hi, limb_ov)
    last_applied = torch.where(ok, iota, -1).max()
    ring[ring_at] = _summary(r, active, ov, last_applied)
    return table, ring


# ---------------------------------------------------------------------------
# K1 wrapper.


class OrderfreeScratch:
    """Device scratch K1 reuses across launches: a per-slot index that
    rests at -1 (one int32 per table row: touched rows claim it and the
    apply launch returns it to -1, so no launch clears the whole
    table), and per-batch codes, touched-row list, limb accumulators,
    candidate rows and the two batch counters (resting at 0)."""

    def __init__(self, rows: int, batch: int, device) -> None:
        i32, i64 = torch.int32, torch.int64
        self.rows, self.batch = rows, batch
        self.slot_idx = torch.full((rows,), -1, dtype=i32, device=device)
        self.codes = torch.empty(batch, dtype=i32, device=device)
        self.touched = torch.empty(2 * batch, dtype=i32, device=device)
        self.acc = torch.empty((2 * batch, 16), dtype=i64, device=device)
        self.newrows = torch.empty((2 * batch, 8), dtype=i64, device=device)
        self.ctrl = torch.zeros(2, dtype=i32, device=device)

    def fits(self, rows: int, batch: int) -> bool:
        return self.rows == rows and self.batch >= batch


def _check_orderfree(table, meta, ring, ring_at, pk, n, mode):
    A = table.shape[0]
    if table.dtype != torch.int64 or table.shape != (A, 8) or A < 1:
        raise ValueError(f"table must be (A, 8) int64, got {tuple(table.shape)} {table.dtype}")
    if meta.dtype != torch.int32 or meta.shape != (A, 2):
        raise ValueError(f"meta must be (A, 2) int32, got {tuple(meta.shape)} {meta.dtype}")
    if ring.dtype != torch.int64 or ring.dim() != 2 or ring.shape[1] != SUMMARY_WORDS:
        raise ValueError(f"ring must be (R, {SUMMARY_WORDS}) int64")
    if not 0 <= ring_at < ring.shape[0]:
        raise ValueError(f"ring_at {ring_at} outside the ring")
    want = (N_COLS_TIGHT, torch.int32) if mode == MODE_TIGHT else (N_COLS, torch.int64)
    if pk.dim() != 2 or pk.shape[1] != want[0] or pk.dtype != want[1]:
        raise ValueError(f"pk must be (B, {want[0]}) {want[1]} for mode {mode}")
    if not 0 <= n <= pk.shape[0]:
        raise ValueError(f"n={n} outside [0, {pk.shape[0]}]")
    if A >= 1 << 31:
        raise ValueError("table rows must fit int32 slot indices")
    for t in (meta, ring, pk):
        if t.device != table.device:
            raise ValueError("tensors must share one device")
    for t in (table, meta, ring, pk):
        if not t.is_contiguous():
            raise ValueError("tensors must be contiguous")


def orderfree(table, meta, ring, ring_at, pk, n, ts_base, mode=MODE_FULL,
              scratch: OrderfreeScratch | None = None):
    """One order-free batch, in place on `table` and `ring[ring_at]`.
    CUDA tensors launch K1 (raising on any CUDA error); CPU tensors run
    orderfree_plain."""
    _check_orderfree(table, meta, ring, ring_at, pk, n, mode)
    if table.device.type == "cpu":
        return orderfree_plain(table, meta, ring, ring_at, pk, n, ts_base, mode)
    if scratch is None or not scratch.fits(table.shape[0], pk.shape[0]):
        scratch = OrderfreeScratch(table.shape[0], pk.shape[0], table.device)
    ring_row = ring.data_ptr() + ring_at * SUMMARY_WORDS * 8
    kernels.orderfree(
        table, meta, ring_row, pk, mode, int(n), int(ts_base) & ((1 << 64) - 1),
        scratch,
    )
    return table, ring


def run_window(kind, table, meta, ring, ring_at0, big, off, G, ns, tsb,
               scratch=None, fn=orderfree):
    """G same-kind batches back to back on one stream, no host sync:
    batch g reads big[off + g] with n = ns[off + g] and ts_base =
    tsb[off + g] (host arrays), and writes ring row (ring_at0 + g) % R
    — the counterpart of the reference's _scan_win_of (:1142)."""
    R = ring.shape[0]
    mode = KIND_MODE[kind]
    for g in range(G):
        fn(
            table, meta, ring, (ring_at0 + g) % R, big[off + g],
            int(ns[off + g]), int(tsb[off + g]), mode=mode, scratch=scratch,
        )
    return table, ring


# ---------------------------------------------------------------------------
# K4: the write-behind delta apply.


def apply_deltas_plain(table, packed):
    """Plain version of K4: table[slot, 2col:2col+2] += (lo, hi) mod
    2^128 for the unique (slot, col) entries of `packed` (4, K) int64
    rows [slot, col, delta_lo, delta_hi]; an entry with slot >= A (the
    reference's padding) or col >= 4 is dropped.  In place."""
    A = table.shape[0]
    slots, cols, d_lo, d_hi = packed
    keep = (slots >= 0) & (slots < A) & (cols >= 0) & (cols < 4)
    s, c = slots[keep], cols[keep] * 2
    old_lo, old_hi = table[s, c], table[s, c + 1]
    new_lo = old_lo + d_lo[keep]
    table[s, c] = new_lo
    table[s, c + 1] = old_hi + d_hi[keep] + u128.ult(new_lo, old_lo).to(torch.int64)
    return table


def apply_deltas(table, packed):
    """Apply one flush chunk in place.  CUDA tensors launch K4 (raising
    on any CUDA error); CPU tensors run apply_deltas_plain."""
    A = table.shape[0]
    if table.dtype != torch.int64 or table.dim() != 2 or table.shape[1] != 8 or A < 1:
        raise ValueError(f"table must be (A, 8) int64, got {tuple(table.shape)}")
    if packed.dtype != torch.int64 or packed.dim() != 2 or packed.shape[0] != 4:
        raise ValueError(f"packed must be (4, K) int64, got {tuple(packed.shape)}")
    if packed.device != table.device:
        raise ValueError("tensors must share one device")
    if not (table.is_contiguous() and packed.is_contiguous()):
        raise ValueError("tensors must be contiguous")
    if table.device.type == "cpu":
        return apply_deltas_plain(table, packed)
    if packed.shape[1]:
        kernels.apply_deltas(table, packed)
    return table


# ---------------------------------------------------------------------------
# Gathers and scatters (plain torch glue, as the reference left to XLA).


def lookup(table, slots):
    """Gather balance rows for lookup_accounts: slot < 0 -> zeros."""
    A = table.shape[0]
    rows = table[slots.clamp(0, A - 1)]
    return torch.where(slots[:, None] >= 0, rows, 0)


def meta_update(meta, slots, acct_flags, acct_ledger):
    """Write (flags, ledger) at `slots` in place; out-of-range slots are
    dropped (the reference's mode="drop")."""
    keep = (slots >= 0) & (slots < meta.shape[0])
    meta[slots[keep], 0] = acct_flags[keep]
    meta[slots[keep], 1] = acct_ledger[keep]
    return meta


# ---------------------------------------------------------------------------
# Host-side packing (wire decoding + stateless predicates + joins).


def _predicate_bits(dtype, n, id_lo, id_hi, dr_lo, dr_hi, cr_lo, cr_hi,
                    pend_lo, pend_hi, ts_nonzero):
    """The stateless wire predicates every packed format ships."""
    U64M = np.uint64(0xFFFFFFFFFFFFFFFF)
    bits = np.zeros(n, dtype)

    def setbit(mask, cond):
        np.bitwise_or(bits, np.where(cond, dtype(mask), dtype(0)), out=bits)

    setbit(BIT_TS_NONZERO, ts_nonzero)
    setbit(BIT_ID_ZERO, (id_lo == 0) & (id_hi == 0))
    setbit(BIT_ID_MAX, (id_lo == U64M) & (id_hi == U64M))
    setbit(BIT_DR_ZERO, (dr_lo == 0) & (dr_hi == 0))
    setbit(BIT_DR_MAX, (dr_lo == U64M) & (dr_hi == U64M))
    setbit(BIT_CR_ZERO, (cr_lo == 0) & (cr_hi == 0))
    setbit(BIT_CR_MAX, (cr_lo == U64M) & (cr_hi == U64M))
    setbit(BIT_SAME_ACCT, (dr_lo == cr_lo) & (dr_hi == cr_hi))
    setbit(BIT_PEND_NONZERO, (pend_lo != 0) | (pend_hi != 0))
    setbit(BIT_PEND_MAX, (pend_lo == U64M) & (pend_hi == U64M))
    setbit(BIT_PEND_SELF, (pend_lo == id_lo) & (pend_hi == id_hi))
    return bits


def pack_base(
    n, id_lo, id_hi, dr_lo, dr_hi, cr_lo, cr_hi, pend_lo, pend_hi,
    amount_lo, amount_hi, flags, ledger, code, timeout, ts_nonzero,
    dr_slot, cr_slot, e_found,
):
    """Packed (B, 6) u64 input matrix: wire decoding, stateless byte
    predicates and join results — no result-code decisions.  (The
    reference's two-phase join arguments, p_found / p_tgt / n_cols,
    arrive with the two-phase kernel.)"""
    pk = np.zeros((B, N_COLS), np.uint64)
    bits = _predicate_bits(
        np.uint64, n, id_lo, id_hi, dr_lo, dr_hi, cr_lo, cr_hi,
        pend_lo, pend_hi, ts_nonzero,
    )
    np.bitwise_or(
        bits, np.where(e_found, np.uint64(BIT_E_FOUND), np.uint64(0)), out=bits
    )
    pk[:n, COL_BITS] = bits
    pk[:n, COL_SLOTS] = (
        (dr_slot.astype(np.int64) + 1).astype(np.uint64)
        | ((cr_slot.astype(np.int64) + 1).astype(np.uint64) << np.uint64(32))
    )
    pk[:n, COL_AMT_LO] = amount_lo
    pk[:n, COL_AMT_HI] = amount_hi
    pk[:n, COL_MISC] = (
        flags.astype(np.uint64)
        | (code.astype(np.uint64) << np.uint64(16))
        | (ledger.astype(np.uint64) << np.uint64(32))
    )
    pk[:n, COL_TIMEOUT] = timeout.astype(np.uint64)
    return pk


def pack_tight(
    n, id_lo, id_hi, dr_lo, dr_hi, cr_lo, cr_hi, pend_lo, pend_hi,
    amount_lo, flags, ledger, code, ts_nonzero, dr_slot, cr_slot,
):
    """Tight (B, 5) u32 order-free input.  Caller-guaranteed facts:
    amount_hi == 0, amount_lo < 2^32, timeout == 0 for every event."""
    pk = np.zeros((B, N_COLS_TIGHT), np.uint32)
    bits = _predicate_bits(
        np.uint32, n, id_lo, id_hi, dr_lo, dr_hi, cr_lo, cr_hi,
        pend_lo, pend_hi, ts_nonzero,
    )
    np.bitwise_or(
        bits, np.where(code != 0, np.uint32(TIGHT_CODE_BIT), np.uint32(0)),
        out=bits,
    )
    np.bitwise_or(
        bits,
        np.where(
            (flags & ~np.uint32(0x3F)) != 0,
            np.uint32(TIGHT_RESERVED_BIT), np.uint32(0),
        ),
        out=bits,
    )
    np.bitwise_or(
        bits,
        (flags.astype(np.uint32) & np.uint32(0x3F))
        << np.uint32(TIGHT_FLAGS_SHIFT),
        out=bits,
    )
    pk[:n, 0] = bits
    pk[:n, 1] = (dr_slot.astype(np.int64) + 1).astype(np.uint32)
    pk[:n, 2] = (cr_slot.astype(np.int64) + 1).astype(np.uint32)
    pk[:n, 3] = amount_lo.astype(np.uint32)
    pk[:n, 4] = ledger
    return pk


def unpack_summary(row: np.ndarray) -> dict:
    """Decode one (SUMMARY_WORDS,) u64 summary row."""
    n_fail = int(row[0])
    flags = int(row[1])
    entries = row[4 : 4 + min(n_fail, FAIL_CAP)]
    idx = (entries >> np.uint64(32)).astype(np.int64)
    codes = (entries & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return {
        "n_fail": n_fail,
        "overflow": bool(flags & FLAG_OVERFLOW),
        "cap_exceeded": bool(flags & FLAG_CAP) or n_fail > FAIL_CAP,
        "precond": bool(flags & FLAG_PRECOND),
        "iters": flags >> ITERS_SHIFT,
        "last_applied": int(row[2]) - 1,
        "n_active": int(row[3]),
        "fail_idx": idx,
        "fail_codes": codes,
    }

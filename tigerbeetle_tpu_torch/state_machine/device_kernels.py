"""Device-resident semantic kernels: result codes computed on the GPU.

Counterpart of ``tigerbeetle_tpu/state_machine/device_kernels.py``.  The
host packs raw event columns, stateless byte predicates and join
results into one matrix per batch (``pack_base``, ``pack_tight``,
``pack_two_phase_ext``); every decision — the precedence ladders, the
exact u128 sums, the linked fixpoint, the two-phase winners, the
all-or-nothing overflow admission, the apply — happens on the device
against the device-resident tables, and each batch writes one
fixed-size failure-sparse summary row into a device ring that the host
fetches once per window (``unpack_summary``).

Three kernel families, one per batch class, each a wrapper that
launches its CUDA kernel on CUDA tensors and runs its plain PyTorch
version on CPU tensors:

- ``orderfree``: kernel K1 (``csrc/orderfree.cu``), ``orderfree_plain``;
- ``linked``: kernel K5 (``csrc/linked.cu``), ``linked_plain`` —
  linked chains over limit accounts;
- ``two_phase``: kernel K6 (``csrc/two_phase.cu``), ``two_phase_plain``
  — pending creates and post/void.

``KERNELS`` / ``PLAIN`` give each semantic kind's launcher.  Tensors
hold u64 lanes as int64 and u32 columns as int32.  Unlike the
reference, which returns new arrays, the kernels and their plain
versions update the table and the ring IN PLACE (and return them).

``apply_deltas`` is kernel K4 (``csrc/apply_deltas.cu``), the
write-behind lane's modular adds, with its plain version
``apply_deltas_plain``; ``tier_set_rows`` is kernel K10
(``csrc/tier.cu``), the tiered admission's row scatter; ``checksum`` is
kernel K11 (``csrc/checksum.cu``), the table digest of the integrity
compares.  Each has its plain version beside it.

Three launchers run K1, K5 and K6 over several batches: ``run_window``
(the engine's window, the reference's ``_scan_win_of``), ``scan_of``
(G batches of a resident stack, ``_scan_of``: ``scan_kernels``) and
``staged`` (one batch of a resident superbatch, ``_staged``: the five
``*_staged`` names).  Their batch indices follow ``dynamic_start``, the
reference's ``dynamic_slice`` rule.
"""

from __future__ import annotations

from functools import partial

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
# two-phase extension columns:
COL_TP_JOIN = 6    # p_flags u16 | p_code u16 << 16 | p_ledger u32 << 32
COL_TP_SLOTS = 7   # (p_dr_slot+1) u32 | (p_cr_slot+1) u32 << 32  (durable)
COL_TP_AMT_LO = 8  # durable target amount
COL_TP_AMT_HI = 9
COL_TP_REF = 10    # (tgt_ev+1) u32 | dstat_init u32 << 32
N_COLS_TP = 11

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
BIT_P_FOUND = 1 << 12
BIT_T_DR_SET = 1 << 13   # event names a debit account (pv ladder)
BIT_T_CR_SET = 1 << 14
BIT_DR_EQ_P = 1 << 15    # event dr id == target's dr id
BIT_CR_EQ_P = 1 << 16

# TransferFlags bits (reference: src/tigerbeetle.zig:127-140).
F_LINKED = 1 << 0
F_PENDING = 1 << 1
F_POST = 1 << 2
F_VOID = 1 << 3
F_BAL_DR = 1 << 4
F_BAL_CR = 1 << 5

# AccountFlags bits (reference: src/tigerbeetle.zig:42-63).
AF_DR_LIMIT = 1 << 1
AF_CR_LIMIT = 1 << 2

S_PENDING, S_POSTED, S_VOIDED, S_EXPIRED = 1, 2, 3, 4

NS_PER_S = 1_000_000_000
# u64-exactness bound of the linked fixpoint's sums (reference: :147).
U64_SAFE = 1 << 61

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
# Each semantic kind's variant flag: K1's input format, K5's `small`,
# K6's `lo_only` (the reference's jitted entry points, :1049-1055).
KIND_MODE = {
    "orderfree": MODE_FULL,
    "orderfree_lo": MODE_LO,
    "orderfree_tight": MODE_TIGHT,
    "linked": 0,
    "linked_small": 1,
    "two_phase": 0,
    "two_phase_lo": 1,
}
PK_SPEC = {
    "orderfree": (N_COLS, np.uint64),
    "orderfree_lo": (N_COLS, np.uint64),
    "orderfree_tight": (N_COLS_TIGHT, np.uint32),
    "linked": (N_COLS, np.uint64),
    "linked_small": (N_COLS, np.uint64),
    "two_phase": (N_COLS_TP, np.uint64),
    "two_phase_lo": (N_COLS_TP, np.uint64),
}


# ---------------------------------------------------------------------------
# Plain PyTorch version of K1 (int64 lanes).


def _unpack(pk):
    """(B, C) int64 packed matrix -> named int64 columns."""
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
        "p_tgt": shr(pk[:, COL_TIMEOUT], 32) - 1,
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
    # Inactive (padding) rows: poisoned so they never apply.
    return torch.where(active, _first_rung(ladder, bits), int(CTR.linked_event_failed))


def _first_rung(ladder, like):
    """The code of the first (cond, code) rung that holds, else 0."""
    r = torch.zeros(like.shape, dtype=torch.int32, device=like.device)
    for cond, code in reversed(ladder):
        r = torch.where(cond, int(code), r)
    return r


def _accum(slots, passes, A, lo_only):
    """Exact per-(touched slot, column) u128 sums for several passes
    over the same slot rows: 32-bit limbs summed in int64 lanes (below
    2^46 for 4B rows), recombined with carries.  `passes` holds
    (cols, amt_lo, amt_hi, valid) row tensors.  Returns (touched slots,
    [(d_lo, d_hi, limb_ov)] per pass), the deltas (U, 4) on the union of
    the passes' touched rows.  `lo_only` ignores the high amount limb,
    as the reference's lo_only specialization does (its high delta is
    the carry out of the low sums)."""
    slots = slots.clamp(0, A - 1)
    any_valid = passes[0][3]
    for p in passes[1:]:
        any_valid = any_valid | p[3]
    touched = torch.unique(slots[any_valid])
    out = []
    for cols, amt_lo, amt_hi, valid in passes:
        inv = torch.searchsorted(touched, slots[valid])
        lo = amt_lo[valid]
        hi = torch.zeros_like(lo) if lo_only else amt_hi[valid]
        acc = torch.zeros((len(touched) * 4, 4), dtype=torch.int64, device=slots.device)
        acc.index_add_(0, inv * 4 + cols[valid], u128.limbs32(lo, hi))
        d_lo, d_hi, carry = u128.from_limbs32(acc.view(-1, 4, 4))
        out.append((d_lo, d_hi, carry != 0))
    return touched, out


def _admit_rows(old, d_lo, d_hi, limb_ov):
    """(rows + deltas, overflow): any column u128 add, any account's
    combined dp+dpo / cp+cpo total, or a column sum past 2^128."""
    (new_lo, new_hi), add_ov = u128.add((old[:, 0::2], old[:, 1::2]), (d_lo, d_hi))
    _, dr_tot_ov = u128.add((new_lo[:, 0], new_hi[:, 0]), (new_lo[:, 1], new_hi[:, 1]))
    _, cr_tot_ov = u128.add((new_lo[:, 2], new_hi[:, 2]), (new_lo[:, 3], new_hi[:, 3]))
    ov = limb_ov.any() | add_ov.any() | dr_tot_ov.any() | cr_tot_ov.any()
    return torch.stack([new_lo, new_hi], dim=-1).reshape(-1, 8), ov


def _admit_apply(table, touched, d_lo, d_hi, limb_ov):
    """Admission + apply over the touched rows: add the column deltas
    iff nothing overflows.  Returns the overflow flag (bool tensor).

    Touched rows only: equal to the reference's whole-table admission
    whenever no untouched row already overflows its totals (true of
    every reachable state) and equal to the host mirror's admission."""
    old = table[touched]
    new_rows, ov = _admit_rows(old, d_lo, d_hi, limb_ov)
    table[touched] = torch.where(ov, old, new_rows)
    return ov


def _summary(r, active, flags, last_applied):
    """Failure-sparse summary row: [n_fail, flags, last_applied+1,
    n_active, (idx << 32 | code) x FAIL_CAP] as (SUMMARY_WORDS,) int64;
    FLAG_CAP joins `flags` when the failures outnumber the entries."""
    fail = active & (r != 0)
    n_fail = fail.sum()
    idx = torch.nonzero(fail).flatten()[:FAIL_CAP]
    entries = torch.zeros(FAIL_CAP, dtype=torch.int64, device=r.device)
    entries[: len(idx)] = (idx << 32) | r[idx].to(torch.int64)
    flags = flags | torch.where(n_fail > FAIL_CAP, FLAG_CAP, 0)
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
    is_pending = (ev["flags"] & F_PENDING) != 0
    cols = torch.cat([torch.where(is_pending, 0, 1), torch.where(is_pending, 2, 3)])
    touched, [(d_lo, d_hi, limb_ov)] = _accum(
        torch.cat([ev["dr_slot"], ev["cr_slot"]]),
        [(cols, torch.cat([ev["amt_lo"]] * 2), torch.cat([ev["amt_hi"]] * 2),
          torch.cat([ok, ok]))],
        A, mode != MODE_FULL,
    )
    ov = _admit_apply(table, touched, d_lo, d_hi, limb_ov)
    last_applied = torch.where(ok, iota, -1).max()
    ring[ring_at] = _summary(r, active, torch.where(ov, FLAG_OVERFLOW, 0), last_applied)
    return table, ring


# ---------------------------------------------------------------------------
# Plain PyTorch version of K5: the linked-chain kernel.


def _meta_flags(ev, meta, A):
    """Account flags of each event's debit and credit rows (0 when not
    found), as int64."""
    flags_of = meta[:, 0].to(torch.int64) & MASK32
    zero = torch.zeros_like(ev["bits"])
    dr = torch.where(ev["dr_slot"] >= 0, flags_of[ev["dr_slot"].clamp(0, A - 1)], zero)
    cr = torch.where(ev["cr_slot"] >= 0, flags_of[ev["cr_slot"].clamp(0, A - 1)], zero)
    return dr, cr


def _chains(linked):
    """Chain structure — maximal runs of linked events plus the event
    after them: (chain id, first event, last event) per event."""
    B = linked.shape[0]
    iota = torch.arange(B, dtype=torch.int64, device=linked.device)
    start = torch.ones(B, dtype=torch.bool, device=linked.device)
    start[1:] = ~linked[:-1]
    end = torch.ones_like(start)
    end[:-1] = start[1:]
    chain_id = torch.cumsum(start.to(torch.int64), 0) - 1
    first = torch.cummax(torch.where(start, iota, 0), 0).values
    last = torch.cummin(torch.where(end, iota, B - 1).flip(0), 0).values.flip(0)
    return chain_id, first, last


def _chain_state(pass_, active, first, last):
    """(applied_prefix, chain_ok) per event: no failure in the chain
    before and at the event / anywhere in the chain (reference
    chain_state, :622)."""
    fails = (~pass_ & active).to(torch.int64)
    F = torch.cumsum(fails, 0)
    base = (F - fails)[first]
    return F == base, F[last] == base


def _excl_prefix(v, small):
    """The reference's excl_prefix (:630): general, the u64 inclusive
    cumsum mod 2^64 minus v (its four 16-bit-piece cumsums are exact);
    small, ONE int32 cumsum of v's low 32 bits, wrapping, sign-extended
    to u64, minus v — so a wrong `small` pick (a wrapped host sum) gives
    the reference's bits, iteration count included."""
    if not small:
        return torch.cumsum(v, 0) - v
    lo = v & MASK32
    signed = lo - ((lo >> 31) << 32)           # the int32 value of the low limb
    cs = torch.cumsum(signed, 0)               # exact: |cs| < 2^45
    wrapped = ((cs + (1 << 31)) & MASK32) - (1 << 31)
    return wrapped - v


def linked_plain(table, meta, ring, ring_at, pk, n, ts_base, small=False, scratch=None):
    """Plain PyTorch version of K5 (reference: _linked, :473): a
    linked-chain batch of plain posted transfers, limit accounts
    allowed.  Static ladder, chain structure, the Jacobi fixpoint over
    per-account segmented prefix sums of the limit entries sorted by
    (slot, event), chain rollback codes, superset overflow admission,
    apply of the passing chains, summary row with the iteration count —
    updating `table` and `ring[ring_at]` in place.  `ts_base` and
    `scratch` are unused (the shared signature)."""
    ev = _unpack(pk)
    A = table.shape[0]
    B = pk.shape[0]
    dev = pk.device
    iota = torch.arange(B, dtype=torch.int64, device=dev)
    active = iota < n
    static = _static_ladder_normal(ev, meta, active)
    linked = active & ((ev["flags"] & F_LINKED) != 0)
    chain_id, first, last = _chains(linked)

    is_last = iota == (n - 1)
    code0 = torch.where(is_last & linked, int(CTR.linked_event_chain_open), static)
    static_ok = active & (code0 == 0)

    drc = ev["dr_slot"].clamp(0, A - 1)
    crc = ev["cr_slot"].clamp(0, A - 1)
    dr_flags, cr_flags = _meta_flags(ev, meta, A)
    LIM = AF_DR_LIMIT | AF_CR_LIMIT
    dlim = (dr_flags & AF_DR_LIMIT) != 0
    clim = (cr_flags & AF_CR_LIMIT) != 0

    # ---- preconditions (violations -> exact host fallback).
    ent_d = static_ok & ((dr_flags & LIM) != 0)
    ent_c = static_ok & ((cr_flags & LIM) != 0)
    rows = table[torch.unique(torch.cat([drc[ent_d], crc[ent_c]]))]
    precond = (
        (static_ok & (ev["amt_hi"] != 0)).any()
        | (rows[:, 1::2] != 0).any()
        | (~u128.ult(rows[:, 0::2], U64_SAFE)).any()
    )
    # The reference sums the contributions in float64 (:535-539); this
    # is the exact sum.  They can differ only when the exact total lies
    # within rounding (~2^25) of the bound 2^61; below 2^31 every float
    # partial sum is exact, so the small bound's bit is always equal.
    contrib = torch.where(static_ok, ev["amt_lo"], 0)
    sum_lo, sum_hi = (contrib & MASK32).sum(), shr(contrib, 32).sum()
    if small:
        precond = precond | (sum_hi > 0) | (sum_lo >= (1 << 31) - 1)
    else:
        precond = precond | (sum_hi + (sum_lo >> 32) >= U64_SAFE >> 32)

    # ---- limit entries sorted by (slot, event): the valid entries of
    # the reference's packed keys slot << 14 | event << 1 | side, whose
    # sentinel-padded tail never contributes.
    eslot2 = torch.cat([ev["dr_slot"], ev["cr_slot"]])
    side2 = torch.cat([torch.zeros_like(iota), torch.ones_like(iota)])
    key = (eslot2 << 14) | (torch.cat([iota, iota]) << 1) | side2
    key_s = torch.sort(key[torch.cat([ent_d, ent_c])]).values
    V = key_s.shape[0]
    evs = (key_s >> 1) & (B - 1)
    eslot = key_s >> 14
    edeb = (key_s & 1) == 0
    eamt = ev["amt_lo"][evs]
    jpos = torch.arange(V, dtype=torch.int64, device=dev)
    seg_new = torch.ones(V, dtype=torch.bool, device=dev)
    seg_new[1:] = eslot[1:] != eslot[:-1]
    seg_first = torch.cummax(torch.where(seg_new, jpos, 0), 0).values if V else jpos
    bpos = torch.searchsorted(key_s, (eslot << 14) | (first[evs] << 1))
    rows_s = table[eslot]
    need_d = rows_s[:, 0] + rows_s[:, 2]      # dp + dpo
    have_d = rows_s[:, 6]                     # cpo
    need_c = rows_s[:, 4] + rows_s[:, 6]      # cp + cpo
    have_c = rows_s[:, 2]                     # dpo
    view_d = edeb & dlim[evs]
    view_c = ~edeb & clim[evs]
    amt_d = torch.where(edeb, eamt, 0)
    amt_c = torch.where(~edeb, eamt, 0)

    def body(pass_prev):
        applied_prefix, chain_ok = _chain_state(pass_prev, active, first, last)
        wce, wie = chain_ok[evs], applied_prefix[evs]
        Pdc = _excl_prefix(torch.where(wce, amt_d, 0), small)
        Pcc = _excl_prefix(torch.where(wce, amt_c, 0), small)
        Pdi = _excl_prefix(torch.where(wie, amt_d, 0), small)
        Pci = _excl_prefix(torch.where(wie, amt_c, 0), small)
        deb = (Pdc[bpos] - Pdc[seg_first]) + (Pdi[jpos] - Pdi[bpos])
        cred = (Pcc[bpos] - Pcc[seg_first]) + (Pci[jpos] - Pci[bpos])
        bad_d = view_d & u128.ult(have_d + cred, need_d + deb + eamt)
        bad_c = view_c & u128.ult(have_c + deb, need_c + cred + eamt)
        dr_fail = torch.zeros(B, dtype=torch.bool, device=dev)
        cr_fail = torch.zeros(B, dtype=torch.bool, device=dev)
        dr_fail[evs[bad_d]] = True
        cr_fail[evs[bad_c]] = True
        return static_ok & ~dr_fail & ~cr_fail, dr_fail

    # One unconditional iteration, then to convergence or 64 (:698-704).
    pass_, dr_fail = body(static_ok)
    iters = 1
    conv = torch.equal(pass_, static_ok)
    while not conv and iters < 64:
        prev = pass_
        pass_, dr_fail = body(prev)
        iters += 1
        conv = torch.equal(pass_, prev)
    applied_prefix, chain_ok = _chain_state(pass_, active, first, last)

    # ---- result codes.
    member_bad = ~chain_ok & active
    fail_pos = torch.where(active & ~pass_, iota, B)
    first_fail = torch.full((B,), B, dtype=torch.int64, device=dev).scatter_reduce(
        0, chain_id, fail_pos, "amin"
    )
    own = torch.where(
        code0 != 0, code0,
        torch.where(dr_fail, int(CTR.exceeds_credits), int(CTR.exceeds_debits)).to(torch.int32),
    )
    results = torch.where(member_bad, int(CTR.linked_event_failed), 0).to(torch.int32)
    results = torch.where(member_bad & (iota == first_fail[chain_id]), own, results)
    results = torch.where(
        is_last & linked & member_bad, int(CTR.linked_event_chain_open), results
    )

    # ---- superset admission (every static_ok event) and apply (the
    # members of passing chains), posted columns, low limbs only.
    okev = active & (results == 0)
    cols = torch.cat([torch.ones_like(iota), torch.full_like(iota, 3)])
    amt_lo2, amt_hi2 = torch.cat([ev["amt_lo"]] * 2), torch.cat([ev["amt_hi"]] * 2)
    touched, [sup, app] = _accum(
        eslot2,
        [(cols, amt_lo2, amt_hi2, torch.cat([static_ok, static_ok])),
         (cols, amt_lo2, amt_hi2, torch.cat([okev, okev]))],
        A, True,
    )
    old = table[touched]
    _, sup_ov = _admit_rows(old, *sup)
    new_rows, app_ov = _admit_rows(old, *app)
    keep = sup_ov | precond | (not conv) | app_ov
    table[touched] = torch.where(keep, old, new_rows)

    last_applied = torch.where(applied_prefix & active, iota, -1).max()
    flags = (
        torch.where(sup_ov, FLAG_OVERFLOW, 0)
        | torch.where(precond | (not conv), FLAG_PRECOND, 0)
        | (iters << ITERS_SHIFT)
    )
    ring[ring_at] = _summary(results, active, flags, last_applied)
    return table, ring


# ---------------------------------------------------------------------------
# Plain PyTorch version of K6: the two-phase kernel.


def _gt128(a_lo, a_hi, b_lo, b_hi):
    return u128.gt((a_lo, a_hi), (b_lo, b_hi))


def two_phase_plain(table, meta, ring, ring_at, pk, n, ts_base, lo_only=False,
                    scratch=None):
    """Plain PyTorch version of K6 (reference: _two_phase, :770): a
    pending-create + post/void batch with balance-independent verdicts.
    Static ladders (normal for creates, the pv prefix for post/void),
    the pv ladder against an in-batch or durable target, the first-wins
    winner per target, then adds and releases in one accumulation: the
    releases apply to the table after the adds, and an overflow or an
    underflow keeps the table and sets FLAG_OVERFLOW.  In place on
    `table` and `ring[ring_at]`; `ts_base` and `scratch` are unused."""
    ev = _unpack(pk)
    A = table.shape[0]
    B = pk.shape[0]
    dev = pk.device
    iota = torch.arange(B, dtype=torch.int64, device=dev)
    active = iota < n
    bits = ev["bits"]
    flags = ev["flags"]
    is_pv = (flags & (F_POST | F_VOID)) != 0
    pend_flag = (flags & F_PENDING) != 0
    post = (flags & F_POST) != 0
    void = (flags & F_VOID) != 0

    # --- static ladders.
    static_n = _static_ladder_normal(ev, meta, active)
    pv_excl = (post & void) | (is_pv & (flags & (F_PENDING | F_BAL_DR | F_BAL_CR) != 0))
    static_pv = _first_rung([
        (_bit(bits, BIT_TS_NONZERO), CTR.timestamp_must_be_zero),
        ((flags & ~0x3F) != 0, CTR.reserved_flag),
        (_bit(bits, BIT_ID_ZERO), CTR.id_must_not_be_zero),
        (_bit(bits, BIT_ID_MAX), CTR.id_must_not_be_int_max),
        (pv_excl, CTR.flags_are_mutually_exclusive),
        (~_bit(bits, BIT_PEND_NONZERO), CTR.pending_id_must_not_be_zero),
        (_bit(bits, BIT_PEND_MAX), CTR.pending_id_must_not_be_int_max),
        (_bit(bits, BIT_PEND_SELF), CTR.pending_id_must_be_different),
        (ev["timeout"] != 0, CTR.timeout_reserved_for_pending_transfer),
    ], bits)
    static_pv = torch.where(active, static_pv, int(CTR.linked_event_failed))
    code = torch.where(is_pv, static_pv, static_n)

    # --- the target: in-batch creator or durable join.
    tp_join = pk[:, COL_TP_JOIN]
    tp_slots = pk[:, COL_TP_SLOTS]
    tp_ref = pk[:, COL_TP_REF]
    tgt_ev = (tp_ref & MASK32) - 1
    dstat_init = shr(tp_ref, 32)
    pv = is_pv & (code == 0)
    tgt_c = tgt_ev.clamp(0, B - 1)
    in_batch = pv & (tgt_ev >= 0) & (tgt_ev < iota)
    tgt_created = in_batch & (code[tgt_c] == 0)
    durable = pv & _bit(bits, BIT_P_FOUND) & ~in_batch
    found = tgt_created | durable

    def pick(in_batch_col, durable_col):
        return torch.where(in_batch, in_batch_col[tgt_c], durable_col)

    p_flags = pick(flags, tp_join & 0xFFFF)
    p_ledger = pick(ev["ledger"], shr(tp_join, 32))
    p_code = pick(ev["code"], shr(tp_join, 16) & 0xFFFF)
    p_amt_lo = pick(ev["amt_lo"], pk[:, COL_TP_AMT_LO])
    p_amt_hi = pick(ev["amt_hi"], pk[:, COL_TP_AMT_HI])
    t_amt_set = (ev["amt_lo"] != 0) | (ev["amt_hi"] != 0)
    res_lo = torch.where(t_amt_set, ev["amt_lo"], p_amt_lo)
    res_hi = torch.where(t_amt_set, ev["amt_hi"], p_amt_hi)
    dstat = torch.where(durable, dstat_init, S_PENDING)

    # --- the pv ladder, rung by rung: each applies while the code is 0.
    for cond, c in (
        (pv & ~found, CTR.pending_transfer_not_found),
        (found & ((p_flags & F_PENDING) == 0), CTR.pending_transfer_not_pending),
        (found & _bit(bits, BIT_T_DR_SET) & ~_bit(bits, BIT_DR_EQ_P),
         CTR.pending_transfer_has_different_debit_account_id),
        (found & _bit(bits, BIT_T_CR_SET) & ~_bit(bits, BIT_CR_EQ_P),
         CTR.pending_transfer_has_different_credit_account_id),
        (found & (ev["ledger"] > 0) & (ev["ledger"] != p_ledger),
         CTR.pending_transfer_has_different_ledger),
        (found & (ev["code"] > 0) & (ev["code"] != p_code),
         CTR.pending_transfer_has_different_code),
        (found & _gt128(res_lo, res_hi, p_amt_lo, p_amt_hi),
         CTR.exceeds_pending_transfer_amount),
        (found & void & _gt128(p_amt_lo, p_amt_hi, res_lo, res_hi),
         CTR.pending_transfer_has_different_amount),
        (durable & (dstat == S_POSTED), CTR.pending_transfer_already_posted),
        (durable & (dstat == S_VOIDED), CTR.pending_transfer_already_voided),
        (durable & (dstat == S_EXPIRED), CTR.pending_transfer_expired),
    ):
        code = torch.where((code == 0) & cond & is_pv, int(c), code)

    # --- first-wins winner per target: segment keys are the in-batch
    # target event, B + the durable target index, 2B for the rest.
    cand = pv & (code == 0)
    tkey = torch.where(
        cand, torch.where(in_batch, tgt_c, B + ev["p_tgt"].clamp(0, B - 1)), 2 * B
    )
    first_idx = torch.full((2 * B + 1,), B, dtype=torch.int64, device=dev).scatter_reduce(
        0, tkey, torch.where(cand, iota, B), "amin"
    )[tkey]
    winner = cand & (iota == first_idx)
    win_ev = first_idx.clamp(0, B - 1)
    code = torch.where(
        cand & ~winner,
        torch.where(post[win_ev], int(CTR.pending_transfer_already_posted),
                    int(CTR.pending_transfer_already_voided)).to(torch.int32),
        code,
    )
    ok = active & (code == 0)

    # --- adds and releases over 4B rows [dr, cr, p_dr, p_cr]: pending
    # -> dp/cp and plain -> dpo/cpo at the event's rows, a winning post
    # -> dpo/cpo at the target's rows; winners release the pending
    # amount from dp/cp at the target's rows.
    p_drs = pick(ev["dr_slot"], (tp_slots & MASK32) - 1)
    p_crs = pick(ev["cr_slot"], shr(tp_slots, 32) - 1)
    created = ok & (pend_flag | ~is_pv)
    post_win = ok & winner & post
    win = ok & winner
    zeros, none = torch.zeros_like(iota), torch.zeros_like(active)
    touched, [(d_lo, d_hi, add_ov), (s_lo, s_hi, sub_ov)] = _accum(
        torch.cat([ev["dr_slot"], ev["cr_slot"], p_drs, p_crs]),
        [
            (torch.cat([torch.where(pend_flag, 0, 1), torch.where(pend_flag, 2, 3),
                        torch.ones_like(iota), torch.full_like(iota, 3)]),
             torch.cat([ev["amt_lo"], ev["amt_lo"], res_lo, res_lo]),
             torch.cat([ev["amt_hi"], ev["amt_hi"], res_hi, res_hi]),
             torch.cat([created, created, post_win, post_win])),
            (torch.cat([zeros, zeros, zeros, torch.full_like(iota, 2)]),
             torch.cat([p_amt_lo] * 4), torch.cat([p_amt_hi] * 4),
             torch.cat([none, none, win, win])),
        ],
        A, lo_only,
    )
    old = table[touched]
    added, ov = _admit_rows(old, d_lo, d_hi, add_ov)
    mid = torch.where(ov, old, added)
    (f_lo, f_hi), under = u128.sub((mid[:, 0::2], mid[:, 1::2]), (s_lo, s_hi))
    fallback = ov | sub_ov.any() | under.any()
    final = torch.stack([f_lo, f_hi], dim=-1).reshape(-1, 8)
    table[touched] = torch.where(fallback, old, final)

    last_applied = torch.where(ok, iota, -1).max()
    ring[ring_at] = _summary(code, active, torch.where(fallback, FLAG_OVERFLOW, 0), last_applied)
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
        # A launch touches slot_idx only below its table's row count,
        # so a scratch made for more rows serves a smaller (compact)
        # table too.
        return self.rows >= rows and self.batch >= batch


def _check_batch(table, meta, ring, ring_at, pk, n, want):
    """Raise on what the kernels do not take; `want` is pk's (columns,
    dtype)."""
    A = table.shape[0]
    if table.dtype != torch.int64 or table.shape != (A, 8) or A < 1:
        raise ValueError(f"table must be (A, 8) int64, got {tuple(table.shape)} {table.dtype}")
    if meta.dtype != torch.int32 or meta.shape != (A, 2):
        raise ValueError(f"meta must be (A, 2) int32, got {tuple(meta.shape)} {meta.dtype}")
    if ring.dtype != torch.int64 or ring.dim() != 2 or ring.shape[1] != SUMMARY_WORDS:
        raise ValueError(f"ring must be (R, {SUMMARY_WORDS}) int64")
    if not 0 <= ring_at < ring.shape[0]:
        raise ValueError(f"ring_at {ring_at} outside the ring")
    if pk.dim() != 2 or pk.shape[1] != want[0] or pk.dtype != want[1]:
        raise ValueError(f"pk must be (B, {want[0]}) {want[1]}")
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


def _ring_row(ring, ring_at) -> int:
    return ring.data_ptr() + ring_at * SUMMARY_WORDS * 8


def orderfree(table, meta, ring, ring_at, pk, n, ts_base, mode=MODE_FULL,
              scratch: OrderfreeScratch | None = None, count_as: str = "orderfree"):
    """One order-free batch, in place on `table` and `ring[ring_at]`.
    CUDA tensors launch K1 (raising on any CUDA error), counted in
    kernels.launches[count_as]; CPU tensors run orderfree_plain."""
    want = (N_COLS_TIGHT, torch.int32) if mode == MODE_TIGHT else (N_COLS, torch.int64)
    _check_batch(table, meta, ring, ring_at, pk, n, want)
    if table.device.type == "cpu":
        return orderfree_plain(table, meta, ring, ring_at, pk, n, ts_base, mode)
    if scratch is None or not scratch.fits(table.shape[0], pk.shape[0]):
        scratch = OrderfreeScratch(table.shape[0], pk.shape[0], table.device)
    kernels.orderfree(
        table, meta, _ring_row(ring, ring_at), pk, mode, int(n),
        int(ts_base) & ((1 << 64) - 1), scratch, count_as,
    )
    return table, ring


# ---------------------------------------------------------------------------
# K5 and K6 wrappers.


class WordScratch:
    """Device scratch K5 or K6 reuses across launches: the per-slot
    index that rests at -1 (as K1's) and one zeroed u64 word buffer
    holding the kernel's per-event, per-entry and per-row arrays (its
    layout, and which words rest at zero between launches, are the
    kernel source's; the library reports the size)."""

    def __init__(self, kernel: str, rows: int, batch: int, device) -> None:
        self.rows, self.batch = rows, batch
        self.slot_idx = torch.full((rows,), -1, dtype=torch.int32, device=device)
        self.words = torch.zeros(
            kernels.scratch_words(kernel, batch), dtype=torch.int64, device=device
        )

    def fits(self, rows: int, batch: int) -> bool:
        return self.rows >= rows and self.batch == batch


def linked(table, meta, ring, ring_at, pk, n, ts_base, small=False,
           scratch: WordScratch | None = None, count_as: str = "linked"):
    """One linked-chain batch, in place on `table` and `ring[ring_at]`.
    CUDA tensors launch K5 (raising on any CUDA error), counted in
    kernels.launches[count_as]; CPU tensors run linked_plain."""
    _check_batch(table, meta, ring, ring_at, pk, n, (N_COLS, torch.int64))
    if pk.shape[0] > 8192:
        raise ValueError("the linked kernel packs events into 13 key bits: B <= 8192")
    if table.device.type == "cpu":
        return linked_plain(table, meta, ring, ring_at, pk, n, ts_base, small)
    if scratch is None or not scratch.fits(table.shape[0], pk.shape[0]):
        scratch = WordScratch("linked", table.shape[0], pk.shape[0], table.device)
    kernels.linked(table, meta, _ring_row(ring, ring_at), pk, int(n), bool(small), scratch,
                   count_as)
    return table, ring


def two_phase(table, meta, ring, ring_at, pk, n, ts_base, lo_only=False,
              scratch: WordScratch | None = None, count_as: str = "two_phase"):
    """One pending-create + post/void batch, in place on `table` and
    `ring[ring_at]`.  CUDA tensors launch K6 (raising on any CUDA
    error), counted in kernels.launches[count_as]; CPU tensors run
    two_phase_plain."""
    _check_batch(table, meta, ring, ring_at, pk, n, (N_COLS_TP, torch.int64))
    if table.device.type == "cpu":
        return two_phase_plain(table, meta, ring, ring_at, pk, n, ts_base, lo_only)
    if scratch is None or not scratch.fits(table.shape[0], pk.shape[0]):
        scratch = WordScratch("two_phase", table.shape[0], pk.shape[0], table.device)
    kernels.two_phase(table, meta, _ring_row(ring, ring_at), pk, int(n), bool(lo_only), scratch,
                      count_as)
    return table, ring


# Each semantic kind's kernel family (which also names its scratch) and
# the keyword its KIND_MODE value goes to.
FAMILY = {
    "orderfree": "orderfree", "orderfree_lo": "orderfree", "orderfree_tight": "orderfree",
    "linked": "linked", "linked_small": "linked",
    "two_phase": "two_phase", "two_phase_lo": "two_phase",
}
_VARIANT = {"orderfree": "mode", "linked": "small", "two_phase": "lo_only"}


def _launchers(fns):
    """Each kind's launcher, (table, meta, ring, ring_at, pk, n, ts_base,
    scratch=), from one function per family."""
    return {
        kind: partial(fns[fam], **{_VARIANT[fam]: KIND_MODE[kind]})
        for kind, fam in FAMILY.items()
    }


KERNELS = _launchers({"orderfree": orderfree, "linked": linked, "two_phase": two_phase})
PLAIN = _launchers(
    {"orderfree": orderfree_plain, "linked": linked_plain, "two_phase": two_phase_plain}
)


def new_scratch(family: str, rows: int, device):
    """The scratch of one kernel family for a `rows`-row table."""
    if family == "orderfree":
        return OrderfreeScratch(rows, B, device)
    return WordScratch(family, rows, B, device)


def dynamic_start(start: int, extent: int, size: int) -> int:
    """The first index lax.dynamic_slice reads when it takes `size`
    entries from `start` along an axis of `extent`: a negative start
    wraps once (start + extent, as Python indexing), then clamps into
    [0, extent - size], so the slice always lies inside the axis.  The
    rule of the reference's window and superbatch reads
    (device_kernels.py:1146-1150, :1181)."""
    if size > extent:
        raise ValueError(f"a slice of {size} does not fit an axis of {extent}")
    if start < 0:
        start += extent
    return min(max(start, 0), extent - size)


def _host(a) -> np.ndarray:
    """A launcher's per-batch scalars as one host array: a tensor (on
    the card too) is copied once per call, never read once per batch."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _launcher(kind: str, plain: bool, count_as: str):
    if plain:
        return PLAIN[kind]
    return partial(KERNELS[kind], count_as=count_as)


def run_window(kind, table, meta, ring, ring_at0, big, off, G, ns, tsb,
               scratch=None, fn=None):
    """G same-kind batches back to back on one stream, no host sync:
    batch g reads big[off + g] with n = ns[off + g] and ts_base =
    tsb[off + g] (host arrays; each index taken by dynamic_start, as
    the reference's dynamic_slice takes it), and writes ring row
    (ring_at0 + g) % R — the counterpart of the reference's
    _scan_win_of (:1142).  `fn` is the kind's launcher (default: its
    kernel's wrapper)."""
    R = ring.shape[0]
    fn = KERNELS[kind] if fn is None else fn
    for g in range(G):
        at = off + g
        fn(
            table, meta, ring, (ring_at0 + g) % R, big[dynamic_start(at, big.shape[0], 1)],
            int(ns[dynamic_start(at, len(ns), 1)]), int(tsb[dynamic_start(at, len(tsb), 1)]),
            scratch=scratch,
        )
    return table, ring


def scan_of(kind: str, G: int, plain: bool = False):
    """The G-batch launcher of one kind, the counterpart of the
    reference's _scan_of (:1066): run(table, meta, ring, ring_at0,
    stack, ns, tsb, scratch=None) runs G batches back to back on one
    stream with no host sync; batch g reads stack[g] of a resident
    (G, B, C) stack with n = ns[g] and ts_base = tsb[g], and writes
    ring row (ring_at0 + g) % R.  Each batch launches the kind's kernel
    (K1, K5 or K6), counted as "scan_of"; `plain` runs the plain
    versions through the same loop."""
    fn = _launcher(kind, plain, "scan_of")

    def run(table, meta, ring, ring_at0, stack, ns, tsb, scratch=None):
        if stack.dim() != 3 or stack.shape[0] < G:
            raise ValueError(f"stack must be (>= {G}, B, C), got {tuple(stack.shape)}")
        ns, tsb = _host(ns), _host(tsb)
        if len(ns) != G or len(tsb) != G:
            raise ValueError(f"ns and tsb must hold {G} entries")
        if scratch is None and table.device.type == "cuda" and not plain:
            # One scratch for every batch of the call.
            scratch = new_scratch(FAMILY[kind], table.shape[0], table.device)
        R = ring.shape[0]
        for g in range(G):
            fn(table, meta, ring, (ring_at0 + g) % R, stack[g], int(ns[g]), int(tsb[g]),
               scratch=scratch)
        return table, ring

    return run


def staged(kind: str, plain: bool = False):
    """The superbatch launcher of one kind, the counterpart of the
    reference's _staged (:1172): run(table, meta, ring, ring_at,
    super_pk, g, n, ts_base, scratch=None) runs one batch, rows [s, s +
    B) of a resident (G * B, C) superbatch with s = dynamic_start(g * B,
    G * B, B) — so g = -1 and g >= G read the last batch, g <= -(G + 1)
    the first — passed to the kind's kernel (K1, K5 or K6) as a
    contiguous view, not a copy; counted as "staged".  `plain` runs the
    plain version on the same view."""
    fn = _launcher(kind, plain, "staged")

    def run(table, meta, ring, ring_at, super_pk, g, n, ts_base, scratch=None):
        s = dynamic_start(int(g) * B, super_pk.shape[0], B)
        return fn(table, meta, ring, ring_at, super_pk[s:s + B], int(n), int(ts_base),
                  scratch=scratch)

    return run


# The reference's default batches per scan launch (_scan_sizes, :1112;
# its TB_DEV_SCAN_SIZES knob is not carried over: scan_of takes any G).
SCAN_SIZES = (16, 4)
# kind -> {G: launcher}, as the reference's scan_kernels (:1129).
scan_kernels = {kind: {G: scan_of(kind, G) for G in SCAN_SIZES} for kind in KIND_MODE}
# The reference's five staged instances (:1185-1189).
orderfree_staged = staged("orderfree")
orderfree_lo_staged = staged("orderfree_lo")
linked_staged = staged("linked")
two_phase_staged = staged("two_phase")
two_phase_lo_staged = staged("two_phase_lo")
STAGED = {
    "orderfree_staged": "orderfree", "orderfree_lo_staged": "orderfree_lo",
    "linked_staged": "linked", "two_phase_staged": "two_phase",
    "two_phase_lo_staged": "two_phase_lo",
}


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
# K10: the tiered admission's row scatter.


def tier_set_rows_plain(table, idx, src):
    """Plain version of K10: table[idx[j]] = src[j] for every entry whose
    index lies in [0, H); the others are padding and dropped.  Indices
    are distinct.  In place."""
    keep = (idx >= 0) & (idx < table.shape[0])
    table[idx[keep]] = src[keep]
    return table


def tier_set_rows(table, idx, src):
    """Overwrite rows of an (H, W) table (int64 balances or int32 meta)
    from the (k, W) `src` at the distinct indices `idx` (k,) int64; an
    index outside [0, H) is dropped.  In place.  CUDA tensors launch K10
    (raising on any CUDA error, and on a row other than the engine's
    8 int64 or 2 int32 words); CPU tensors run tier_set_rows_plain.
    The checks read each attribute once: they sit on the admission's
    host path, ahead of every launch."""
    dt, shape, ishape = table.dtype, table.shape, idx.shape
    if len(shape) != 2 or (dt is not torch.int64 and dt is not torch.int32):
        raise ValueError(f"table must be (H, W) int64 or int32, got {tuple(shape)} {dt}")
    if idx.dtype is not torch.int64 or len(ishape) != 1:
        raise ValueError(f"idx must be (k,) int64, got {tuple(ishape)} {idx.dtype}")
    k, W = ishape[0], shape[1]
    if src.dtype is not dt or src.shape != (k, W):
        raise ValueError(f"src must be ({k}, {W}) {dt}, got {tuple(src.shape)} {src.dtype}")
    dev = table.device
    if (idx.device != dev or src.device != dev
            or not (table.is_contiguous() and idx.is_contiguous() and src.is_contiguous())):
        raise ValueError("tensors must be contiguous and on one device")
    if table.is_cpu:
        return tier_set_rows_plain(table, idx, src)
    if k:
        kernels.tier_set_rows(table, idx, src)
    return table


# ---------------------------------------------------------------------------
# K11: the table checksum.

_GOLDEN = 0x9E3779B97F4A7C15


def _wide(table):
    """The table's words as int64 lanes (an int32 table zero-extended)."""
    if table.dtype == torch.int32:
        return table.to(torch.int64) & MASK32
    return table


def checksum_plain(table, row0: int = 0):
    """Plain version of K11: the (2C,) int64 digest of an (R, C) table —
    C column sums, then C sums of v * ((row0 + r) * GOLDEN + 1), mod
    2^64 (the words of mirror.digest_columns).  `row0` is the global
    index of the table's first row: the digests of a row-sharded
    table's shards, each under its own row0, sum to the joined table's."""
    m = _wide(table)
    rows = torch.arange(row0, row0 + m.shape[0], dtype=torch.int64, device=m.device)[:, None]
    mixed = (m * (rows * s64(_GOLDEN) + 1)).sum(dim=0)
    return torch.cat([m.sum(dim=0), mixed])


def checksum(table, row0: int = 0):
    """The (2C,) int64 digest of an (R, C) table of u64 lanes (int64) or
    u32 words (int32, zero-extended) whose first row is global row
    `row0`; C a power of two up to 32.  CUDA tensors launch K11 (raising
    on any CUDA error); CPU tensors run checksum_plain."""
    if table.dim() != 2 or table.dtype not in (torch.int64, torch.int32):
        raise ValueError(f"table must be (R, C) int64 or int32, got {tuple(table.shape)} {table.dtype}")
    C = table.shape[1]
    if C < 1 or C > 32 or C & (C - 1):
        raise ValueError(f"checksum takes a power-of-two column count up to 32, got {C}")
    if not table.is_contiguous():
        raise ValueError("table must be contiguous")
    if row0 < 0:
        raise ValueError(f"row0 must be >= 0, got {row0}")
    if table.device.type == "cpu":
        return checksum_plain(table, row0)
    out = torch.zeros(2 * C, dtype=torch.int64, device=table.device)
    if table.shape[0]:
        kernels.checksum(table, out, row0)
    return out


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
    dr_slot, cr_slot, e_found, p_found=None, p_tgt=None, n_cols: int = N_COLS,
):
    """Packed (B, n_cols) u64 input matrix: wire decoding, stateless byte
    predicates and join results — no result-code decisions.  The
    two-phase kernel takes n_cols = N_COLS_TP, the durable-target join
    (p_found, p_tgt) and pack_two_phase_ext's columns."""
    pk = np.zeros((B, n_cols), np.uint64)
    bits = _predicate_bits(
        np.uint64, n, id_lo, id_hi, dr_lo, dr_hi, cr_lo, cr_hi,
        pend_lo, pend_hi, ts_nonzero,
    )
    for mask, found in ((BIT_E_FOUND, e_found), (BIT_P_FOUND, p_found)):
        if found is not None:
            np.bitwise_or(bits, np.where(found, np.uint64(mask), np.uint64(0)), out=bits)
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
    tcol = timeout.astype(np.uint64)
    if p_tgt is not None:
        tcol = tcol | ((p_tgt.astype(np.int64) + 1).astype(np.uint64) << np.uint64(32))
    pk[:n, COL_TIMEOUT] = tcol
    return pk


def pack_two_phase_ext(
    pk, n, bits_extra_mask, p_flags, p_code, p_ledger, p_dr_slot, p_cr_slot,
    p_amt_lo, p_amt_hi, tgt_ev, dstat_init_ev,
):
    """Fill the two-phase join columns (the durable target's fields, the
    in-batch target event, the durable status) and OR the extra
    predicate bits into COL_BITS, in place."""
    pk[:n, COL_BITS] |= bits_extra_mask
    pk[:n, COL_TP_JOIN] = (
        p_flags.astype(np.uint64)
        | (p_code.astype(np.uint64) << np.uint64(16))
        | (p_ledger.astype(np.uint64) << np.uint64(32))
    )
    pk[:n, COL_TP_SLOTS] = (
        (p_dr_slot.astype(np.int64) + 1).astype(np.uint64)
        | ((p_cr_slot.astype(np.int64) + 1).astype(np.uint64) << np.uint64(32))
    )
    pk[:n, COL_TP_AMT_LO] = p_amt_lo
    pk[:n, COL_TP_AMT_HI] = p_amt_hi
    pk[:n, COL_TP_REF] = (
        (tgt_ev.astype(np.int64) + 1).astype(np.uint64)
        | (dstat_init_ev.astype(np.uint64) << np.uint64(32))
    )
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

"""The exact sequential create_transfers scan: kernel K3 and its plain
version.

Counterpart of ``tigerbeetle_tpu/state_machine/kernel.py``.  The
reference re-expresses the per-event commit loop (reference:
src/state_machine.zig:1220-1306 execute, :1462-1741 create_transfer +
post/void) as a ``lax.scan`` over a batch of B events against the
(A, 8) u64 balance table: every precedence ladder, the balancing
clamps, the overflow and limit codes, in-batch exists checks, two-phase
status transitions, linked-chain rollback through an undo log, history
snapshots and pulse signals.

Here the host packs the batch's 52 event columns (``EVENT_FIELDS``)
into ONE (B, 52) u64 matrix (``pack_events``).  ``run_create_transfers``
sends CUDA tensors to kernel K3 (``csrc/exact_scan.cu``: one thread
walks the events, the per-event carry lives in an explicit scratch
buffer) and CPU tensors to ``run_exact_plain``, a straightforward
Python walk over the same events with u128 values as Python integers.
Both update the table IN PLACE (the reference donates it) and return
the (B, N_COLS) u64 output matrix of ``_pack_outputs``, bit for bit the
reference's, padding lanes included.  Tensors hold u64 lanes as int64.

The same scan runs resumably, for the wave executor (``waves.py``):
the carry is K3's scratch buffer (``scratch_words(B)`` u64 words, the
layout ``csrc/exact_scan.cu`` documents); ``exact_init`` fills it,
``scan_segment`` walks a list of global event indices resuming from it
and ``finalize`` packs it (with the wave path's snapshot rewrite), each
a K3 entry point on CUDA tensors and a plain version (``make_carry``,
``scan_segment_plain``, ``finalize_plain``) on CPU tensors.
``carry_from_dict`` / ``carry_to_dict`` map the reference's carry dict
to and from that image.
"""

from __future__ import annotations

import numpy as np
import torch

from tigerbeetle_tpu_torch import kernels
from tigerbeetle_tpu_torch.ops.u128 import to_u64

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

# Pending statuses (reference: src/tigerbeetle.zig:113-125).
S_NONE, S_PENDING, S_POSTED, S_VOIDED, S_EXPIRED = 0, 1, 2, 3, 4

NS_PER_S = 1_000_000_000
U64_MAX = (1 << 64) - 1

# Result codes the scan produces (reference: src/tigerbeetle.zig:185-265).
R_OK = 0
R_LINKED_EVENT_FAILED = 1
R_LINKED_EVENT_CHAIN_OPEN = 2
R_TIMESTAMP_MUST_BE_ZERO = 3
R_PENDING_NOT_FOUND = 25
R_PENDING_NOT_PENDING = 26
R_PENDING_DIFF_DR = 27
R_PENDING_DIFF_CR = 28
R_PENDING_DIFF_LEDGER = 29
R_PENDING_DIFF_CODE = 30
R_EXCEEDS_PENDING_AMOUNT = 31
R_PENDING_DIFF_AMOUNT = 32
R_ALREADY_POSTED = 33
R_ALREADY_VOIDED = 34
R_PENDING_EXPIRED = 35
R_EXISTS_DIFF_FLAGS = 36
R_EXISTS_DIFF_DR = 37
R_EXISTS_DIFF_CR = 38
R_EXISTS_DIFF_AMOUNT = 39
R_EXISTS_DIFF_PENDING_ID = 40
R_EXISTS_DIFF_UD128 = 41
R_EXISTS_DIFF_UD64 = 42
R_EXISTS_DIFF_UD32 = 43
R_EXISTS_DIFF_TIMEOUT = 44
R_EXISTS_DIFF_CODE = 45
R_EXISTS = 46
R_OVERFLOWS_DP = 47
R_OVERFLOWS_CP = 48
R_OVERFLOWS_DPO = 49
R_OVERFLOWS_CPO = 50
R_OVERFLOWS_DEBITS = 51
R_OVERFLOWS_CREDITS = 52
R_OVERFLOWS_TIMEOUT = 53
R_EXCEEDS_CREDITS = 54
R_EXCEEDS_DEBITS = 55

# Balance-row column layout: 4 u128s as (lo, hi) limb pairs.
DP_LO, DP_HI, DPO_LO, DPO_HI, CP_LO, CP_HI, CPO_LO, CPO_HI = range(8)

# Fields of the in-batch "created transfers" record (all (B,)).
CREATED_FIELDS = (
    "flags",       # uint32
    "dr_slot",     # int32
    "cr_slot",     # int32
    "amount_lo", "amount_hi",
    "pending_lo", "pending_hi",   # pending_id
    "ud128_lo", "ud128_hi",
    "ud64",
    "ud32",        # uint32
    "timeout",     # uint64 (widened)
    "ledger",      # uint32
    "code",        # uint32
)

_CREATED_DTYPES = {
    "dr_slot": np.int32,
    "cr_slot": np.int32,
    "flags": np.uint32,
    "ud32": np.uint32,
    "ledger": np.uint32,
    "code": np.uint32,
}

# Batch shape buckets: the host pads every exact-path batch up to the
# next bucket, as the reference does (its compile-cache keys).
BATCH_BUCKETS = (32, 256, 2048, 8192)

# Per-event input columns, in the packed matrix's column order.  int32
# columns are stored sign-extended, bools as 0/1, u32 zero-extended.
EVENT_FIELDS = (
    ("i", np.int32),
    ("flags", np.uint32),
    ("ts_nonzero", np.bool_),
    ("static_result", np.uint32),
    ("amount_lo", np.uint64), ("amount_hi", np.uint64),
    ("pending_lo", np.uint64), ("pending_hi", np.uint64),
    ("ud128_lo", np.uint64), ("ud128_hi", np.uint64),
    ("ud64", np.uint64),
    ("ud32", np.uint32),
    ("timeout", np.uint64),
    ("ledger", np.uint32),
    ("code", np.uint32),
    ("dr_slot", np.int32), ("cr_slot", np.int32),
    ("dr_flags", np.uint32), ("cr_flags", np.uint32),
    ("dr_id_zero", np.bool_), ("cr_id_zero", np.bool_),
    # Compact id-value groups: id_group in [0, B); p_group = group of
    # this event's pending_id value if that value is also some event's
    # id, else -1.
    ("id_group", np.int32),
    ("p_group", np.int32),
    # Durable transfer with the same id (exists check), zeros if none:
    ("e_found", np.bool_),
    ("e_flags", np.uint32),
    ("e_dr_slot", np.int32), ("e_cr_slot", np.int32),
    ("e_amount_lo", np.uint64), ("e_amount_hi", np.uint64),
    ("e_pending_lo", np.uint64), ("e_pending_hi", np.uint64),
    ("e_ud128_lo", np.uint64), ("e_ud128_hi", np.uint64),
    ("e_ud64", np.uint64),
    ("e_ud32", np.uint32),
    ("e_timeout", np.uint64),
    ("e_code", np.uint32),
    # Durable transfer matching pending_id (post/void), zeros if none:
    ("p_found", np.bool_),
    ("p_flags", np.uint32),
    ("p_dr_slot", np.int32), ("p_cr_slot", np.int32),
    ("p_amount_lo", np.uint64), ("p_amount_hi", np.uint64),
    ("p_ud128_lo", np.uint64), ("p_ud128_hi", np.uint64),
    ("p_ud64", np.uint64),
    ("p_ud32", np.uint32),
    ("p_timeout", np.uint64),
    ("p_ledger", np.uint32),
    ("p_code", np.uint32),
    ("p_timestamp", np.uint64),
    ("p_tgt", np.int32),  # index into the durable-status array
)
N_EVENT_COLS = len(EVENT_FIELDS)  # 52
COL = {name: k for k, (name, _dt) in enumerate(EVENT_FIELDS)}

# Packed-output column layout: every per-event output rides ONE
# (B, N_COLS) u64 matrix (unpacked on the host by unpack_outputs).
_SCALAR_COLS = (
    ["results", "created_mask"]
    + list(CREATED_FIELDS)
    + ["inb_status", "dstat", "pulse_create", "pulse_remove", "last_applied"]
)
N_COLS = len(_SCALAR_COLS) + 16  # + hist_dr (8) + hist_cr (8) = 37

_M32 = 0xFFFFFFFF
_M64 = U64_MAX
_M128 = (1 << 128) - 1


def _noop(x):
    """The reference's ``kernel._noop`` (an identity jit that nothing in
    the repository calls): the identity."""
    return x


# ---------------------------------------------------------------------------
# Host packing.


def pack_events(ev: dict) -> np.ndarray:
    """(B,) host arrays per EVENT_FIELDS -> the (B, 52) u64 matrix K3
    and its plain version read."""
    B = len(ev["i"])
    out = np.empty((B, N_EVENT_COLS), np.uint64)
    for k, (name, dtype) in enumerate(EVENT_FIELDS):
        col = np.asarray(ev[name])
        if dtype == np.int32:
            out[:, k] = col.astype(np.int64).view(np.uint64)
        else:
            out[:, k] = col.astype(np.uint64)
    return out


def unpack_outputs(packed: np.ndarray) -> dict:
    """Host-side inverse of _pack_outputs (packed: (B, N_COLS) u64)."""
    assert packed.shape[1] == N_COLS, packed.shape
    out = {"created": {}}
    for k, name in enumerate(_SCALAR_COLS):
        col = packed[:, k]
        if name == "last_applied":
            out[name] = int(col[0]) - 1
        elif name in ("dr_slot", "cr_slot"):
            out["created"][name] = col.view(np.int64).astype(np.int32)
        elif name in CREATED_FIELDS:
            out["created"][name] = col.astype(_CREATED_DTYPES.get(name, np.uint64))
        elif name == "created_mask":
            out[name] = col.astype(bool)
        elif name in ("results", "inb_status", "dstat"):
            out[name] = col.astype(np.uint32)
        else:
            out[name] = col.copy()
    base = len(_SCALAR_COLS)
    out["hist_dr"] = packed[:, base : base + 8]
    out["hist_cr"] = packed[:, base + 8 : base + 16]
    return out


def touched_slots(pk_u64: np.ndarray, n: int) -> np.ndarray:
    """Every balance row the scan can write for the first n events of a
    packed batch: the event's own slots and its pending's slots (a
    post/void moves the pending's rows).  Found slots only (an applied
    event always names found accounts)."""
    cols = pk_u64[:n, [COL["dr_slot"], COL["cr_slot"], COL["p_dr_slot"], COL["p_cr_slot"]]]
    s = cols.view(np.int64).ravel()
    return np.unique(s[s >= 0])


# ---------------------------------------------------------------------------
# The plain version: one Python step per event, u128 as Python ints.


def _s32(word: int) -> int:
    """The int32 held in the low bits of a packed column word."""
    return ((word & _M32) ^ 0x80000000) - 0x80000000


def _clip(v: int, hi: int) -> int:
    return 0 if v < 0 else (hi if v > hi else v)


class _Rows:
    """The table rows a batch reads, as Python ints: prefetched in one
    gather, written back in one scatter, a row missing from the
    prefetch read on demand."""

    def __init__(self, table: torch.Tensor, slots: np.ndarray) -> None:
        self.table = table
        got = to_u64(table[torch.from_numpy(slots).to(table.device)]).tolist()
        self.rows = dict(zip(slots.tolist(), got))
        self.dirty: set[int] = set()

    def get(self, s: int) -> list:
        row = self.rows.get(s)
        if row is None:
            row = to_u64(self.table[s : s + 1])[0].tolist()
            self.rows[s] = row
        return row

    def put(self, s: int, row: list) -> None:
        self.rows[s] = row
        self.dirty.add(s)

    def write_back(self) -> None:
        if not self.dirty:
            return
        slots = sorted(self.dirty)
        vals = np.array([self.rows[s] for s in slots], np.uint64)
        idx = torch.tensor(slots, dtype=torch.int64, device=self.table.device)
        self.table[idx] = torch.from_numpy(vals.view(np.int64)).to(self.table.device)


def _carry_lists(dstat_init: list, B: int) -> dict:
    """Initial scan carry of the plain walk: the same fields as the
    reference's make_carry, as Python lists."""
    return {
        "results": [0] * B,
        "created_mask": [0] * B,
        "created": {f: [0] * B for f in CREATED_FIELDS},
        # group index -> event holding a created transfer with that id
        # value (-1 none); at most one at any time.
        "group_creator": [-1] * B,
        "inb_status": [0] * B,
        "dstat": list(dstat_init),
        # Undo log for chain rollback.
        "u_dr_slot": [-1] * B,
        "u_cr_slot": [-1] * B,
        "u_dr_bal": [None] * B,
        "u_cr_bal": [None] * B,
        "u_status_kind": [0] * B,  # 0 none, 1 durable, 2 in-batch
        "u_status_idx": [0] * B,
        # Post-apply balance snapshots (historical balances).
        "hist_dr": [[0] * 8] * B,
        "hist_cr": [[0] * 8] * B,
        "chain_start": -1,
        "chain_broken": False,
        # Last event that reached the apply point, chain events later
        # rolled back included (reference: src/state_machine.zig:1583).
        "last_applied": -1,
        # Apply-time pulse signals, never rolled back (reference:
        # src/state_machine.zig:1576-1580,1704-1708).
        "pulse_create": [0] * B,
        "pulse_remove": [0] * B,
    }


def _u128(row: list, k: int) -> int:
    return row[k] | (row[k + 1] << 64)


def make_body(n: int, ts_base: int, B: int, A: int, id_group_full: list, rows: _Rows):
    """The per-event step (reference ``make_body``): body(carry, ev)
    with ev one packed row as a list of 52 ints."""
    Bm, Am = B - 1, A - 1
    created = None  # bound per call

    def exists_normal(ev, e):
        # reference: src/state_machine.zig:1587-1606 (raw t.amount)
        if ev[1] != e[0]:
            return R_EXISTS_DIFF_FLAGS
        if _s32(ev[15]) != e[1]:
            return R_EXISTS_DIFF_DR
        if _s32(ev[16]) != e[2]:
            return R_EXISTS_DIFF_CR
        if ev[4] != e[3] or ev[5] != e[4]:
            return R_EXISTS_DIFF_AMOUNT
        if ev[8] != e[7] or ev[9] != e[8]:
            return R_EXISTS_DIFF_UD128
        if ev[10] != e[9]:
            return R_EXISTS_DIFF_UD64
        if ev[11] != e[10]:
            return R_EXISTS_DIFF_UD32
        if ev[12] != e[11]:
            return R_EXISTS_DIFF_TIMEOUT
        if ev[14] != e[13]:
            return R_EXISTS_DIFF_CODE
        return R_EXISTS

    def exists_post_void(ev, e, p):
        # reference: src/state_machine.zig:1743-1804 (zero means inherit)
        if ev[1] != e[0]:
            return R_EXISTS_DIFF_FLAGS
        if ev[4] == 0 and ev[5] == 0:
            amount_diff = e[3] != p[3] or e[4] != p[4]
        else:
            amount_diff = ev[4] != e[3] or ev[5] != e[4]
        if amount_diff:
            return R_EXISTS_DIFF_AMOUNT
        if ev[6] != e[5] or ev[7] != e[6]:
            return R_EXISTS_DIFF_PENDING_ID
        if ev[8] == 0 and ev[9] == 0:
            ud128_diff = e[7] != p[7] or e[8] != p[8]
        else:
            ud128_diff = ev[8] != e[7] or ev[9] != e[8]
        if ud128_diff:
            return R_EXISTS_DIFF_UD128
        if (e[9] != p[9]) if ev[10] == 0 else (ev[10] != e[9]):
            return R_EXISTS_DIFF_UD64
        if (e[10] != p[10]) if ev[11] == 0 else (ev[11] != e[10]):
            return R_EXISTS_DIFF_UD32
        return R_EXISTS

    def created_rec(j):
        return [created[f][j] for f in CREATED_FIELDS]

    def body(carry, ev):
        nonlocal created
        created = carry["created"]
        gc = carry["group_creator"]
        i = _s32(ev[0])
        active = i < n
        flags = ev[1] & _M32
        linked = (flags & F_LINKED) != 0
        is_pv = (flags & (F_POST | F_VOID)) != 0
        ts_i = (ts_base + i) & _M64

        # -- Chain bookkeeping (reference: src/state_machine.zig:1240-1248).
        chain_start = carry["chain_start"]
        if active and linked and chain_start < 0:
            chain_start = i
        chain_broken = carry["chain_broken"]
        if linked and i == n - 1:
            pre = R_LINKED_EVENT_CHAIN_OPEN
        elif chain_broken:
            pre = R_LINKED_EVENT_FAILED
        elif ev[2]:
            pre = R_TIMESTAMP_MUST_BE_ZERO
        else:
            pre = ev[3] & _M32

        # -- Exists resolution via the in-batch id directory.  e and p
        # are records in CREATED_FIELDS order.
        e_creator = gc[_clip(_s32(ev[21]), Bm)]
        e_inb = e_creator >= 0
        e_any = e_inb or ev[23] != 0
        if e_inb:
            e = created_rec(e_creator)
        else:
            e = [ev[24] & _M32, _s32(ev[25]), _s32(ev[26]), ev[27], ev[28], ev[29],
                 ev[30], ev[31], ev[32], ev[33], ev[34] & _M32, ev[35], 0,
                 ev[36] & _M32]

        # ================= normal create_transfer =================
        # (reference: src/state_machine.zig:1506-1547)
        dr_row = rows.get(_clip(_s32(ev[15]), Am))
        cr_row = rows.get(_clip(_s32(ev[16]), Am))
        dr_dp, dr_dpo, dr_cpo = _u128(dr_row, 0), _u128(dr_row, 2), _u128(dr_row, 6)
        cr_dp, cr_dpo = _u128(cr_row, 0), _u128(cr_row, 2)
        cr_cp, cr_cpo = _u128(cr_row, 4), _u128(cr_row, 6)

        amount = ev[4] | (ev[5] << 64)
        # amount == 0 with balancing means maxInt(u64)
        # (reference: src/state_machine.zig:1512).
        if (flags & (F_BAL_DR | F_BAL_CR)) and amount == 0:
            amount = U64_MAX
        bd_fail = bc_fail = False
        if flags & F_BAL_DR:
            amount = min(amount, max(dr_cpo - ((dr_dpo + dr_dp) & _M128), 0))
            bd_fail = amount == 0
        if flags & F_BAL_CR and not bd_fail:
            amount = min(amount, max(cr_dpo - ((cr_cpo + cr_cp) & _M128), 0))
            bc_fail = amount == 0
        is_pending = (flags & F_PENDING) != 0
        dr_total = (dr_dp + dr_dpo) & _M128
        cr_total = (cr_cp + cr_cpo) & _M128
        timeout = ev[12]
        timeout_ns = (timeout * NS_PER_S) & _M64
        ts_plus = (ts_i + timeout_ns) & _M64

        if e_any:
            rn = exists_normal(ev, e)
        elif bd_fail:
            rn = R_EXCEEDS_CREDITS
        elif bc_fail:
            rn = R_EXCEEDS_DEBITS
        elif is_pending and amount + dr_dp > _M128:
            rn = R_OVERFLOWS_DP
        elif is_pending and amount + cr_cp > _M128:
            rn = R_OVERFLOWS_CP
        elif amount + dr_dpo > _M128:
            rn = R_OVERFLOWS_DPO
        elif amount + cr_cpo > _M128:
            rn = R_OVERFLOWS_CPO
        elif amount + dr_total > _M128:
            rn = R_OVERFLOWS_DEBITS
        elif amount + cr_total > _M128:
            rn = R_OVERFLOWS_CREDITS
        elif ts_plus < ts_i:
            rn = R_OVERFLOWS_TIMEOUT
        elif (ev[17] & AF_DR_LIMIT) and ((dr_total + amount) & _M128) > dr_cpo:
            rn = R_EXCEEDS_CREDITS
        elif (ev[18] & AF_CR_LIMIT) and ((cr_total + amount) & _M128) > cr_dpo:
            rn = R_EXCEEDS_DEBITS
        else:
            rn = 0

        # ================= post/void pending transfer =================
        # (reference: src/state_machine.zig:1608-1741)
        p_creator = gc[_clip(_s32(ev[22]), Bm)]
        p_dur = ev[37] != 0
        p_any = p_dur or (_s32(ev[22]) >= 0 and p_creator >= 0)
        pcr = _clip(p_creator, Bm)
        if p_dur:
            p = [ev[38] & _M32, _s32(ev[39]), _s32(ev[40]), ev[41], ev[42], 0, 0,
                 ev[43], ev[44], ev[45], ev[46] & _M32, ev[47], ev[48] & _M32,
                 ev[49] & _M32]
            p_timestamp = ev[50]
        else:
            p = created_rec(pcr)
            p_timestamp = (ts_base + pcr) & _M64
        p_amount = p[3] | (p[4] << 64)
        pv_amount = (ev[4] | (ev[5] << 64)) or p_amount
        is_post = (flags & F_POST) != 0
        p_tgt = _s32(ev[51])
        st = carry["dstat"][_clip(p_tgt, Bm)] if p_dur else carry["inb_status"][pcr]

        if not p_any:
            rp_pre = R_PENDING_NOT_FOUND
        elif (p[0] & F_PENDING) == 0:
            rp_pre = R_PENDING_NOT_PENDING
        elif not ev[19] and _s32(ev[15]) != p[1]:
            rp_pre = R_PENDING_DIFF_DR
        elif not ev[20] and _s32(ev[16]) != p[2]:
            rp_pre = R_PENDING_DIFF_CR
        elif ev[13] > 0 and ev[13] != p[12]:
            rp_pre = R_PENDING_DIFF_LEDGER
        elif ev[14] > 0 and ev[14] != p[13]:
            rp_pre = R_PENDING_DIFF_CODE
        elif pv_amount > p_amount:
            rp_pre = R_EXCEEDS_PENDING_AMOUNT
        elif (flags & F_VOID) and pv_amount < p_amount:
            rp_pre = R_PENDING_DIFF_AMOUNT
        elif e_any:
            rp_pre = exists_post_void(ev, e, p)
        elif st == S_POSTED:
            rp_pre = R_ALREADY_POSTED
        elif st == S_VOIDED:
            rp_pre = R_ALREADY_VOIDED
        elif st == S_EXPIRED:
            rp_pre = R_PENDING_EXPIRED
        else:
            rp_pre = 0
        # QUIRK (reference: src/state_machine.zig:1687-1696): the t2
        # insert lands BEFORE the overdue check, so an overdue post/void
        # leaks its transfer while returning an error.
        p_expires = (p_timestamp + ((p[11] * NS_PER_S) & _M64)) & _M64
        overdue = p[11] > 0 and p_expires <= ts_i
        rp = R_PENDING_EXPIRED if (rp_pre == 0 and overdue) else rp_pre

        # ================= merge & apply =================
        gate = active and pre == 0
        r = (rp if is_pv else rn) if gate else (pre if active else 0)
        pv_inserted = gate and is_pv and rp_pre == 0
        normal_applied = gate and not is_pv and rn == 0
        pv_applied = gate and is_pv and rp == 0
        inserted = pv_inserted or normal_applied
        applied = pv_applied or normal_applied

        if is_pv:
            up_dr, up_cr = p[1], p[2]
        else:
            up_dr, up_cr = _s32(ev[15]), _s32(ev[16])
        safe_dr, safe_cr = _clip(up_dr, Am), _clip(up_cr, Am)
        old_dr = rows.get(safe_dr)
        old_cr = rows.get(safe_cr)
        o_dr_dp, o_dr_dpo = _u128(old_dr, 0), _u128(old_dr, 2)
        o_cr_cp, o_cr_cpo = _u128(old_cr, 4), _u128(old_cr, 6)
        if is_pv:
            n_dr_dp = (o_dr_dp - p_amount) & _M128
            n_cr_cp = (o_cr_cp - p_amount) & _M128
            n_dr_dpo = (o_dr_dpo + pv_amount) & _M128 if is_post else o_dr_dpo
            n_cr_cpo = (o_cr_cpo + pv_amount) & _M128 if is_post else o_cr_cpo
        elif is_pending:
            n_dr_dp, n_dr_dpo = (o_dr_dp + amount) & _M128, o_dr_dpo
            n_cr_cp, n_cr_cpo = (o_cr_cp + amount) & _M128, o_cr_cpo
        else:
            n_dr_dp, n_dr_dpo = o_dr_dp, (o_dr_dpo + amount) & _M128
            n_cr_cp, n_cr_cpo = o_cr_cp, (o_cr_cpo + amount) & _M128
        new_dr = [n_dr_dp & _M64, n_dr_dp >> 64, n_dr_dpo & _M64, n_dr_dpo >> 64,
                  old_dr[4], old_dr[5], old_dr[6], old_dr[7]]
        new_cr = [old_cr[0], old_cr[1], old_cr[2], old_cr[3],
                  n_cr_cp & _M64, n_cr_cp >> 64, n_cr_cpo & _M64, n_cr_cpo >> 64]
        if applied:  # the dr row first, then the cr row
            rows.put(safe_dr, new_dr)
            rows.put(safe_cr, new_cr)

        # Created-transfer record (reference t2 construction:
        # src/state_machine.zig:1549-1551,1672-1687) + id directory.
        if inserted:
            ud128_inherit = is_pv and ev[8] == 0 and ev[9] == 0
            rec_amount = pv_amount if is_pv else amount
            rec = (
                flags, up_dr, up_cr, rec_amount & _M64, rec_amount >> 64,
                ev[6], ev[7],
                p[7] if ud128_inherit else ev[8],
                p[8] if ud128_inherit else ev[9],
                p[9] if (is_pv and ev[10] == 0) else ev[10],
                p[10] if (is_pv and ev[11] == 0) else ev[11] & _M32,
                0 if is_pv else timeout,
                p[12] if is_pv else ev[13] & _M32,
                p[13] if is_pv else ev[14] & _M32,
            )
            for f, v in zip(CREATED_FIELDS, rec):
                created[f][i] = v
            gc[_clip(_s32(ev[21]), Bm)] = i
        carry["created_mask"][i] = 1 if inserted else 0

        inb_status = carry["inb_status"]
        inb_status[i] = S_PENDING if (normal_applied and is_pending) else 0
        new_status = S_POSTED if is_post else S_VOIDED
        if pv_applied:
            if p_dur:
                carry["dstat"][_clip(p_tgt, Bm)] = new_status
            else:
                inb_status[pcr] = new_status

        # Undo log (balance restore, creation, status change).
        carry["u_dr_slot"][i] = up_dr if applied else -1
        carry["u_cr_slot"][i] = up_cr if applied else -1
        carry["u_dr_bal"][i] = old_dr
        carry["u_cr_bal"][i] = old_cr
        carry["u_status_kind"][i] = (1 if p_dur else 2) if pv_applied else 0
        carry["u_status_idx"][i] = p_tgt if p_dur else p_creator
        carry["hist_dr"][i] = new_dr
        carry["hist_cr"][i] = new_cr
        results = carry["results"]
        results[i] = r

        # -- Chain failure: roll back [chain_start, i] newest first
        # (reference: src/state_machine.zig:1269-1290).
        chain_fail = active and r != 0 and chain_start >= 0 and not chain_broken
        if chain_fail:
            for idx in range(i, chain_start - 1, -1):
                ds = carry["u_dr_slot"][idx]
                if ds >= 0:
                    rows.put(_clip(carry["u_cr_slot"][idx], Am), carry["u_cr_bal"][idx])
                    rows.put(_clip(ds, Am), carry["u_dr_bal"][idx])
                g = _clip(id_group_full[idx], Bm)
                if gc[g] == idx:
                    gc[g] = -1
                carry["created_mask"][idx] = 0
                inb_status[idx] = 0
                kind = carry["u_status_kind"][idx]
                sidx = _clip(carry["u_status_idx"][idx], Bm)
                if kind == 1:
                    carry["dstat"][sidx] = S_PENDING
                elif kind == 2:
                    inb_status[sidx] = S_PENDING
            for j in range(chain_start, i):
                results[j] = R_LINKED_EVENT_FAILED
            chain_broken = True

        # Chain close (reference: src/state_machine.zig:1292-1300).
        if chain_start >= 0 and (not linked or r == R_LINKED_EVENT_CHAIN_OPEN):
            chain_start, chain_broken = -1, False
        carry["chain_start"] = chain_start
        carry["chain_broken"] = chain_broken
        if applied:
            carry["last_applied"] = i
        carry["pulse_create"][i] = (
            ts_plus if (normal_applied and is_pending and timeout > 0) else 0
        )
        carry["pulse_remove"][i] = p_expires if (pv_applied and p[11] > 0) else 0

    return body


def _pack_outputs(carry: dict) -> np.ndarray:
    """(final carry) -> the (B, N_COLS) u64 output matrix (the
    reference's finalize_outputs + _pack_outputs)."""
    B = len(carry["results"])
    out = np.zeros((B, N_COLS), np.uint64)
    for k, name in enumerate(_SCALAR_COLS):
        if name == "last_applied":
            out[0, k] = carry["last_applied"] + 1
        elif name in CREATED_FIELDS:
            col = np.asarray(carry["created"][name], np.int64 if name in ("dr_slot", "cr_slot")
                             else np.uint64)
            out[:, k] = col.view(np.uint64) if col.dtype == np.int64 else col
        else:
            out[:, k] = np.asarray(carry[name], np.uint64)
    base = len(_SCALAR_COLS)
    out[:, base : base + 8] = np.asarray(carry["hist_dr"], np.uint64)
    out[:, base + 8 :] = np.asarray(carry["hist_cr"], np.uint64)
    return out


def run_exact_plain(table, events, dstat_init, n, ts_base):
    """Plain version of K3: the reference's ``_run_impl`` over one
    packed batch, one Python step per event; updates `table` in place
    and returns the (B, N_COLS) int64 output matrix on its device."""
    B, A = events.shape[0], table.shape[0]
    ev_rows = to_u64(events).tolist()
    id_group_full = [_s32(r[COL["id_group"]]) for r in ev_rows]
    cols = to_u64(events)[:, [COL["dr_slot"], COL["cr_slot"], COL["p_dr_slot"],
                              COL["p_cr_slot"]]].view(np.int64)
    slots = np.unique(np.concatenate([np.clip(cols.ravel(), 0, A - 1), [0]]))
    rows = _Rows(table, slots)
    carry = _carry_lists([int(v) & _M32 for v in dstat_init.tolist()], B)
    body = make_body(int(n), int(ts_base) & _M64, B, A, id_group_full, rows)
    for ev in ev_rows:
        body(carry, ev)
    rows.write_back()
    packed = _pack_outputs(carry)
    return torch.from_numpy(packed.view(np.int64)).to(table.device)


# ---------------------------------------------------------------------------
# K3 wrapper.


class ExactScratch:
    """K3's per-event carry, one device buffer of SCRATCH_WORDS(B) u64
    words in the layout csrc/exact_scan.cu documents (so a later
    segment launch can resume from it)."""

    def __init__(self, batch: int, device) -> None:
        self.batch = batch
        self.words = torch.empty(scratch_words(batch), dtype=torch.int64, device=device)


def scratch_words(B: int) -> int:
    """u64 words of K3's scratch (csrc/exact_scan.cu's layout): 14
    created-record fields and 11 other per-event columns, four (B, 8)
    row logs (undo dr/cr, history dr/cr), and 4 scalar words."""
    return B * (14 + 11 + 32) + 4


def _check_table_events(table, events, n):
    """The table and packed-events contract shared by K3's entry points
    and the wave kernels."""
    A = table.shape[0]
    if table.dtype != torch.int64 or table.dim() != 2 or table.shape[1] != 8 or A < 1:
        raise ValueError(f"table must be (A, 8) int64, got {tuple(table.shape)} {table.dtype}")
    B = events.shape[0]
    if events.dtype != torch.int64 or events.shape != (B, N_EVENT_COLS):
        raise ValueError(f"events must be (B, {N_EVENT_COLS}) int64, got {tuple(events.shape)}")
    if not 0 <= n <= B or B < 1 or B > 8192:
        raise ValueError(f"need 0 <= n={n} <= B={B} <= 8192")
    if A >= 1 << 31:
        raise ValueError("table rows must fit int32 slot indices")
    if events.device != table.device:
        raise ValueError("tensors must share one device")
    if not (table.is_contiguous() and events.is_contiguous()):
        raise ValueError("tensors must be contiguous")


def _check_exact(table, events, dstat_init, n):
    _check_table_events(table, events, n)
    B = events.shape[0]
    if dstat_init.dtype != torch.int32 or dstat_init.shape != (B,):
        raise ValueError(f"dstat_init must be ({B},) int32")
    if dstat_init.device != table.device or not dstat_init.is_contiguous():
        raise ValueError("dstat_init must be contiguous on the table's device")


def run_create_transfers(table, events, dstat_init, n, ts_base,
                         scratch: ExactScratch | None = None):
    """One exact batch: `table` (A, 8) int64 updated in place, `events`
    the (B, 52) int64 packed matrix, `dstat_init` (B,) int32 durable
    pending statuses.  Returns (table, (B, N_COLS) int64 outputs).
    CUDA tensors launch K3 (raising on any CUDA error); CPU tensors run
    run_exact_plain."""
    _check_exact(table, events, dstat_init, n)
    if table.device.type == "cpu":
        return table, run_exact_plain(table, events, dstat_init, n, ts_base)
    B = events.shape[0]
    if scratch is None or scratch.batch < B or scratch.words.device != table.device:
        scratch = ExactScratch(B, table.device)
    out = torch.empty((B, N_COLS), dtype=torch.int64, device=table.device)
    kernels.exact_scan(table, events, dstat_init, int(n),
                       int(ts_base) & U64_MAX, scratch.words, out)
    return table, out


# ---------------------------------------------------------------------------
# The resumable carry: K3's scratch image (csrc/exact_scan.cu's layout).

N_REGIONS = 57
(R_RESULTS, R_CMASK, R_GC, R_INB, R_DSTAT, R_U_DR, R_U_CR, R_U_KIND,
 R_U_SIDX, R_PULSE_C, R_PULSE_R) = range(14, 25)
R_U_DR_BAL, R_U_CR_BAL, R_HIST_DR, R_HIST_CR = 25, 33, 41, 49
# Per-event regions holding signed values (sign-extended int64).
_SIGNED_REGIONS = (CREATED_FIELDS.index("dr_slot"), CREATED_FIELDS.index("cr_slot"),
                   R_GC, R_U_DR, R_U_CR, R_U_SIDX)
# (reference carry key, region) of the (B,) scalar-per-event entries.
_CARRY_COLUMNS = (
    ("results", R_RESULTS, np.uint32), ("created_mask", R_CMASK, np.bool_),
    ("group_creator", R_GC, np.int32), ("inb_status", R_INB, np.uint32),
    ("dstat", R_DSTAT, np.uint32), ("u_dr_slot", R_U_DR, np.int32),
    ("u_cr_slot", R_U_CR, np.int32), ("u_status_kind", R_U_KIND, np.int32),
    ("u_status_idx", R_U_SIDX, np.int32), ("pulse_create", R_PULSE_C, np.uint64),
    ("pulse_remove", R_PULSE_R, np.uint64),
)
_CARRY_ROWS = (("u_dr_bal", R_U_DR_BAL), ("u_cr_bal", R_U_CR_BAL),
               ("hist_dr", R_HIST_DR), ("hist_cr", R_HIST_CR))


def _word_col(arr) -> np.ndarray:
    """A (B,) column of any integer or bool dtype -> its u64 words
    (signed values sign-extended)."""
    a = np.asarray(arr)
    if a.dtype.kind == "i":
        return a.astype(np.int64).view(np.uint64)
    return a.astype(np.uint64)


def carry_from_dict(carry: dict) -> np.ndarray:
    """The reference's carry dict (kernel.make_carry's keys as numpy
    arrays, "balances" ignored) -> the (57 B + 4,) u64 scratch image."""
    B = len(carry["results"])
    out = np.zeros(scratch_words(B), np.uint64)
    for f, name in enumerate(CREATED_FIELDS):
        out[f * B:(f + 1) * B] = _word_col(carry["created"][name])
    for key, region, _dt in _CARRY_COLUMNS:
        out[region * B:(region + 1) * B] = _word_col(carry[key])
    for key, region in _CARRY_ROWS:
        out[region * B:(region + 8) * B] = np.asarray(carry[key], np.uint64).reshape(-1)
    base = N_REGIONS * B
    out[base] = np.uint64(int(carry["chain_start"]) & _M64)
    out[base + 1] = np.uint64(bool(carry["chain_broken"]))
    out[base + 2] = np.uint64(int(carry["last_applied"]) & _M64)
    return out


def carry_to_dict(words, B: int) -> dict:
    """The scratch image (u64 numpy words or an int64 tensor) -> the
    reference's carry dict, each entry in the reference's dtype."""
    w = to_u64(words) if isinstance(words, torch.Tensor) else np.asarray(words, np.uint64)
    sv = w.view(np.int64)

    def col(region, dtype):
        src = sv if region in _SIGNED_REGIONS else w
        return src[region * B:(region + 1) * B].astype(dtype)

    out = {"created": {f: col(k, _CREATED_DTYPES.get(f, np.uint64))
                       for k, f in enumerate(CREATED_FIELDS)}}
    for key, region, dtype in _CARRY_COLUMNS:
        out[key] = col(region, dtype)
    for key, region in _CARRY_ROWS:
        out[key] = w[region * B:(region + 8) * B].reshape(B, 8).copy()
    base = N_REGIONS * B
    out["chain_start"] = np.int32(sv[base])
    out["chain_broken"] = np.bool_(w[base + 1] != 0)
    out["last_applied"] = np.int32(sv[base + 2])
    return out


def carry_views(words: torch.Tensor, B: int) -> dict:
    """Named int64 views into a scratch image (writes land in it)."""
    v = {"created": words[:14 * B].view(14, B)}
    for key, region, _dt in _CARRY_COLUMNS:
        v[key] = words[region * B:(region + 1) * B]
    for key, region in _CARRY_ROWS:
        v[key] = words[region * B:(region + 8) * B].view(B, 8)
    v["scalars"] = words[N_REGIONS * B:N_REGIONS * B + 4]
    return v


def make_carry(words: torch.Tensor, dstat_init: torch.Tensor) -> torch.Tensor:
    """Plain version of K3's tb_exact_init: the initial carry of a
    (B,)-row batch (dstat_init int32 (B,)) in `words`, which holds at
    least scratch_words(B) words.  Returns `words`."""
    B = dstat_init.shape[0]
    words[:scratch_words(B)] = 0
    v = carry_views(words, B)
    for key in ("group_creator", "u_dr_slot", "u_cr_slot"):
        v[key].fill_(-1)
    v["dstat"].copy_(dstat_init.to(torch.int64) & 0xFFFFFFFF)
    v["scalars"].copy_(torch.tensor([-1, 0, -1, 0], dtype=torch.int64))
    return words


def _lists_from_words(w: np.ndarray, B: int) -> dict:
    """The plain walk's Python-list carry from a u64 scratch image."""
    sv = w.view(np.int64)

    def col(region):
        src = sv if region in _SIGNED_REGIONS else w
        return src[region * B:(region + 1) * B].tolist()

    carry = {"created": {f: col(k) for k, f in enumerate(CREATED_FIELDS)}}
    for key, region, _dt in _CARRY_COLUMNS:
        carry[key] = col(region)
    for key, region in _CARRY_ROWS:
        carry[key] = w[region * B:(region + 8) * B].reshape(B, 8).tolist()
    base = N_REGIONS * B
    carry["chain_start"] = int(sv[base])
    carry["chain_broken"] = bool(w[base + 1])
    carry["last_applied"] = int(sv[base + 2])
    return carry


def _lists_to_words(carry: dict, w: np.ndarray, B: int) -> None:
    def put(region, values):
        dt = np.int64 if region in _SIGNED_REGIONS else np.uint64
        w[region * B:(region + 1) * B] = np.array(values, dt).view(np.uint64)

    for k, f in enumerate(CREATED_FIELDS):
        put(k, carry["created"][f])
    for key, region, _dt in _CARRY_COLUMNS:
        put(region, carry[key])
    for key, region in _CARRY_ROWS:
        w[region * B:(region + 8) * B] = np.array(carry[key], np.uint64).reshape(-1)
    base = N_REGIONS * B
    w[base] = np.uint64(carry["chain_start"] & _M64)
    w[base + 1] = np.uint64(bool(carry["chain_broken"]))
    w[base + 2] = np.uint64(carry["last_applied"] & _M64)


def scan_segment_plain(table, events, words, rows, n, ts_base) -> None:
    """Plain version of K3's tb_exact_segment (the reference's
    _scan_segment_impl): the walk over the global event indices `rows`
    (an index outside [0, B) is padding and skipped), resuming from and
    returning to the carry in `words`; `table` updated in place."""
    B, A = events.shape[0], table.shape[0]
    order = [r for r in rows.tolist() if 0 <= r < B]
    if not order:
        return
    pk = to_u64(events)
    ev_rows = pk.tolist()
    id_group_full = [_s32(r[COL["id_group"]]) for r in ev_rows]
    sel = pk[order][:, [COL["dr_slot"], COL["cr_slot"], COL["p_dr_slot"], COL["p_cr_slot"]]]
    slots = np.unique(np.concatenate([np.clip(sel.view(np.int64).ravel(), 0, A - 1), [0]]))
    table_rows = _Rows(table, slots)
    size = scratch_words(B)
    w = to_u64(words[:size]).copy()
    carry = _lists_from_words(w, B)
    body = make_body(int(n), int(ts_base) & _M64, B, A, id_group_full, table_rows)
    for r in order:
        body(carry, ev_rows[r])
    table_rows.write_back()
    _lists_to_words(carry, w, B)
    words[:size] = torch.from_numpy(w.view(np.int64)).to(words.device)


def finalize_plain(table, words, B: int, hist_fix=None) -> torch.Tensor:
    """Plain version of K3's tb_exact_finalize (the reference's
    _finalize_body): events named by `hist_fix` ((B,) bool/uint8 or
    None) whose result is 0 take the batch-final rows of their created
    record's accounts as snapshots; returns the (B, N_COLS) int64
    packed outputs."""
    A = table.shape[0]
    v = carry_views(words, B)
    out = torch.zeros((B, N_COLS), dtype=torch.int64, device=words.device)
    out[:, 0] = v["results"]
    out[:, 1] = v["created_mask"]
    out[:, 2:16] = v["created"].T
    for k, key in enumerate(("inb_status", "dstat", "pulse_create", "pulse_remove")):
        out[:, 16 + k] = v[key]
    out[0, 20] = v["scalars"][2] + 1
    hist_dr, hist_cr = v["hist_dr"], v["hist_cr"]
    if hist_fix is not None:
        fix = (hist_fix.to(torch.bool) & (v["results"] == 0))[:, None]
        dr = v["created"][CREATED_FIELDS.index("dr_slot")].clamp(0, A - 1)
        cr = v["created"][CREATED_FIELDS.index("cr_slot")].clamp(0, A - 1)
        hist_dr = torch.where(fix, table[dr], hist_dr)
        hist_cr = torch.where(fix, table[cr], hist_cr)
    out[:, 21:29] = hist_dr
    out[:, 29:37] = hist_cr
    return out


# ---------------------------------------------------------------------------
# Wrappers of K3's resumable entry points: CUDA tensors launch the
# kernel (raising on any CUDA error), CPU tensors run the plain version.


def _check_carry(words, B, device):
    if words.dtype != torch.int64 or words.dim() != 1 or words.numel() < scratch_words(B):
        raise ValueError(f"carry must be >= {scratch_words(B)} int64 words")
    if words.device != device or not words.is_contiguous():
        raise ValueError("carry must be contiguous on the table's device")


def exact_init(words, dstat_init) -> torch.Tensor:
    """The initial carry of a (B,)-row batch: `dstat_init` int32 (B,)."""
    B = dstat_init.shape[0]
    _check_carry(words, B, dstat_init.device)
    if dstat_init.dtype != torch.int32 or not dstat_init.is_contiguous():
        raise ValueError("dstat_init must be contiguous int32")
    if words.device.type == "cpu":
        return make_carry(words, dstat_init)
    kernels.exact_init(words, dstat_init)
    return words


def scan_segment(table, events, words, rows, n, ts_base) -> None:
    """A scan segment over the global event indices `rows` (int32),
    resuming from the carry; table and carry updated in place."""
    B = events.shape[0]
    _check_table_events(table, events, n)
    _check_carry(words, B, table.device)
    if rows.dtype != torch.int32 or rows.dim() != 1 or rows.device != table.device:
        raise ValueError("rows must be a 1-D int32 tensor on the table's device")
    if table.device.type == "cpu":
        scan_segment_plain(table, events, words, rows, n, ts_base)
        return
    kernels.exact_segment(table, events, rows.contiguous(), int(n), int(ts_base) & U64_MAX, words)


def finalize(table, words, B: int, hist_fix=None) -> torch.Tensor:
    """The (B, N_COLS) int64 packed outputs of the carry; `hist_fix` a
    (B,) uint8 mask on the table's device, or None."""
    _check_carry(words, B, table.device)
    if hist_fix is not None and (hist_fix.dtype != torch.uint8 or hist_fix.shape != (B,)
                                 or hist_fix.device != table.device):
        raise ValueError(f"hist_fix must be ({B},) uint8 on the table's device")
    if table.device.type == "cpu":
        return finalize_plain(table, words, B, hist_fix)
    out = torch.empty((B, N_COLS), dtype=torch.int64, device=table.device)
    kernels.exact_finalize(table, B, words,
                           None if hist_fix is None else hist_fix.contiguous(), out)
    return out

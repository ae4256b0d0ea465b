"""Seeded batches for the linked-chain (K5) and two-phase (K6) kernels.

Each case is (table (A, 8) u64, meta (A, 2) u32, pk (B, C) u64, n): the
packed batch as the host packers lay it out (``device_kernels`` column
layout), drawn so that every branch of the kernel is reached.  Slots
come from ``rows`` (default: every row of the table), so a caller can
place them anywhere in a large table.  numpy only: the CPU tests hand
the same inputs to the JAX package's kernels, the card checks to K5/K6.
"""

from __future__ import annotations

import numpy as np

from tigerbeetle_tpu_torch.state_machine import device_kernels as dk

M64 = (1 << 64) - 1

LINKED_SCENARIOS = (
    "passing", "limits", "chain_open", "static", "multi_iter", "nonconverge",
    "precond_hi", "precond_row_hi", "precond_row_lo", "precond_sum",
    "small_wrapped", "overflow", "padding",
)
TWO_PHASE_SCENARIOS = (
    "mixed", "inbatch", "durable", "races", "wide", "overflow", "underflow", "padding",
    "contended", "target_static", "hot", "distinct",
)


def _slot_cols(dr, cr):
    return (np.asarray(dr, np.int64) + 1).astype(np.uint64) | (
        (np.asarray(cr, np.int64) + 1).astype(np.uint64) << np.uint64(32)
    )


def _misc(flags, code, ledger):
    return (
        np.asarray(flags, np.uint64) | (np.asarray(code, np.uint64) << np.uint64(16))
        | (np.asarray(ledger, np.uint64) << np.uint64(32))
    )


def _tables(rng, A, rows, lim_p):
    """Funded balances (low limbs only, far below 2^61) and meta with a
    share `lim_p` of debit-limited and of credit-limited accounts, all
    on ledger 1."""
    table = np.zeros((A, 8), np.uint64)
    R = len(rows)
    table[rows, 0] = rng.integers(0, 200, R).astype(np.uint64)     # dp
    table[rows, 2] = rng.integers(0, 3000, R).astype(np.uint64)    # dpo
    table[rows, 4] = rng.integers(0, 200, R).astype(np.uint64)     # cp
    table[rows, 6] = rng.integers(0, 3000, R).astype(np.uint64)    # cpo
    meta = np.zeros((A, 2), np.uint32)
    meta[rows, 1] = 1
    r = rng.random(R)
    meta[rows, 0] = np.where(r < lim_p, dk.AF_DR_LIMIT,
                             np.where(r < 2 * lim_p, dk.AF_CR_LIMIT, 0))
    return table, meta


def linked_case(seed, B, scenario, A=1024, rows=None, n=None, pool=24):
    """One linked-chain batch leaning on `scenario` (LINKED_SCENARIOS).
    Chains of 1-5 events over a pool of `pool` accounts (by default a
    small one, so chains contend for the same limited balances)."""
    rng = np.random.default_rng(seed)
    rows = np.arange(A) if rows is None else np.asarray(rows)
    if n is None:
        n = B - 37 if scenario == "padding" else B
    pool = rows[rng.choice(len(rows), min(len(rows), pool), replace=False)]
    table, meta = _tables(rng, A, rows, 0.3)

    # Chains: F_LINKED on every member but the last.
    flags = np.zeros(B, np.uint32)
    i = 0
    while i < n:
        ln = int(rng.integers(1, 6))
        flags[i : min(i + ln, n) - 1] = dk.F_LINKED
        i += ln
    if scenario == "chain_open":
        flags[n - 1] = dk.F_LINKED
    dr = pool[rng.integers(0, len(pool), B)]
    cr = pool[rng.integers(0, len(pool), B)]
    pool = np.sort(pool)
    cr = np.where(cr == dr, pool[(np.searchsorted(pool, dr) + 1) % len(pool)], cr)
    amt = rng.integers(1, 1000, B).astype(np.uint64)
    amt_hi = np.zeros(B, np.uint64)
    bits = np.zeros(B, np.uint64)
    code = np.ones(B, np.uint32)
    ledger = np.ones(B, np.uint32)

    if scenario == "passing":
        meta[rows, 0] = 0
        meta[pool[:6], 0] = dk.AF_DR_LIMIT
        table[pool[:6], 6] = np.uint64(1 << 40)                    # ample credits
    elif scenario == "limits":
        amt = rng.integers(200, 2000, B).astype(np.uint64)
    elif scenario == "static":
        for bit in (dk.BIT_TS_NONZERO, dk.BIT_ID_ZERO, dk.BIT_SAME_ACCT,
                    dk.BIT_PEND_NONZERO, dk.BIT_CR_MAX):
            bits[rng.random(B) < 0.02] |= np.uint64(bit)
        flags[rng.random(B) < 0.01] |= np.uint32(1 << 7)          # reserved flag
        code[rng.random(B) < 0.02] = 0
        ledger[rng.random(B) < 0.02] = 2
        lost = rng.random(B) < 0.02
        dr = np.where(lost, -1, dr)                               # not found
    elif scenario in ("multi_iter", "nonconverge"):
        # A cascade: account k (debit-limited, unfunded) receives its
        # only credit from event k - 1, so event k passes iff event
        # k - 1 did; event 0 fails, and the Jacobi fixpoint learns one
        # more verdict per iteration (m + 1 iterations; the reference
        # stops at 64 and raises its precondition flag).
        m = 6 if scenario == "multi_iter" else 70
        casc = rows[rng.choice(len(rows), m + 1, replace=False)]
        casc.sort()
        meta[casc, 0] = dk.AF_DR_LIMIT
        table[casc] = 0
        off = int(rng.integers(0, n - m))
        dr[off : off + m] = casc[:m]
        cr[off : off + m] = casc[1:]
        amt[off : off + m] = 1
        flags[off : off + m] = 0
        if off > 0:
            flags[off - 1] &= np.uint32(~dk.F_LINKED & 0xFFFFFFFF)
    elif scenario == "precond_hi":
        amt_hi[int(rng.integers(0, n))] = 1
    elif scenario in ("precond_row_hi", "precond_row_lo"):
        lim = pool[(meta[pool, 0] & (dk.AF_DR_LIMIT | dk.AF_CR_LIMIT)) != 0]
        r = lim[0] if len(lim) else pool[0]
        meta[r, 0] = dk.AF_DR_LIMIT
        if scenario == "precond_row_hi":
            table[r, 3] = 1                                       # dpo hi limb
        else:
            table[r, 6] = np.uint64(1 << 61)                      # cpo >= 2^61
        dr[int(rng.integers(0, n))] = r
    elif scenario == "precond_sum":
        amt[: n // 2] = np.uint64(1 << 56)
    elif scenario == "small_wrapped":
        # Amounts whose u64 sum wraps below 2^31: a host router would
        # pick the small kernel, whose int32 prefixes then wrap too.
        amt[:] = 1
        amt[0] = np.uint64(1 << 63)
        amt[1] = np.uint64((1 << 63) + 3)
        amt[2] = np.uint64(M64 - 2)
    elif scenario == "overflow":
        meta[pool[-1], 0] = 0
        table[pool[-1], 2] = np.uint64(M64 - 5)                   # dpo near 2^128
        table[pool[-1], 3] = np.uint64(M64)
        dr[: n // 4] = pool[-1]
        meta[cr[: n // 4], 0] = 0
    dr = np.where(np.arange(B) < n, dr, -1)
    cr = np.where(np.arange(B) < n, cr, -1)

    pk = np.zeros((B, dk.N_COLS), np.uint64)
    pk[:n, dk.COL_BITS] = bits[:n]
    pk[:n, dk.COL_SLOTS] = _slot_cols(dr[:n], cr[:n])
    pk[:n, dk.COL_AMT_LO] = amt[:n]
    pk[:n, dk.COL_AMT_HI] = amt_hi[:n]
    pk[:n, dk.COL_MISC] = _misc(flags[:n], code[:n], ledger[:n])
    return table, meta, pk, n


# Contributions where the reference's float64 precondition sum (each
# amount rounded to float64, then summed) differs from the exact sum:
# 2^60 - 1 rounds up to 2^60, so the float total reaches 2^61 while
# the exact total stays below it.
FLOAT_SUM_AMOUNTS = {
    "round_2": (1 << 60, (1 << 60) - 1),
    "round_3": (1 << 60, 1 << 59, (1 << 59) - 1),
}


def float_sum_case(seed, B, amounts, A=1024, rows=None):
    """A passing-scenario batch of len(amounts) events carrying
    `amounts` (u64 each) as their amounts."""
    table, meta, pk, n = linked_case(seed, B, "passing", A=A, rows=rows, n=len(amounts))
    pk[:n, dk.COL_AMT_LO] = np.asarray(amounts, np.uint64)
    return table, meta, pk, n


def near_bound_amounts(seed, n, total):
    """n seeded amounts, each below 2^53 (exact in float64), summing to
    exactly `total` (about n * 2^52 at most)."""
    rng = np.random.default_rng(seed)
    w = rng.random(n) + 0.5
    amt = np.floor(w / w.sum() * total).astype(np.uint64)
    amt[0] += np.uint64(total - int(amt.astype(object).sum()))
    assert int(amt.max()) < 1 << 53 and int(amt.astype(object).sum()) == total
    return tuple(int(a) for a in amt)


def two_phase_case(seed, B, scenario, A=1024, rows=None, n=None):
    """One pending-create + post/void batch leaning on `scenario`
    (TWO_PHASE_SCENARIOS).  Post/voids name in-batch creators (earlier
    events), later events (not a target) or one of a few durable
    pendings, so first-wins races are common; the pv ladder's rungs are
    reached by perturbing a share of the finalizers.

    The later scenarios stress a kernel that claims a batch's rows and
    picks each target's winner across the whole batch: "contended"
    (five targets, each with hundreds of candidates spread over the
    batch, so the winner and its losers lie far apart), "target_static"
    (in-batch targets whose own static code fails, so their finalizers
    find nothing), "hot" (every event on the same two accounts) and
    "distinct" (every event on two rows of its own, 2B rows in all: it
    takes them from `rows` when that holds 2B, else spreads them over
    the table, which it widens to 2B rows when A is smaller)."""
    rng = np.random.default_rng(seed)
    rows = np.arange(A) if rows is None else np.asarray(rows)
    if n is None:
        n = B - 29 if scenario == "padding" else B
    wide = scenario == "wide"
    distinct = scenario == "distinct"
    if distinct and len(rows) < 2 * B:
        A = max(A, 2 * B)
        rows = np.sort(rng.choice(A, 2 * B, replace=False))
    table, meta = _tables(rng, A, rows, 0.0)
    table[rows, 0] += np.uint64(1 << 20)    # pending balances cover releases
    table[rows, 4] += np.uint64(1 << 20)
    if wide:
        table[rows, 1] = table[rows, 5] = 8  # ... of high-limb pendings too
    meta[rows[rng.random(len(rows)) < 0.05], 1] = 2

    amt_pool = [1, 5, 40, 300, 1000]
    iota = np.arange(B)
    pv_p = {"inbatch": 0.5, "durable": 0.5, "races": 0.6, "contended": 0.7}.get(scenario, 0.4)
    r = rng.random(B)
    kind = np.where(r < pv_p / 2, dk.F_POST, np.where(r < pv_p, dk.F_VOID, 0))
    kind = np.where((kind == 0) & (rng.random(B) < 0.6), dk.F_PENDING, kind)
    flags = kind.astype(np.uint32)
    bad = rng.random(B) < 0.02
    flags[bad] |= np.uint32(dk.F_POST | dk.F_VOID)
    flags[rng.random(B) < 0.01] |= np.uint32(dk.F_PENDING)
    flags[rng.random(B) < 0.01] |= np.uint32(1 << 7)
    is_pv = (flags & (dk.F_POST | dk.F_VOID)) != 0

    dr = rows[rng.integers(0, len(rows), B)]
    cr = rows[(np.searchsorted(rows, dr) + 1 + rng.integers(0, 7, B)) % len(rows)]
    if scenario == "hot":
        meta[rows[:2], 1] = 1
        dr, cr = np.full(B, rows[0]), np.full(B, rows[1])
    elif distinct:
        dr, cr = rows[0:2 * B:2].copy(), rows[1:2 * B:2].copy()
    amt = np.asarray(amt_pool, np.uint64)[rng.integers(0, len(amt_pool), B)]
    amt_hi = np.where(rng.random(B) < 0.3, rng.integers(1, 4, B), 0).astype(np.uint64) \
        if wide else np.zeros(B, np.uint64)
    code = np.ones(B, np.uint32)
    ledger = meta[dr, 1].copy()
    timeout = np.where(rng.random(B) < 0.01, 5, 0).astype(np.uint64)

    # Durable pendings: a few, so several finalizers race for each ("distinct":
    # one for each event, on its own rows).
    D = {"races": 3, "durable": 12, "contended": 2, "distinct": B}.get(scenario, 8)
    d_dr = rows[rng.integers(0, len(rows), D)]
    d_cr = rows[(np.searchsorted(rows, d_dr) + 1) % len(rows)]
    if scenario == "hot":
        d_dr, d_cr = np.full(D, rows[0]), np.full(D, rows[1])
    elif distinct:
        d_dr, d_cr = dr.copy(), cr.copy()
    d_amt = np.asarray(amt_pool, np.uint64)[rng.integers(0, len(amt_pool), D)]
    d_amt_hi = np.where(rng.random(D) < 0.5, 2, 0).astype(np.uint64) if wide \
        else np.zeros(D, np.uint64)
    d_flags = np.where(rng.random(D) < 0.85, dk.F_PENDING, 0).astype(np.uint32)
    d_status = rng.choice([1, 1, 1, 1, 2, 3, 4], size=D).astype(np.uint32)
    d_code = np.ones(D, np.uint32)
    d_ledger = meta[d_dr, 1].copy()
    if scenario == "underflow":
        table[d_dr, 0] = 0                  # releases exceed dp
        d_status[:] = 1
    if scenario == "overflow":
        table[dr[:8], 2] = np.uint64(M64 - 3)
        table[dr[:8], 3] = np.uint64(M64)
    if distinct:
        d_flags[:] = dk.F_PENDING
        d_status[:] = 1
    creators = np.flatnonzero((flags & dk.F_PENDING) != 0)
    if scenario == "contended":
        creators = creators[:3]
    elif scenario == "target_static":
        code[creators[rng.random(len(creators)) < 0.4]] = 0  # code_must_not_be_zero

    tgt_ev = np.full(B, -1, np.int64)
    p_tgt = np.full(B, -1, np.int64)
    p_found = np.zeros(B, bool)
    in_p = {"inbatch": 0.9, "durable": 0.1, "target_static": 0.9, "distinct": 0.0}.get(
        scenario, 0.5)
    for j in np.flatnonzero(is_pv):
        u = rng.random()
        if u < in_p and j > 0:
            # In-batch: an earlier pending creator, mostly.
            cands = creators[:np.searchsorted(creators, j)]
            k = int(cands[rng.integers(0, len(cands))]) if len(cands) and rng.random() < 0.9 \
                else int(rng.integers(0, j))
            tgt_ev[j] = k
            src_dr, src_cr, src_amt, src_hi = dr[k], cr[k], amt[k], amt_hi[k]
            src_code, src_ledger = code[k], ledger[k]
        elif u < 0.95:
            t = j if distinct else int(rng.integers(0, D))
            p_tgt[j] = t
            p_found[j] = True
            if rng.random() < 0.1:
                tgt_ev[j] = int(rng.integers(j, B))                 # a later event
            src_dr, src_cr, src_amt, src_hi = d_dr[t], d_cr[t], d_amt[t], d_amt_hi[t]
            src_code, src_ledger = d_code[t], d_ledger[t]
        else:
            continue                                                # not found
        dr[j], cr[j] = src_dr, src_cr
        ledger[j] = src_ledger if rng.random() < 0.5 else 0
        code[j] = src_code if rng.random() < 0.5 else 0
        if rng.random() < 0.5:
            amt[j], amt_hi[j] = 0, 0                                # inherit
        else:
            amt[j], amt_hi[j] = src_amt, src_hi
        w = rng.random()
        if w < 0.05:
            amt[j] = src_amt + np.uint64(1)                         # exceeds
        elif w < 0.1:
            amt[j] = max(src_amt, np.uint64(2)) - np.uint64(1)      # void: different
        elif w < 0.13:
            ledger[j] = 2
        elif w < 0.16:
            code[j] = 2

    bits = dk._predicate_bits(
        np.uint64, B, iota.astype(np.uint64) + np.uint64(1), np.zeros(B, np.uint64),
        np.asarray(dr, np.uint64) + np.uint64(1), np.zeros(B, np.uint64),
        np.asarray(cr, np.uint64) + np.uint64(1), np.zeros(B, np.uint64),
        np.where(is_pv, 7, 0).astype(np.uint64), np.zeros(B, np.uint64),
        rng.random(B) < 0.01,
    )
    bits[is_pv & (rng.random(B) < 0.02)] &= ~np.uint64(dk.BIT_PEND_NONZERO)
    bits[is_pv & (rng.random(B) < 0.01)] |= np.uint64(dk.BIT_PEND_SELF)
    bits[p_found] |= np.uint64(dk.BIT_P_FOUND)
    dr_set = rng.random(B) < 0.4
    cr_set = rng.random(B) < 0.4
    bits[dr_set] |= np.uint64(dk.BIT_T_DR_SET)
    bits[cr_set] |= np.uint64(dk.BIT_T_CR_SET)
    bits[rng.random(B) < 0.97] |= np.uint64(dk.BIT_DR_EQ_P)
    bits[rng.random(B) < 0.97] |= np.uint64(dk.BIT_CR_EQ_P)

    pt = np.clip(p_tgt, 0, None)
    pk = np.zeros((B, dk.N_COLS_TP), np.uint64)
    pk[:n, dk.COL_BITS] = bits[:n]
    pk[:n, dk.COL_SLOTS] = _slot_cols(np.where(is_pv, -1, dr), np.where(is_pv, -1, cr))[:n]
    pk[:n, dk.COL_AMT_LO] = amt[:n]
    pk[:n, dk.COL_AMT_HI] = amt_hi[:n]
    pk[:n, dk.COL_MISC] = _misc(flags, code, ledger)[:n]
    pk[:n, dk.COL_TIMEOUT] = (timeout | (
        (p_tgt + 1).astype(np.uint64) << np.uint64(32)))[:n]
    pk[:n, dk.COL_TP_JOIN] = np.where(
        p_found, _misc(d_flags[pt], d_code[pt], d_ledger[pt]), 0)[:n]
    pk[:n, dk.COL_TP_SLOTS] = np.where(p_found, _slot_cols(d_dr[pt], d_cr[pt]), 0)[:n]
    pk[:n, dk.COL_TP_AMT_LO] = np.where(p_found, d_amt[pt], 0)[:n]
    pk[:n, dk.COL_TP_AMT_HI] = np.where(p_found, d_amt_hi[pt], 0)[:n]
    pk[:n, dk.COL_TP_REF] = (
        (tgt_ev + 1).astype(np.uint64)
        | (np.where(p_found, d_status[pt], 0).astype(np.uint64) << np.uint64(32))
    )[:n]
    return table, meta, pk, n

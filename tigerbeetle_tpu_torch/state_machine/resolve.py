"""Host resolvers of order-dependent batches and the wave partitioner's
dependency metadata (numpy).

Counterpart of ``tigerbeetle_tpu/state_machine/resolve.py``, copied as
it is:

- ``linked_resolve``: linked-chain / limit-account batches of plain
  posted transfers, a Jacobi fixpoint over per-account segmented prefix
  sums that lands on the sequential verdicts (each iteration recomputes
  every limit check from the previous pass/fail guesses; event 0's
  verdict is unconditional, and inductively every later one).
- ``two_phase_resolve``: post/void batches whose verdicts do not depend
  on balances, in closed form (vectorized ladder + first-wins winner per
  pending target).
- ``wave_dependency_metadata`` (what each event of a batch claims, reads
  and writes), ``spec_meta_from_events`` (the same from a padded event
  dict, for the speculative dispatcher's residue planner).

Both resolvers are exact (every code, rollback and balance effect of
the reference semantics, src/state_machine.zig:1220-1306, :1462-1741);
a None return means "not resolvable here" and the caller takes the
exact path.  The host engine runs them only without its native library
(TB_FASTPATH_DISABLE), as the reference does without a compiler.
"""

from __future__ import annotations

import numpy as np

from tigerbeetle_tpu_torch.types import AccountFlags, CreateTransferResult, TransferFlags

AF = AccountFlags
TF = TransferFlags
CTR = CreateTransferResult

_LIM = np.uint32(
    AF.debits_must_not_exceed_credits | AF.credits_must_not_exceed_debits
)

# Pending statuses (reference: src/tigerbeetle.zig:113-125).
S_NONE, S_PENDING, S_POSTED, S_VOIDED, S_EXPIRED = 0, 1, 2, 3, 4

# Bound under which all limit arithmetic provably fits in uint64:
# every initial balance component and the batch amount total must stay
# below 2^61, so dp+dpo+running+amount < 4*2^61 < 2^64.
_U64_SAFE = np.uint64(1) << np.uint64(61)


def _exclusive_prefix(values: np.ndarray) -> np.ndarray:
    """[0, v0, v0+v1, ...] — prefix sums excluding the element itself."""
    out = np.empty(len(values) + 1, values.dtype)
    out[0] = 0
    np.cumsum(values, out=out[1:])
    return out


def linked_resolve(
    static: np.ndarray,
    ts_nonzero: np.ndarray,
    flags: np.ndarray,
    dr_slot: np.ndarray,
    cr_slot: np.ndarray,
    amount_lo: np.ndarray,
    amount_hi: np.ndarray,
    dr_flags: np.ndarray,
    cr_flags: np.ndarray,
    mirror,
    max_iters: int = 64,
):
    """Exact verdicts for a linked-chain batch of plain posted transfers.

    Preconditions (checked by the router in tpu.py): no pending /
    post/void / balancing flags anywhere in the batch, ids unique with
    no durable duplicates, no history-flag accounts.  Limit-flag
    accounts ARE allowed — they're the point.

    Returns (results, last_applied, iterations) or None when the batch
    needs the serial exact engine (u128-scale balances, or fixpoint
    cap exceeded).

    reference: src/state_machine.zig:1220-1306 (chain/rollback loop),
    src/tigerbeetle.zig:31-39 (limit formulas).
    """
    n = len(static)
    assert n > 0
    if amount_hi.any():
        return None

    # --- chain structure (chains are contiguous: a chain is a maximal
    # run of linked-flag events plus the first non-linked event after).
    linked = (flags & np.uint32(TF.linked)) != 0
    start = np.empty(n, bool)
    start[0] = True
    if n > 1:
        start[1:] = ~linked[:-1]
    chain_id = np.cumsum(start) - 1
    chain_start_ev = np.flatnonzero(start)
    chain_last_ev = np.append(chain_start_ev[1:] - 1, n - 1)
    start_of_ev = chain_start_ev[chain_id]

    # Per-event unconditional codes.  Precedence: chain_open (last
    # event only) > timestamp_must_be_zero > static ladder
    # (reference: src/state_machine.zig:1236-1256).
    code0 = np.where(
        ts_nonzero, np.uint32(CTR.timestamp_must_be_zero), static
    ).astype(np.uint32)
    if linked[n - 1]:
        code0[n - 1] = np.uint32(CTR.linked_event_chain_open)
    static_ok = code0 == 0

    # --- limit-check entry lists.  Running balance sums are needed
    # only at accounts carrying a limit flag; events that already
    # failed statically never contribute or view.
    dlim = (dr_flags & np.uint32(AF.debits_must_not_exceed_credits)) != 0
    clim = (cr_flags & np.uint32(AF.credits_must_not_exceed_debits)) != 0
    ent_d = static_ok & ((dr_flags & _LIM) != 0)
    ent_c = static_ok & ((cr_flags & _LIM) != 0)

    ev_d = np.flatnonzero(ent_d)
    ev_c = np.flatnonzero(ent_c)
    n_d = len(ev_d)
    evs = np.concatenate([ev_d, ev_c])
    m = len(evs)

    dr_fail = np.zeros(n, bool)
    cr_fail = np.zeros(n, bool)
    iterations = 0

    if m:
        eslot = np.concatenate([dr_slot[ev_d], cr_slot[ev_c]]).astype(np.int64)
        # uint64-exactness precondition on every touched limited slot.
        lim_slots = np.unique(eslot)
        if mirror.hi[lim_slots].any():
            return None
        if (mirror.lo[lim_slots] >= _U64_SAFE).any():
            return None
        contrib = amount_lo[static_ok]
        if float(contrib.astype(np.float64).sum()) >= float(_U64_SAFE):
            return None

        eamt = np.concatenate([amount_lo[ev_d], amount_lo[ev_c]])
        edeb = np.zeros(m, bool)
        edeb[:n_d] = True
        # (slot, event) sort; keys unique (dr==cr events fail
        # accounts_must_be_different statically, so never enter).
        key = (eslot << np.int64(32)) | evs.astype(np.int64)
        order = np.argsort(key)
        evs, eslot, eamt, edeb, key = (
            evs[order], eslot[order], eamt[order], edeb[order], key[order]
        )
        seg_new = np.empty(m, bool)
        seg_new[0] = True
        seg_new[1:] = eslot[1:] != eslot[:-1]
        seg_first = np.maximum.accumulate(np.where(seg_new, np.arange(m), 0))
        # Boundary position splitting "earlier chains" from "my chain".
        bkey = (eslot << np.int64(32)) | start_of_ev[evs].astype(np.int64)
        bpos = np.searchsorted(key, bkey, side="left")
        jpos = np.arange(m)

        init_dp = mirror.lo[eslot, 0]
        init_dpo = mirror.lo[eslot, 1]
        init_cp = mirror.lo[eslot, 2]
        init_cpo = mirror.lo[eslot, 3]
        view_d = edeb & dlim[evs]
        view_c = ~edeb & clim[evs]
        amt_d = np.where(edeb, eamt, np.uint64(0))
        amt_c = np.where(edeb, np.uint64(0), eamt)

        pass_prev = static_ok.copy()
        fails = ~pass_prev
        F = np.cumsum(fails)
        base = (F - fails)[chain_start_ev]
        applied_prefix = (F - base[chain_id]) == 0
        chain_ok = applied_prefix[chain_last_ev]

        for iterations in range(1, max_iters + 1):
            wce = chain_ok[chain_id][evs]
            wie = applied_prefix[evs]
            Pdc = _exclusive_prefix(np.where(wce, amt_d, np.uint64(0)))
            Pcc = _exclusive_prefix(np.where(wce, amt_c, np.uint64(0)))
            Pdi = _exclusive_prefix(np.where(wie, amt_d, np.uint64(0)))
            Pci = _exclusive_prefix(np.where(wie, amt_c, np.uint64(0)))
            deb_before = (Pdc[bpos] - Pdc[seg_first]) + (Pdi[jpos] - Pdi[bpos])
            cred_before = (Pcc[bpos] - Pcc[seg_first]) + (Pci[jpos] - Pci[bpos])

            # reference: src/tigerbeetle.zig:31-39 — dp+dpo+amount
            # must not exceed cpo (debit side), cp+cpo+amount must not
            # exceed dpo (credit side).  All terms < 2^61 by the
            # precondition, so uint64 arithmetic is exact.
            bad_d = view_d & (
                init_dp + init_dpo + deb_before + eamt
                > init_cpo + cred_before
            )
            bad_c = view_c & (
                init_cp + init_cpo + cred_before + eamt
                > init_dpo + deb_before
            )
            dr_fail[:] = False
            cr_fail[:] = False
            dr_fail[evs[bad_d]] = True
            cr_fail[evs[bad_c]] = True
            pass_ = static_ok & ~dr_fail & ~cr_fail

            fails = ~pass_
            F = np.cumsum(fails)
            base = (F - fails)[chain_start_ev]
            applied_prefix = (F - base[chain_id]) == 0
            chain_ok = applied_prefix[chain_last_ev]
            if (pass_ == pass_prev).all():
                break
            pass_prev = pass_
        else:
            return None  # fixpoint cap exceeded — serial engine decides
        pass_ = pass_prev
    else:
        # No limit accounts touched: verdicts are purely static.
        pass_ = static_ok
        fails = ~pass_
        F = np.cumsum(fails)
        base = (F - fails)[chain_start_ev]
        applied_prefix = (F - base[chain_id]) == 0
        chain_ok = applied_prefix[chain_last_ev]

    # --- result codes.  Within a failed chain, the FIRST failing
    # member carries its own code; everyone else gets
    # linked_event_failed; chain_open sticks to the last batch event
    # even when the chain broke earlier (reference:
    # src/state_machine.zig:1240-1248,1276-1284).
    results = np.zeros(n, np.uint32)
    bad_chain = ~chain_ok
    if bad_chain.any():
        member_bad = bad_chain[chain_id]
        fail_pos = np.where(~pass_, np.arange(n), n)
        first_fail = np.minimum.reduceat(fail_pos, chain_start_ev)
        ff = first_fail[bad_chain]
        assert (ff < n).all()
        results[member_bad] = np.uint32(CTR.linked_event_failed)
        own = np.where(
            code0[ff] != 0,
            code0[ff],
            np.where(
                dr_fail[ff],
                np.uint32(CTR.exceeds_credits),
                np.uint32(CTR.exceeds_debits),
            ),
        )
        results[ff] = own
        if linked[n - 1]:
            results[n - 1] = np.uint32(CTR.linked_event_chain_open)

    applied_any = np.flatnonzero(applied_prefix)
    last_applied = int(applied_any[-1]) if len(applied_any) else -1
    return results, last_applied, iterations


def _u128_gt(a_lo, a_hi, b_lo, b_hi):
    return (a_hi > b_hi) | ((a_hi == b_hi) & (a_lo > b_lo))


def two_phase_resolve(
    static: np.ndarray,
    ts_nonzero: np.ndarray,
    flags: np.ndarray,
    is_pv: np.ndarray,
    # raw event fields
    dr_lo, dr_hi, cr_lo, cr_hi,
    amount_lo, amount_hi,
    ud128_lo, ud128_hi, ud64, ud32,
    ledger, code,
    # in-batch pending-target resolution
    tgt_ev: np.ndarray,      # event index creating the referenced id, -1
    # durable pending-target join (full-n arrays from gather_p)
    p_found: np.ndarray,
    p_tgt: np.ndarray,       # unique durable-target index per event, -1
    p_join: dict,            # gathered columns of the durable target
    dstat_init: np.ndarray,  # status per unique durable target
    attrs,                   # account attribute columns (id lookup)
):
    """Closed-form verdicts for a two-phase batch.

    Preconditions (router): no linked / balancing flags, ids unique
    with no durable duplicates, all event timeouts zero, durable
    targets have timeout zero, in-batch targets carry the pending
    flag, and no touched account (including durable targets' accounts)
    has limit or history flags.  Under those, no verdict depends on
    balance state, so one vectorized pass is exact — the only
    inter-event couplings are "pending must exist before me" (an index
    compare) and "first finalizer wins" (a min-reduce per target).

    Returns None if an unsupported shape sneaks through, else a dict
    with results, resolved pv fields, winner bookkeeping.

    reference: src/state_machine.zig:1608-1741 post_or_void.
    """
    n = len(static)
    pend_flag = (flags & np.uint32(TF.pending)) != 0

    code_out = np.where(
        ts_nonzero, np.uint32(CTR.timestamp_must_be_zero), static
    ).astype(np.uint32)

    # --- pv ladder beyond the static prefix.
    pv = is_pv & (code_out == 0)
    idx = np.arange(n)
    in_batch = pv & (tgt_ev >= 0) & (tgt_ev < idx)
    # In-batch target must itself have been created: pending creates
    # succeed iff their own unconditional code is zero.
    tgt_c = np.clip(tgt_ev, 0, None)
    tgt_created = in_batch & (code_out[tgt_c] == 0)
    durable = pv & p_found & ~in_batch
    found = tgt_created | durable
    _apply(code_out, pv & ~found, CTR.pending_transfer_not_found)

    # not_pending: durable target without the pending flag.  (In-batch
    # non-pending targets are excluded by the router.)
    p_flags = np.where(
        in_batch, flags[tgt_c], p_join["flags"].astype(np.uint32)
    )
    _apply(
        code_out,
        found & ((p_flags & np.uint32(TF.pending)) == 0),
        CTR.pending_transfer_not_pending,
    )

    # Unified target fields (in-batch event columns or durable join).
    def pick(batch_col, join_col):
        return np.where(in_batch, batch_col[tgt_c], join_col)

    pj_dr = np.clip(p_join["dr_slot"].astype(np.int64), 0, None)
    pj_cr = np.clip(p_join["cr_slot"].astype(np.int64), 0, None)
    p_dr_lo = pick(dr_lo, attrs["id_lo"][pj_dr])
    p_dr_hi = pick(dr_hi, attrs["id_hi"][pj_dr])
    p_cr_lo = pick(cr_lo, attrs["id_lo"][pj_cr])
    p_cr_hi = pick(cr_hi, attrs["id_hi"][pj_cr])
    p_amt_lo = pick(amount_lo, p_join["amount_lo"].astype(np.uint64))
    p_amt_hi = pick(amount_hi, p_join["amount_hi"].astype(np.uint64))
    p_ledger = pick(ledger.astype(np.uint32), p_join["ledger"].astype(np.uint32))
    p_code = pick(code, p_join["code"].astype(np.uint32))
    p_ud128_lo = pick(ud128_lo, p_join["ud128_lo"].astype(np.uint64))
    p_ud128_hi = pick(ud128_hi, p_join["ud128_hi"].astype(np.uint64))
    p_ud64 = pick(ud64, p_join["ud64"].astype(np.uint64))
    p_ud32 = pick(ud32, p_join["ud32"].astype(np.uint32))

    # Mismatch ladder (reference: src/state_machine.zig:1647-1664).
    t_dr_set = (dr_lo != 0) | (dr_hi != 0)
    t_cr_set = (cr_lo != 0) | (cr_hi != 0)
    _apply(
        code_out,
        found & t_dr_set & ((dr_lo != p_dr_lo) | (dr_hi != p_dr_hi)),
        CTR.pending_transfer_has_different_debit_account_id,
    )
    _apply(
        code_out,
        found & t_cr_set & ((cr_lo != p_cr_lo) | (cr_hi != p_cr_hi)),
        CTR.pending_transfer_has_different_credit_account_id,
    )
    _apply(
        code_out,
        found & (ledger > 0) & (ledger.astype(np.uint32) != p_ledger),
        CTR.pending_transfer_has_different_ledger,
    )
    _apply(
        code_out,
        found & (code > 0) & (code != p_code),
        CTR.pending_transfer_has_different_code,
    )

    # Amount resolution: zero means inherit (reference: :1666-1671).
    t_amt_set = (amount_lo != 0) | (amount_hi != 0)
    res_amt_lo = np.where(t_amt_set, amount_lo, p_amt_lo)
    res_amt_hi = np.where(t_amt_set, amount_hi, p_amt_hi)
    _apply(
        code_out,
        found & _u128_gt(res_amt_lo, res_amt_hi, p_amt_lo, p_amt_hi),
        CTR.exceeds_pending_transfer_amount,
    )
    void = (flags & np.uint32(TF.void_pending_transfer)) != 0
    _apply(
        code_out,
        found & void & _u128_gt(p_amt_lo, p_amt_hi, res_amt_lo, res_amt_hi),
        CTR.pending_transfer_has_different_amount,
    )

    # Durable targets whose status is already final fail every
    # referencing event with the status code (reference: :1673-1683).
    if len(dstat_init):
        dstat_ev = np.where(
            durable & (p_tgt >= 0), dstat_init[np.clip(p_tgt, 0, None)],
            np.uint32(S_PENDING),
        )
    else:
        dstat_ev = np.full(n, np.uint32(S_PENDING))
    _apply(code_out, durable & (dstat_ev == S_POSTED),
           CTR.pending_transfer_already_posted)
    _apply(code_out, durable & (dstat_ev == S_VOIDED),
           CTR.pending_transfer_already_voided)
    _apply(code_out, durable & (dstat_ev == S_EXPIRED),
           CTR.pending_transfer_expired)

    # --- winner per target: among candidates that passed everything
    # above, the lowest event index finalizes; later ones fail with
    # the winner's status code.
    cand = pv & (code_out == 0)
    post = (flags & np.uint32(TF.post_pending_transfer)) != 0
    winner = np.zeros(n, bool)
    cand_idx = np.flatnonzero(cand)
    if len(cand_idx):
        # Key: in-batch targets by creating event, durable by unique
        # target index (disjoint ranges via sign).
        tkey = np.where(
            in_batch[cand_idx], -(tgt_ev[cand_idx].astype(np.int64) + 1),
            p_tgt[cand_idx].astype(np.int64),
        )
        order = np.lexsort((cand_idx, tkey))
        sk = tkey[order]
        si = cand_idx[order]
        first = np.empty(len(sk), bool)
        first[0] = True
        first[1:] = sk[1:] != sk[:-1]
        winner[si[first]] = True
        if not first.all():
            bounds = np.flatnonzero(first)
            sizes = np.diff(np.append(bounds, len(sk)))
            win_rep = np.repeat(si[first], sizes)
            losers = si[~first]
            win_of_loser = win_rep[~first]
            code_out[losers] = np.where(
                post[win_of_loser],
                np.uint32(CTR.pending_transfer_already_posted),
                np.uint32(CTR.pending_transfer_already_voided),
            )

    ok = code_out == 0
    applied_any = np.flatnonzero(ok)
    last_applied = int(applied_any[-1]) if len(applied_any) else -1

    return {
        "results": code_out,
        "ok": ok,
        "winner": winner,
        "post": post,
        "pend_flag": pend_flag,
        "in_batch": in_batch,
        "durable": durable,
        "tgt_ev": tgt_ev,
        "res_amt_lo": res_amt_lo,
        "res_amt_hi": res_amt_hi,
        "p_amt_lo": p_amt_lo,
        "p_amt_hi": p_amt_hi,
        "p_ledger": p_ledger,
        "p_code": p_code,
        "p_ud128_lo": p_ud128_lo,
        "p_ud128_hi": p_ud128_hi,
        "p_ud64": p_ud64,
        "p_ud32": p_ud32,
        "last_applied": last_applied,
    }


def _apply(code_out: np.ndarray, cond: np.ndarray, code) -> None:
    np.copyto(code_out, np.uint32(code), where=(code_out == 0) & cond)



def spec_meta_from_events(ev: dict, n: int, pv_serial: bool) -> dict:
    """wave_dependency_metadata rebuilt from a (B,)-padded host event
    dict (kernel.EVENT_FIELDS contract): the speculative dispatcher
    plans its residue at window launch, where the padded arrays are all
    that is left of the submit-time joins.  The same values the submit
    path passed, so the same metadata."""
    return wave_dependency_metadata(
        n,
        np.asarray(ev["flags"][:n], np.uint32),
        ev["dr_slot"][:n].astype(np.int64),
        ev["cr_slot"][:n].astype(np.int64),
        np.asarray(ev["dr_flags"][:n], np.uint32),
        np.asarray(ev["cr_flags"][:n], np.uint32),
        ev["id_group"][:n].astype(np.int64),
        ev["p_group"][:n].astype(np.int64),
        ev["p_tgt"][:n].astype(np.int64),
        np.asarray(ev["p_found"][:n], bool),
        ev["p_dr_slot"][:n].astype(np.int64),
        ev["p_cr_slot"][:n].astype(np.int64),
        pv_serial=pv_serial,
    )


def wave_dependency_metadata(
    n: int,
    flags: np.ndarray,
    dr_slot: np.ndarray,
    cr_slot: np.ndarray,
    dr_flags: np.ndarray,
    cr_flags: np.ndarray,
    id_group: np.ndarray,
    p_group: np.ndarray,
    p_tgt: np.ndarray,
    p_found: np.ndarray,
    p_dr_slot: np.ndarray,
    p_cr_slot: np.ndarray,
    pv_serial: bool = False,
) -> dict:
    """Per-event dependency metadata for waves.plan_waves.

    - ``chain_member``: the event runs outside plain waves — a linked
      chain member (the closing event included), an event on a history
      account (its snapshot must be sequential), or, with
      ``pv_serial``, any post/void.  ``chain_linked`` is the linked-run
      part alone, ``chain_serial`` the must-scan part; a chain run with
      no serial member may run as a chain wave.
    - ``is_pv``: post/void flag.
    - ``id_group`` / ``p_group`` / ``p_tgt``: the exact path's compact
      reference tokens; two events conflict when both claim one.
    - ``writes0/1``: slots whose balance columns the apply ADDS to
      (normal: dr/cr; post/void: the durable target's accounts), -1
      for none.  ``reads0/1``: slots whose balance the verdict or the
      applied amount reads (balancing clamps, limit checks), -1 none.
    - ``inb_pv``: a post/void naming an in-batch id (its write set
      widens to that id-group's slot union, from ``ev_dr`` / ``ev_cr``).
    """
    TFv = np.uint32
    linked = (flags & TFv(TF.linked)) != 0
    is_pv = (flags & TFv(TF.post_pending_transfer | TF.void_pending_transfer)) != 0
    chain_linked = linked.copy()
    if n > 1:
        chain_linked[1:] |= linked[:-1]
    hist = ((dr_flags | cr_flags) & TFv(AF.history)) != 0
    chain_serial = hist & ~is_pv
    if pv_serial:
        chain_serial = chain_serial | is_pv
    chain_member = chain_linked | chain_serial

    bal_dr = (flags & TFv(TF.balancing_debit)) != 0
    bal_cr = (flags & TFv(TF.balancing_credit)) != 0
    read_dr = (
        (bal_dr | ((dr_flags & TFv(AF.debits_must_not_exceed_credits)) != 0))
        & (dr_slot >= 0) & ~is_pv
    )
    read_cr = (
        (bal_cr | ((cr_flags & TFv(AF.credits_must_not_exceed_debits)) != 0))
        & (cr_slot >= 0) & ~is_pv
    )

    neg = np.int64(-1)
    dr64 = dr_slot.astype(np.int64)
    cr64 = cr_slot.astype(np.int64)
    pdr64 = np.where(p_found, p_dr_slot.astype(np.int64), neg)
    pcr64 = np.where(p_found, p_cr_slot.astype(np.int64), neg)
    writes0 = np.where(is_pv, pdr64, np.where(dr_slot >= 0, dr64, neg))
    writes1 = np.where(is_pv, pcr64, np.where(cr_slot >= 0, cr64, neg))
    reads0 = np.where(read_dr, dr64, neg)
    reads1 = np.where(read_cr, cr64, neg)

    return {
        "chain_member": chain_member,
        "chain_linked": chain_linked,
        "chain_serial": chain_serial,
        "linked": linked,
        "is_pv": is_pv,
        "id_group": np.asarray(id_group, np.int64),
        "p_group": np.asarray(p_group, np.int64),
        "p_tgt": np.asarray(p_tgt, np.int64),
        "writes0": writes0,
        "writes1": writes1,
        "reads0": reads0,
        "reads1": reads1,
        "inb_pv": is_pv & (np.asarray(p_group) >= 0),
        "ev_dr": np.where(dr_slot >= 0, dr64, neg),
        "ev_cr": np.where(cr_slot >= 0, cr64, neg),
    }

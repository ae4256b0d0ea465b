"""The order-free, linked and two-phase kernels on hand-computed cases.

    python -m tigerbeetle_tpu_torch.experiments.kernel_smoke [--device D] [--quick]

Counterpart of the reference's experiments/kernel_smoke.py: the same
eight cases, each with the table, ring summary and result codes worked
out by hand, through the wrappers of ``state_machine/device_kernels.py``
(K1, K5 and K6 on a card, their plain versions on the CPU).  tests/
test_torch_kernel_smoke.py runs every case on the CPU; ``run`` raises on
the first case that does not hold and returns the cases it ran.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tigerbeetle_tpu_torch.experiments import common
from tigerbeetle_tpu_torch.state_machine import device_kernels as dk
from tigerbeetle_tpu_torch.types import CreateTransferResult as CTR

KEYS = ("cases",)
A = 64


def mk_tables(dev, n_acct=8, ledger=1, acct_flags=None):
    table = torch.zeros((A, 8), dtype=torch.int64, device=dev)
    meta = np.zeros((A, 2), np.uint32)
    meta[:n_acct, 1] = ledger
    if acct_flags is not None:
        meta[: len(acct_flags), 0] = acct_flags
    return table, torch.from_numpy(meta.view(np.int32)).to(dev)


def base_pack(n, dr_slot, cr_slot, amt, flags=None, ids=None, pend=None, timeout=None,
              n_cols=dk.N_COLS, p_found=None, p_tgt=None):
    z = np.zeros(n, np.uint64)
    ids = np.arange(1, n + 1, dtype=np.uint64) if ids is None else ids
    pend = z if pend is None else pend
    dr_s = np.asarray(dr_slot, np.int64)
    cr_s = np.asarray(cr_slot, np.int64)
    return dk.pack_base(
        n, id_lo=ids, id_hi=z,
        dr_lo=np.where(dr_s < 0, 0, dr_s + 100).astype(np.uint64), dr_hi=z,
        cr_lo=np.where(cr_s < 0, 0, cr_s + 100).astype(np.uint64), cr_hi=z,
        pend_lo=pend, pend_hi=z,
        amount_lo=np.asarray(amt, np.uint64), amount_hi=z,
        flags=np.zeros(n, np.uint32) if flags is None else np.asarray(flags, np.uint32),
        ledger=np.ones(n, np.uint32), code=np.ones(n, np.uint32),
        timeout=np.zeros(n, np.uint32) if timeout is None else timeout,
        ts_nonzero=np.zeros(n, bool), dr_slot=dr_s, cr_slot=cr_s,
        e_found=np.zeros(n, bool), p_found=p_found, p_tgt=p_tgt, n_cols=n_cols,
    )


def _run(fn, dev, table, meta, ring_at, pk, n, ts):
    ring = torch.zeros((4, dk.SUMMARY_WORDS), dtype=torch.int64, device=dev)
    pk_t = torch.from_numpy(np.ascontiguousarray(pk).view(np.int64)).to(dev)
    fn(table, meta, ring, ring_at, pk_t, n, ts)
    s = dk.unpack_summary(ring[ring_at].cpu().numpy().view(np.uint64))
    return table.cpu().numpy().view(np.uint64), s


def _codes(s):
    return dict(zip(s["fail_idx"].tolist(), s["fail_codes"].tolist()))


def orderfree_ok(dev):
    """3 ok transfers + 1 bad (same account)."""
    table, meta = mk_tables(dev)
    pk = base_pack(4, [0, 1, 2, 3], [1, 2, 3, 3], [10, 20, 30, 40])
    tbl, s = _run(dk.orderfree, dev, table, meta, 0, pk, 4, 1000)
    common.check(s["n_fail"] == 1 and s["fail_idx"][0] == 3, str(s))
    common.check(s["fail_codes"][0] == CTR.accounts_must_be_different, str(s))
    common.check(not s["overflow"] and s["last_applied"] == 2, str(s))
    common.check(tbl[0, 2] == 10 and tbl[1, 2] == 20 and tbl[1, 6] == 10, "balances")
    common.check(tbl[3, 6] == 30 and tbl[3, 2] == 0, "balances")


def orderfree_pending(dev):
    table, meta = mk_tables(dev)
    pk = base_pack(2, [0, 1], [1, 2], [5, 7], flags=np.array([dk.F_PENDING, 0], np.uint32),
                   timeout=np.array([3, 0], np.uint32))
    tbl, s = _run(dk.orderfree, dev, table, meta, 1, pk, 2, 1000)
    common.check(s["n_fail"] == 0, str(s))
    common.check(tbl[0, 0] == 5 and tbl[1, 4] == 5 and tbl[1, 2] == 7, "balances")


def linked_static_fail(dev):
    """A chain of 3 with the middle failing statically: all fail."""
    table, meta = mk_tables(dev)
    pk = base_pack(3, [0, 1, 2], [1, 1, 0], [10, 20, 30],
                   flags=np.array([dk.F_LINKED, dk.F_LINKED, 0], np.uint32))
    tbl, s = _run(dk.linked, dev, table, meta, 0, pk, 3, 1000)
    common.check(s["n_fail"] == 3, str(s))
    codes = _codes(s)
    common.check(codes[1] == CTR.accounts_must_be_different, str(codes))
    common.check(codes[0] == codes[2] == CTR.linked_event_failed, str(codes))
    common.check(tbl.sum() == 0, "the table changed")


def linked_limit(dev):
    """Account 0 debits_must_not_exceed_credits, 50 credited: the first
    40 debit passes, the second fails."""
    table, meta = mk_tables(dev, acct_flags=np.array([2, 0, 0], np.uint32))
    table[0, 6] = 50
    pk = base_pack(2, [0, 0], [1, 2], [40, 40])
    tbl, s = _run(dk.linked, dev, table, meta, 1, pk, 2, 1000)
    common.check(s["n_fail"] == 1 and s["fail_idx"][0] == 1, str(s))
    common.check(s["fail_codes"][0] == CTR.exceeds_credits, str(s))
    common.check(tbl[0, 2] == 40 and tbl[1, 6] == 40, "balances")


def linked_rollback(dev):
    """A chain rolls back on a limit failure."""
    table, meta = mk_tables(dev, acct_flags=np.array([2, 0, 0], np.uint32))
    table[0, 6] = 50
    pk = base_pack(3, [1, 0, 2], [2, 1, 0], [10, 60, 5],
                   flags=np.array([dk.F_LINKED, dk.F_LINKED, 0], np.uint32))
    tbl, s = _run(dk.linked, dev, table, meta, 2, pk, 3, 1000)
    common.check(s["n_fail"] == 3, str(s))
    codes = _codes(s)
    common.check(codes[1] == CTR.exceeds_credits and codes[0] == CTR.linked_event_failed,
                 str(codes))
    common.check(tbl.sum() == 50, "only the funding credit may remain")


def _tp_ext(pk, n, p_flags, p_code, p_ledger, p_dr, p_cr, p_amt, tgt_ev, dstat):
    return dk.pack_two_phase_ext(
        pk, n, bits_extra_mask=np.zeros(n, np.uint64),
        p_flags=p_flags, p_code=p_code, p_ledger=p_ledger, p_dr_slot=p_dr, p_cr_slot=p_cr,
        p_amt_lo=p_amt, p_amt_hi=np.zeros(n, np.uint64), tgt_ev=tgt_ev, dstat_init_ev=dstat)


def two_phase_in_batch(dev):
    """A pending and two posts of it in one batch: the second post loses."""
    table, meta = mk_tables(dev)
    n = 3
    pk = base_pack(n, [0, -1, -1], [1, -1, -1], [30, 0, 0],
                   flags=np.array([dk.F_PENDING, dk.F_POST, dk.F_POST], np.uint32),
                   ids=np.array([10, 11, 12], np.uint64), pend=np.array([0, 10, 10], np.uint64),
                   n_cols=dk.N_COLS_TP, p_found=np.zeros(n, bool), p_tgt=np.full(n, -1, np.int64))
    pk = _tp_ext(pk, n, np.zeros(n, np.uint16), np.zeros(n, np.uint16), np.zeros(n, np.uint32),
                 np.full(n, -1, np.int64), np.full(n, -1, np.int64), np.zeros(n, np.uint64),
                 np.array([-1, 0, 0], np.int64), np.zeros(n, np.uint32))
    tbl, s = _run(dk.two_phase, dev, table, meta, 0, pk, n, 1000)
    common.check(s["n_fail"] == 1 and s["fail_idx"][0] == 2, str(s))
    common.check(s["fail_codes"][0] == CTR.pending_transfer_already_posted, str(s))
    common.check(tbl[0, 0] == 0 and tbl[0, 2] == 30 and tbl[1, 4] == 0 and tbl[1, 6] == 30,
                 "balances")


def _durable_void(amount, ident):
    n = 1
    pk = base_pack(n, [-1], [-1], [amount], flags=np.array([dk.F_VOID], np.uint32),
                   ids=np.array([ident], np.uint64), pend=np.array([10], np.uint64),
                   n_cols=dk.N_COLS_TP, p_found=np.ones(n, bool), p_tgt=np.zeros(n, np.int64))
    return _tp_ext(pk, n, np.full(n, dk.F_PENDING, np.uint16), np.ones(n, np.uint16),
                   np.ones(n, np.uint32), np.zeros(n, np.int64), np.ones(n, np.int64),
                   np.full(n, 30, np.uint64), np.full(n, -1, np.int64),
                   np.full(n, dk.S_PENDING, np.uint32))


def _live_pending(dev):
    table, meta = mk_tables(dev)
    table[0, 0] = 30
    table[1, 4] = 30
    return table, meta


def two_phase_partial_void(dev):
    """A durable void of a part of the amount: different_amount."""
    table, meta = _live_pending(dev)
    _, s = _run(dk.two_phase, dev, table, meta, 1, _durable_void(10, 20), 1, 2000)
    common.check(s["n_fail"] == 1, str(s))
    common.check(s["fail_codes"][0] == CTR.pending_transfer_has_different_amount, str(s))


def two_phase_void(dev):
    """A durable void of the whole amount releases the pending."""
    table, meta = _live_pending(dev)
    tbl, s = _run(dk.two_phase, dev, table, meta, 2, _durable_void(0, 21), 1, 2001)
    common.check(s["n_fail"] == 0, str(s))
    common.check(tbl[0, 0] == 0 and tbl[1, 4] == 0 and tbl[0, 2] == 0, "balances")


CASES = (orderfree_ok, orderfree_pending, linked_static_fail, linked_limit, linked_rollback,
         two_phase_in_batch, two_phase_partial_void, two_phase_void)


def run(dev, quick: bool = False) -> dict:
    for case in CASES:
        case(dev)
    common.sync(dev)
    return common.record("kernel_smoke", dev, cases={c.__name__: "ok" for c in CASES})


main = common.link_main(__doc__, run)

if __name__ == "__main__":
    sys.exit(main())

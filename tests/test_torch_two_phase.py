"""Kernel K6's plain PyTorch version (tigerbeetle_tpu_torch/state_machine/
device_kernels.py two_phase_plain, reached through the two_phase
wrapper on CPU tensors) against the JAX jitted two_phase and
two_phase_lo: the same seeded table, meta, ring and packed (B, 11)
batch give the same table and ring bit for bit.  Cases from
testing/semantic_cases.py reach in-batch and durable targets, every
durable status (posted, voided, expired), not found / not pending,
account, ledger and code mismatches, amount rungs, first-wins races,
high amount limbs, add overflow and release underflow.  Also the
two-phase packers against the reference's, byte for byte."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from tigerbeetle_tpu.state_machine import device_kernels as ref
from tigerbeetle_tpu_torch.ops.u128 import from_u64, to_u64
from tigerbeetle_tpu_torch.state_machine import device_kernels as dk
from tigerbeetle_tpu_torch.testing import semantic_cases as sc
from tigerbeetle_tpu_torch.types import CreateTransferResult as CTR

A = 1024  # one table shape for the file: each jit compiles once
KINDS = ["two_phase", "two_phase_lo"]
RING_AT = 5


def run_both(kind, table, meta, pk, n):
    ring = np.random.default_rng(n).integers(0, 1 << 62, (8, dk.SUMMARY_WORDS), dtype=np.uint64)
    jt, jr = getattr(ref, kind)(
        jnp.asarray(table), jnp.asarray(meta), jnp.asarray(ring), RING_AT,
        jnp.asarray(pk), n, jnp.uint64(1 << 40),
    )
    t, r = from_u64(table.copy()), from_u64(ring.copy())
    m = torch.from_numpy(meta.view(np.int32).copy())
    out_t, out_r = dk.two_phase(t, m, r, RING_AT, from_u64(pk.copy()), n, 1 << 40,
                                lo_only=kind == "two_phase_lo")
    assert out_t is t and out_r is r  # in place
    return (np.asarray(jt), np.asarray(jr)), (to_u64(t), to_u64(r))


@pytest.mark.parametrize("scenario", sc.TWO_PHASE_SCENARIOS)
@pytest.mark.parametrize("kind", KINDS)
def test_two_phase_matches_jax(kind, scenario):
    table, meta, pk, n = sc.two_phase_case(
        200 + sc.TWO_PHASE_SCENARIOS.index(scenario), dk.B, scenario, A=A
    )
    (jt, jr), (pt, pr) = run_both(kind, table, meta, pk, n)
    assert np.array_equal(pr, jr)
    assert np.array_equal(pt, jt)
    s = dk.unpack_summary(jr[RING_AT])
    assert s["overflow"] == (scenario in ("overflow", "underflow"))
    assert np.array_equal(pt, table) == s["overflow"]  # a flagged batch keeps the table
    if scenario == "padding":
        assert s["n_active"] == n < dk.B


def test_cases_reach_every_pv_rung():
    """The scenarios together reach every code of the pv ladder and the
    first-wins losers: batches of FAIL_CAP events, so the summary lists
    every failure."""
    want = {
        CTR.pending_transfer_not_found, CTR.pending_transfer_not_pending,
        CTR.pending_transfer_has_different_debit_account_id,
        CTR.pending_transfer_has_different_credit_account_id,
        CTR.pending_transfer_has_different_ledger, CTR.pending_transfer_has_different_code,
        CTR.exceeds_pending_transfer_amount, CTR.pending_transfer_has_different_amount,
        CTR.pending_transfer_already_posted, CTR.pending_transfer_already_voided,
        CTR.pending_transfer_expired, CTR.flags_are_mutually_exclusive,
        CTR.pending_id_must_not_be_zero, CTR.pending_id_must_be_different,
    }
    seen = set()
    ring = torch.zeros((1, dk.SUMMARY_WORDS), dtype=torch.int64)
    for i, scenario in enumerate(sc.TWO_PHASE_SCENARIOS):
        for seed in range(12):
            table, meta, pk, n = sc.two_phase_case(
                1000 * i + seed, dk.B, scenario, A=A, n=dk.FAIL_CAP
            )
            dk.two_phase(from_u64(table), torch.from_numpy(meta.view(np.int32)),
                         ring, 0, from_u64(pk), n, 1)
            seen |= set(dk.unpack_summary(to_u64(ring)[0])["fail_codes"].tolist())
    assert {int(c) for c in want} <= seen, sorted({int(c) for c in want} - seen)


def _wire(rng, n):
    cols = {k: rng.integers(0, 1 << 63, n, dtype=np.uint64) for k in (
        "id_lo", "id_hi", "dr_lo", "dr_hi", "cr_lo", "cr_hi", "pend_lo", "pend_hi")}
    for k in cols:
        cols[k][rng.random(n) < 0.2] = 0
        cols[k][rng.random(n) < 0.1] = np.uint64((1 << 64) - 1)
    cols["pend_lo"][5:9] = cols["id_lo"][5:9]
    cols["pend_hi"][5:9] = cols["id_hi"][5:9]
    return cols


def test_two_phase_packers_match_reference():
    """pack_base with the two-phase join (p_found, p_tgt, n_cols) and
    pack_two_phase_ext give the reference packers' bytes."""
    rng = np.random.default_rng(5)
    n = dk.B - 5
    base = dict(
        flags=rng.integers(0, 1 << 8, n).astype(np.uint32),
        ledger=rng.integers(0, 3, n).astype(np.uint32),
        code=rng.integers(0, 3, n).astype(np.uint32),
        ts_nonzero=rng.random(n) < 0.1,
        dr_slot=rng.integers(-1, 500, n), cr_slot=rng.integers(-1, 500, n),
        amount_lo=rng.integers(0, 1 << 63, n, dtype=np.uint64),
        amount_hi=rng.integers(0, 9, n, dtype=np.uint64),
        timeout=rng.integers(0, 1 << 32, n).astype(np.uint32),
        e_found=np.zeros(n, bool), p_found=rng.random(n) < 0.4,
        p_tgt=np.where(rng.random(n) < 0.4, rng.integers(0, 50, n), -1),
        n_cols=dk.N_COLS_TP, **_wire(rng, n),
    )
    assert ref.N_COLS_TP == dk.N_COLS_TP
    got, want = dk.pack_base(n, **base), ref.pack_base(n, **base)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    ext = dict(
        bits_extra_mask=rng.integers(0, 1 << 17, n, dtype=np.uint64) & np.uint64(0x1E000),
        p_flags=rng.integers(0, 1 << 16, n).astype(np.uint16),
        p_code=rng.integers(0, 1 << 16, n).astype(np.uint16),
        p_ledger=rng.integers(0, 1 << 32, n).astype(np.uint32),
        p_dr_slot=rng.integers(0, 500, n), p_cr_slot=rng.integers(0, 500, n),
        p_amt_lo=rng.integers(0, 1 << 63, n, dtype=np.uint64),
        p_amt_hi=rng.integers(0, 3, n, dtype=np.uint64),
        tgt_ev=rng.integers(-1, n, n), dstat_init_ev=rng.integers(0, 5, n).astype(np.uint32),
    )
    got = dk.pack_two_phase_ext(got, n, **ext)
    want = ref.pack_two_phase_ext(want, n, **ext)
    assert got.tobytes() == want.tobytes()
    for name in ("COL_TP_JOIN", "COL_TP_SLOTS", "COL_TP_AMT_LO", "COL_TP_AMT_HI",
                 "COL_TP_REF", "BIT_P_FOUND", "BIT_T_DR_SET", "BIT_T_CR_SET",
                 "BIT_DR_EQ_P", "BIT_CR_EQ_P", "F_LINKED", "AF_DR_LIMIT", "AF_CR_LIMIT",
                 "S_PENDING", "S_POSTED", "S_VOIDED", "S_EXPIRED"):
        assert getattr(dk, name) == getattr(ref, name), name


def test_wrapper_rejects_bad_inputs():
    table = torch.zeros((8, 8), dtype=torch.int64)
    meta = torch.zeros((8, 2), dtype=torch.int32)
    ring = torch.zeros((4, dk.SUMMARY_WORDS), dtype=torch.int64)
    pk = torch.zeros((dk.B, dk.N_COLS_TP), dtype=torch.int64)
    with pytest.raises(ValueError):
        dk.two_phase(table, meta, ring, 0, pk[:, : dk.N_COLS].contiguous(), 1, 1)
    with pytest.raises(ValueError):
        dk.two_phase(table, meta, ring, 0, pk, -1, 1)

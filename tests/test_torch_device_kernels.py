"""Kernel K1's plain PyTorch version (tigerbeetle_tpu_torch/state_machine/
device_kernels.py orderfree_plain, reached through the orderfree
wrapper on CPU tensors) against the JAX jitted orderfree,
orderfree_lo and orderfree_tight on equal table, meta, ring and packed
batch — new table and ring bit for bit.  Also the G-batch window with
ring wrap, and the host packers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from tigerbeetle_tpu.state_machine import device_kernels as ref
from tigerbeetle_tpu_torch.ops.u128 import from_u64, to_u64
from tigerbeetle_tpu_torch.state_machine import device_kernels as dk

A = 1024          # table rows
N_ACCT = 900      # rows with accounts (the rest stay zero)
KINDS = ["orderfree", "orderfree_lo", "orderfree_tight"]
SCENARIOS = ["padding", "failures", "not_found", "overflow", "skewed", "one_pair"]
ZIPF_ACCT = 100   # the skewed scenario's accounts, p ~ 1 / rank (gen_zipf)


def _table(rng):
    lo = rng.integers(0, 1 << 63, (A, 4), dtype=np.uint64) | (
        rng.integers(0, 2, (A, 4), dtype=np.uint64) << np.uint64(63)
    )
    hi = rng.integers(0, 1 << 40, (A, 4), dtype=np.uint64)  # totals cannot overflow
    table = np.stack([lo, hi], axis=-1).reshape(A, 8)
    table[N_ACCT:] = 0
    meta = np.zeros((A, 2), np.uint32)
    meta[:N_ACCT, 1] = 1
    meta[:N_ACCT, 0] = rng.integers(0, 2, N_ACCT)
    return table, meta


def _batch(rng, kind, scenario, table, meta):
    """Packed (B, C) batch for `kind` plus n and ts_base."""
    B = dk.B
    n = B - 7 if scenario == "padding" else B
    dr = rng.integers(0, N_ACCT, n)
    cr = (dr + 1 + rng.integers(0, 5, n)) % N_ACCT
    if scenario == "skewed":
        p = 1.0 / np.arange(1, ZIPF_ACCT + 1)
        dr = rng.choice(ZIPF_ACCT, n, p=p / p.sum())
        cr = rng.choice(ZIPF_ACCT, n, p=p / p.sum())
        cr = np.where(cr == dr, (dr + 1) % ZIPF_ACCT, cr)
    elif scenario == "one_pair":   # every event on one pair of rows
        dr = np.full(n, 17)
        cr = np.full(n, 400)
    dr1 = dr + 1
    if scenario in ("not_found", "failures"):
        dr1[rng.random(n) < 0.1] = 0  # debit account not found
    pending = rng.random(n) < 0.3
    flags = np.where(pending, dk.F_PENDING, 0).astype(np.uint32)
    bits = np.zeros(n, np.uint64)
    if scenario == "failures":
        for bit in (dk.BIT_TS_NONZERO, dk.BIT_ID_ZERO, dk.BIT_SAME_ACCT,
                    dk.BIT_PEND_NONZERO, dk.BIT_DR_MAX, dk.BIT_CR_ZERO):
            bits[rng.random(n) < 0.03] |= np.uint64(bit)
        flags[rng.random(n) < 0.02] |= np.uint32(1 << 7)  # reserved flag
        meta[rng.integers(0, N_ACCT, 20), 1] = 2          # ledger mismatch
    ledger = np.ones(n, np.uint32)
    code = np.ones(n, np.uint32)
    if scenario == "failures":
        ledger[rng.random(n) < 0.02] = 0
        code[rng.random(n) < 0.02] = 0
    amount = rng.integers(0 if scenario == "failures" else 1, 1 << 31, n).astype(np.uint64)
    ts_base = 1 << 40
    if kind == "orderfree_tight":
        pk = np.zeros((B, dk.N_COLS_TIGHT), np.uint32)
        pk[:n, 0] = (
            bits.astype(np.uint32)
            | np.where(code != 0, dk.TIGHT_CODE_BIT, 0).astype(np.uint32)
            | np.where(flags & ~np.uint32(0x3F), dk.TIGHT_RESERVED_BIT, 0).astype(np.uint32)
            | ((flags & np.uint32(0x3F)) << np.uint32(dk.TIGHT_FLAGS_SHIFT))
        )
        pk[:n, 1] = dr1
        pk[:n, 2] = cr + 1
        pk[:n, 3] = amount
        pk[:n, 4] = ledger
    else:
        pk = np.zeros((B, dk.N_COLS), np.uint64)
        pk[:n, dk.COL_BITS] = bits
        pk[:n, dk.COL_SLOTS] = dr1.astype(np.uint64) | ((cr + 1).astype(np.uint64) << np.uint64(32))
        pk[:n, dk.COL_AMT_LO] = rng.integers(0, 1 << 63, n, dtype=np.uint64) | (
            rng.integers(0, 2, n, dtype=np.uint64) << np.uint64(63)
        )
        if kind == "orderfree":
            pk[:n, dk.COL_AMT_HI] = rng.integers(0, 1 << 30, n, dtype=np.uint64)
            # Pending events carry timeouts; near the end of u64 time
            # some of them overflow (overflows_timeout), and a few
            # non-pending ones are refused (timeout reserved).
            ts_base = (1 << 64) - 3_000_000_000_000_000_000
            t = rng.integers(1, 1 << 32, n).astype(np.uint64)
            keep = pending | (rng.random(n) < 0.02)
            pk[:n, dk.COL_TIMEOUT] = np.where(keep, t, 0)
        else:
            pk[:n, dk.COL_AMT_HI] = np.where(rng.random(n) < 0.05, 1, 0).astype(np.uint64)
        pk[:n, dk.COL_MISC] = (
            flags.astype(np.uint64) | (code.astype(np.uint64) << np.uint64(16))
            | (ledger.astype(np.uint64) << np.uint64(32))
        )
    if scenario == "one_pair":     # every amount limb 2^32 - 1: the largest limb sums
        if kind == "orderfree_tight":
            pk[:n, 3] = np.uint32(0xFFFFFFFF)
        else:
            pk[:n, dk.COL_AMT_LO] = np.uint64((1 << 64) - 1)
            pk[:n, dk.COL_AMT_HI] = np.uint64((1 << 64) - 1)
    if scenario == "overflow":
        s = int(dr[0])
        col = 0 if pending[0] else 1
        table[s, 2 * col] = np.uint64((1 << 64) - 1)
        table[s, 2 * col + 1] = np.uint64((1 << 64) - 1)
    return pk, n, ts_base


def _port_pk(pk):
    return torch.from_numpy(pk.view(np.int32 if pk.dtype == np.uint32 else np.int64).copy())


def _run_both(kind, table, meta, ring, ring_at, pk, n, ts_base):
    jt, jr = getattr(ref, kind)(
        jnp.asarray(table), jnp.asarray(meta), jnp.asarray(ring), ring_at,
        jnp.asarray(pk), n, jnp.uint64(ts_base),
    )
    t, r = from_u64(table.copy()), from_u64(ring.copy())
    m = torch.from_numpy(meta.view(np.int32).copy())
    out_t, out_r = dk.orderfree(t, m, r, ring_at, _port_pk(pk), n, ts_base,
                                mode=dk.KIND_MODE[kind])
    assert out_t is t and out_r is r  # in place
    return (np.asarray(jt), np.asarray(jr)), (to_u64(t), to_u64(r))


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("kind", KINDS)
def test_orderfree_matches_jax(kind, scenario):
    rng = np.random.default_rng(10 * KINDS.index(kind) + SCENARIOS.index(scenario))
    table, meta = _table(rng)
    pk, n, ts_base = _batch(rng, kind, scenario, table, meta)
    ring = rng.integers(0, 1 << 62, (16, dk.SUMMARY_WORDS), dtype=np.uint64)
    (jt, jr), (pt, pr) = _run_both(kind, table, meta, ring, 5, pk, n, ts_base)
    assert np.array_equal(pt, jt)
    assert np.array_equal(pr, jr)
    s = dk.unpack_summary(pr[5])
    # One pair in the full format: every limb of 2^128 - 1, summed over
    # the batch, passes 2^128.
    if scenario == "overflow" or (scenario == "one_pair" and kind == "orderfree"):
        assert s["overflow"] and np.array_equal(pt, table)
    else:
        assert not s["overflow"] and not np.array_equal(pt, table)
    if scenario == "failures":
        assert s["cap_exceeded"] and len(s["fail_idx"]) == dk.FAIL_CAP
        assert (np.diff(s["fail_idx"]) > 0).all()  # event order
    if scenario == "padding":
        assert s["n_active"] == n
    if kind == "orderfree" and scenario != "overflow":
        assert (s["fail_codes"] == 53).any() or s["n_fail"] > dk.FAIL_CAP


def test_window_with_ring_wrap_matches_jax_scan():
    """G = 4 batches launched back to back from a window buffer at a
    row offset, ring rows (ring_at0 + g) % R wrapping past the end."""
    kind, G, R, off = "orderfree_tight", 4, 8, 1
    assert G in ref.SCAN_SIZES
    rng = np.random.default_rng(99)
    table, meta = _table(rng)
    big = np.zeros((G + 2, dk.B, dk.N_COLS_TIGHT), np.uint32)
    ns = np.zeros(G + 2, np.int64)
    tsb = np.zeros(G + 2, np.uint64)
    for g in range(G + 2):
        big[g], ns[g], tsb[g] = _batch(rng, kind, "padding", table, meta)
        ns[g] -= g  # distinct batch sizes
    ring = np.zeros((R, dk.SUMMARY_WORDS), np.uint64)
    jt, jr = ref.scan_win_kernels[kind][G](
        jnp.asarray(table), jnp.asarray(meta), jnp.asarray(ring), R - 2,
        jnp.asarray(big), off, jnp.asarray(ns), jnp.asarray(tsb),
    )
    t, r = from_u64(table.copy()), from_u64(ring.copy())
    dk.run_window(
        kind, t, torch.from_numpy(meta.view(np.int32).copy()), r, R - 2,
        torch.from_numpy(big.view(np.int32).copy()), off, G, ns, tsb,
    )
    assert np.array_equal(to_u64(t), np.asarray(jt))
    assert np.array_equal(to_u64(r), np.asarray(jr))
    assert [int(x) for x in to_u64(r)[[6, 7, 0, 1], 3]] == list(ns[off : off + G])


def _wire(rng, n):
    cols = {k: rng.integers(0, 1 << 63, n, dtype=np.uint64) for k in (
        "id_lo", "id_hi", "dr_lo", "dr_hi", "cr_lo", "cr_hi", "pend_lo", "pend_hi")}
    for k in cols:
        cols[k][rng.random(n) < 0.2] = 0
        cols[k][rng.random(n) < 0.1] = np.uint64((1 << 64) - 1)
    cols["cr_lo"][:5] = cols["dr_lo"][:5]
    cols["cr_hi"][:5] = cols["dr_hi"][:5]
    cols["pend_lo"][5:9] = cols["id_lo"][5:9]
    cols["pend_hi"][5:9] = cols["id_hi"][5:9]
    return cols


def test_pack_base_and_pack_tight_match_reference():
    rng = np.random.default_rng(3)
    n = dk.B - 3
    w = _wire(rng, n)
    common = dict(
        flags=rng.integers(0, 1 << 8, n).astype(np.uint32),
        ledger=rng.integers(0, 3, n).astype(np.uint32),
        code=rng.integers(0, 3, n).astype(np.uint32),
        ts_nonzero=rng.random(n) < 0.1,
        dr_slot=rng.integers(-1, 500, n), cr_slot=rng.integers(-1, 500, n),
        **w,
    )
    base = dict(
        common, amount_lo=rng.integers(0, 1 << 63, n, dtype=np.uint64),
        amount_hi=rng.integers(0, 9, n, dtype=np.uint64),
        timeout=rng.integers(0, 1 << 32, n).astype(np.uint32),
        e_found=rng.random(n) < 0.1,
    )
    got, want = dk.pack_base(n, **base), ref.pack_base(n, **base)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    tight = dict(common, amount_lo=rng.integers(0, 1 << 32, n, dtype=np.uint64))
    got, want = dk.pack_tight(n, **tight), ref.pack_tight(n, **tight)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("n_fail", [0, 7, 60, 61, 500])
def test_unpack_summary_matches_reference(n_fail):
    rng = np.random.default_rng(n_fail)
    row = rng.integers(0, 1 << 63, dk.SUMMARY_WORDS, dtype=np.uint64)
    row[0] = n_fail
    row[1] = rng.integers(0, 8) | (rng.integers(0, 64) << 16)
    got, want = dk.unpack_summary(row), ref.unpack_summary(row)
    assert got.keys() == want.keys()
    for k in got:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k


def test_lookup_and_meta_update_match_reference():
    rng = np.random.default_rng(8)
    table, meta = _table(rng)
    slots = np.array([-1, 0, 5, A - 1, -1, 17], np.int64)
    got = to_u64(dk.lookup(from_u64(table), torch.from_numpy(slots)))
    assert np.array_equal(got, np.asarray(ref.lookup(jnp.asarray(table), jnp.asarray(slots))))
    upd = np.array([3, A + 5, 9], np.int64)  # out-of-range slot is dropped
    f = np.array([1, 2, 3], np.uint32)
    led = np.array([7, 8, 9], np.uint32)
    m = torch.from_numpy(meta.view(np.int32).copy())
    dk.meta_update(m, torch.from_numpy(upd), torch.from_numpy(f.view(np.int32)),
                   torch.from_numpy(led.view(np.int32)))
    want = ref.meta_update(jnp.asarray(meta), jnp.asarray(upd), jnp.asarray(f), jnp.asarray(led))
    assert np.array_equal(m.numpy().view(np.uint32), np.asarray(want))


def test_wrapper_rejects_bad_inputs():
    table = torch.zeros((8, 8), dtype=torch.int64)
    meta = torch.zeros((8, 2), dtype=torch.int32)
    ring = torch.zeros((4, dk.SUMMARY_WORDS), dtype=torch.int64)
    pk = torch.zeros((dk.B, dk.N_COLS), dtype=torch.int64)
    with pytest.raises(ValueError):
        dk.orderfree(table, meta, ring, 4, pk, 0, 1)           # ring_at outside
    with pytest.raises(ValueError):
        dk.orderfree(table, meta, ring, 0, pk, dk.B + 1, 1)    # n > B
    with pytest.raises(ValueError):
        dk.orderfree(table, meta, ring, 0, pk, 1, 1, mode=dk.MODE_TIGHT)  # wrong format
    with pytest.raises(ValueError):
        dk.orderfree(table.t(), meta, ring, 0, pk, 1, 1)       # not (A, 8)

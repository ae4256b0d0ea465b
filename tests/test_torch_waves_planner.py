"""The wave planner, its metadata and the record codec: the port's numpy
copies (tigerbeetle_tpu_torch/state_machine/waves.py, resolve.py)
against the JAX package's, on seeded random metadata.  Segments,
chain_steps, wave_mask, n_steps, parallel_events, the admission verdict
and the packed columns must be identical; the knobs are read live and
validated as the reference's are."""

import numpy as np
import pytest

from tigerbeetle_tpu import envcheck as ref_env
from tigerbeetle_tpu.state_machine import resolve as ref_resolve
from tigerbeetle_tpu.state_machine import waves as ref
from tigerbeetle_tpu_torch import envcheck
from tigerbeetle_tpu_torch.state_machine import resolve, waves
from tigerbeetle_tpu_torch.types import AccountFlags, TransferFlags

TF = TransferFlags
AF = AccountFlags


def random_columns(rng, n, chains=0.2, pv=0.25, readers=0.1, history=0.0, slots=12):
    """The wave_dependency_metadata inputs of a random batch."""
    flags = np.zeros(n, np.uint32)
    flags[rng.random(n) < chains] |= int(TF.linked)
    flags[rng.random(n) < readers] |= int(TF.balancing_debit)
    is_pv = rng.random(n) < pv
    flags[is_pv] |= int(TF.post_pending_transfer)
    dr_flags = np.where(rng.random(n) < readers, int(AF.debits_must_not_exceed_credits), 0)
    cr_flags = np.where(rng.random(n) < readers, int(AF.credits_must_not_exceed_debits), 0)
    hist = rng.random(n) < history
    dr_flags = (dr_flags | np.where(hist, int(AF.history), 0)).astype(np.uint32)
    groups = max(1, n // 2)
    id_group = rng.integers(0, groups, n).astype(np.int64)
    p_group = np.where(is_pv & (rng.random(n) < 0.7), rng.integers(0, groups, n), -1)
    p_found = is_pv & (p_group < 0) & (rng.random(n) < 0.5)
    p_tgt = np.where(p_found, rng.integers(0, max(1, n // 3), n), -1)
    return dict(
        n=n, flags=flags,
        dr_slot=rng.integers(-1, slots // 2, n).astype(np.int64),
        cr_slot=rng.integers(slots // 2, slots, n).astype(np.int64),
        dr_flags=dr_flags, cr_flags=cr_flags.astype(np.uint32),
        id_group=id_group, p_group=p_group.astype(np.int32), p_tgt=p_tgt.astype(np.int32),
        p_found=p_found,
        p_dr_slot=np.where(p_found, rng.integers(0, slots, n), 0).astype(np.int64),
        p_cr_slot=np.where(p_found, rng.integers(0, slots, n), 0).astype(np.int64),
    )


def both_meta(cols, pv_serial=False):
    args = [cols[k] for k in ("n", "flags", "dr_slot", "cr_slot", "dr_flags", "cr_flags",
                              "id_group", "p_group", "p_tgt", "p_found", "p_dr_slot",
                              "p_cr_slot")]
    got = resolve.wave_dependency_metadata(*args, pv_serial=pv_serial)
    want = ref_resolve.wave_dependency_metadata(*args, pv_serial=pv_serial)
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    return got


def same_plan(got, want):
    assert [k for k, _ in got.segments] == [k for k, _ in want.segments]
    for (_, a), (_, b) in zip(got.segments, want.segments):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert got.chain_steps == want.chain_steps
    np.testing.assert_array_equal(got.wave_mask, want.wave_mask)
    assert (got.n_steps, got.parallel_events, got.n_waves, got.n) == (
        want.n_steps, want.parallel_events, want.n_waves, want.n)


@pytest.mark.parametrize("shape", ["mixed", "chains", "history", "serial"])
def test_plans_match_reference(shape):
    rng = np.random.default_rng(["mixed", "chains", "history", "serial"].index(shape))
    knobs = dict(mixed={}, chains=dict(chains=0.6, pv=0.0, readers=0.0),
                 history=dict(history=0.2), serial=dict(chains=0.5, readers=0.4, slots=4))
    for _ in range(40):
        n = int(rng.integers(1, 120))
        cols = random_columns(rng, n, **knobs[shape])
        meta = both_meta(cols, pv_serial=shape == "history")
        for use_walk in (False, True):
            same_plan(waves.plan_waves(n, meta, use_walk=use_walk),
                      ref.plan_waves(n, meta, use_walk=use_walk))
        inb = waves._inb_pv_write_pairs(n, meta)
        for a, b in zip(inb, ref._inb_pv_write_pairs(n, meta)):
            np.testing.assert_array_equal(a, b)
        residue = np.flatnonzero(rng.random(n) < 0.4)
        if len(residue):
            same_plan(waves.plan_residue(n, meta, residue), ref.plan_residue(n, meta, residue))


def test_chain_waves_planned_alike(monkeypatch):
    """Independent chains become one chain wave; TB_WAVES_CHAIN_MAX is
    read live by both planners."""
    n_chains, ln = 12, 3
    n = n_chains * ln
    flags = np.full(n, int(TF.linked), np.uint32)
    flags[ln - 1::ln] = 0
    cols = dict(n=n, flags=flags, dr_slot=np.repeat(np.arange(n_chains), ln),
                cr_slot=np.full(n, 99), dr_flags=np.zeros(n, np.uint32),
                cr_flags=np.zeros(n, np.uint32), id_group=np.arange(n),
                p_group=np.full(n, -1, np.int32), p_tgt=np.full(n, -1, np.int32),
                p_found=np.zeros(n, bool), p_dr_slot=np.zeros(n, np.int64),
                p_cr_slot=np.zeros(n, np.int64))
    meta = both_meta(cols)
    plan = waves.plan_waves(n, meta)
    same_plan(plan, ref.plan_waves(n, meta))
    assert [k for k, _ in plan.segments] == ["chains"] and plan.chain_steps == {0: 8}
    monkeypatch.setenv("TB_WAVES_CHAIN_MAX", "0")
    plan = waves.plan_waves(n, meta)
    same_plan(plan, ref.plan_waves(n, meta))
    assert [k for k, _ in plan.segments] == ["scan"]


def test_admission_matches_reference():
    rng = np.random.default_rng(11)
    M64 = (1 << 64) - 1
    for _ in range(60):
        A = 16
        lo = rng.integers(0, 1 << 63, (A, 4), dtype=np.int64).astype(np.uint64)
        hi = rng.choice(np.array([0, 0, 1, M64 >> 2, M64], np.uint64), (A, 4))
        k = int(rng.integers(0, 40))
        slots = rng.integers(-1, A, k).astype(np.int64)
        b_lo = rng.integers(0, 1 << 63, k, dtype=np.int64).astype(np.uint64)
        b_hi = rng.choice(np.array([0, 0, 0, 1, M64 >> 1], np.uint64), k)
        extra = int(rng.choice([0, 5, 1 << 100, 1 << 130]))
        assert waves.admission_ok(lo, hi, slots, b_lo, b_hi, extra) == ref.admission_ok(
            lo, hi, slots, b_lo, b_hi, extra)


def test_record_codec_matches_reference():
    rng = np.random.default_rng(3)
    B, n = 256, 200
    ev = {
        "i": np.arange(B, dtype=np.int32),
        "flags": np.where(np.arange(B) < n, rng.integers(0, 64, B), 0).astype(np.uint32),
        "amount_lo": np.where(np.arange(B) < n, rng.integers(0, 1 << 62, B), 0).astype(np.uint64),
        "ud32": np.zeros(B, np.uint32),
        "e_found": np.where(np.arange(B) < n, rng.random(B) < 0.3, False),
        "dr_slot": np.where(np.arange(B) < n, rng.integers(-5, 5, B), 0).astype(np.int32),
        "code": np.where(np.arange(B) < n, 7, 0).astype(np.uint32),
    }
    dstat = rng.integers(0, 5, B).astype(np.uint32)  # nonzero tail: stored verbatim
    fix = np.arange(B) < n // 2
    serial = rng.random(B) < 0.2
    got = waves.pack_wave_record(ev, dstat, fix, n)
    want = ref.pack_wave_record(ev, dstat, fix, n)
    assert (got.nbytes, got.padded_nbytes) == (want.nbytes, want.padded_nbytes)
    for (e1, d1, f1), (e2, d2, f2) in [(waves.unpack_wave_record(got),
                                        ref.unpack_wave_record(want))]:
        for key in e2:
            np.testing.assert_array_equal(e1[key], e2[key])
            assert e1[key].dtype == e2[key].dtype
        np.testing.assert_array_equal(d1, d2)
        np.testing.assert_array_equal(f1, f2)
    got = waves.unpack_spec_record(waves.pack_spec_record(ev, dstat, serial, n))
    want = ref.unpack_spec_record(ref.pack_spec_record(ev, dstat, serial, n))
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(waves.touched_slots(ev, n), ref.touched_slots(ev, n))
    for key in ev:
        np.testing.assert_array_equal(got[0][key], ev[key])


def test_spec_meta_matches_reference():
    rng = np.random.default_rng(5)
    cols = random_columns(rng, 64)
    ev = {k: cols[k] for k in ("flags", "dr_flags", "cr_flags", "p_found")}
    for key in ("dr_slot", "cr_slot", "id_group", "p_group", "p_tgt", "p_dr_slot",
                "p_cr_slot"):
        ev[key] = cols[key].astype(np.int32)
    got = resolve.spec_meta_from_events(ev, 64, True)
    want = ref_resolve.spec_meta_from_events(ev, 64, True)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(resolve._exclusive_prefix(np.arange(5)),
                                  ref_resolve._exclusive_prefix(np.arange(5)))


@pytest.mark.parametrize("name,value", [
    ("TB_WAVES", "exact"), ("TB_DEV_WAVES", "1"), ("TB_WAVES_SPECULATE", "force"),
    ("TB_WAVES_SPEC_RESIDUE_CAP", "0.5"), ("TB_WAVES_CHAIN_MAX", "16"),
    ("TB_WAVES_MIN_RATIO", "3.5"),
])
def test_knobs_read_live_like_reference(monkeypatch, name, value):
    read = (waves.mode, waves.dev_mode, waves.spec_mode, waves.spec_residue_cap,
            waves.chain_max, waves.min_ratio)
    ref_read = (ref.mode, ref.dev_mode, ref.spec_mode, ref.spec_residue_cap,
                ref.chain_max, ref.min_ratio)
    assert [f() for f in read] == [f() for f in ref_read]  # defaults
    monkeypatch.setenv(name, value)
    assert [f() for f in read] == [f() for f in ref_read]


@pytest.mark.parametrize("name,value", [
    ("TB_WAVES", "maybe"), ("TB_WAVES_SPECULATE", "2"), ("TB_WAVES_SPEC_RESIDUE_CAP", "1.5"),
    ("TB_WAVES_SPEC_RESIDUE_CAP", "-1"), ("TB_WAVES_CHAIN_MAX", "5000"),
    ("TB_WAVES_MIN_RATIO", "x"),
])
def test_bad_knobs_fail_fast(monkeypatch, name, value):
    monkeypatch.setenv(name, value)
    read = {"TB_WAVES": waves.mode, "TB_WAVES_SPECULATE": envcheck.waves_speculate,
            "TB_WAVES_SPEC_RESIDUE_CAP": envcheck.spec_residue_cap,
            "TB_WAVES_CHAIN_MAX": waves.chain_max, "TB_WAVES_MIN_RATIO": waves.min_ratio}[name]
    with pytest.raises(envcheck.EnvVarError):
        read()
    with pytest.raises(ref_env.EnvVarError):
        {"TB_WAVES": ref.mode, "TB_WAVES_SPECULATE": ref_env.waves_speculate,
         "TB_WAVES_SPEC_RESIDUE_CAP": ref_env.spec_residue_cap,
         "TB_WAVES_CHAIN_MAX": ref.chain_max, "TB_WAVES_MIN_RATIO": ref.min_ratio}[name]()

"""Kernel K5's plain PyTorch version (tigerbeetle_tpu_torch/state_machine/
device_kernels.py linked_plain, reached through the linked wrapper on
CPU tensors) against the JAX jitted linked and linked_small: the same
seeded table, meta, ring and packed batch give the same table and the
same whole ring row — codes, flags, iteration count — bit for bit.
Cases from testing/semantic_cases.py: passing chains, limit trips with
rollback, an open chain, static failures inside chains, a multi-
iteration and a non-converging fixpoint, every precondition (the small
kernel with a wrapped host sum among them), superset overflow and
padding; and the A > 2^17 sentinel path."""

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

A = 1024  # one table shape for the file: each jit compiles once
KINDS = ["linked", "linked_small"]
RING_AT = 3


def run_both(kind, table, meta, pk, n, ring_rows=8):
    rng = np.random.default_rng(n)
    ring = rng.integers(0, 1 << 62, (ring_rows, dk.SUMMARY_WORDS), dtype=np.uint64)
    jt, jr = getattr(ref, kind)(
        jnp.asarray(table), jnp.asarray(meta), jnp.asarray(ring), RING_AT,
        jnp.asarray(pk), n, jnp.uint64(1 << 40),
    )
    t, r = from_u64(table.copy()), from_u64(ring.copy())
    m = torch.from_numpy(meta.view(np.int32).copy())
    out_t, out_r = dk.linked(t, m, r, RING_AT, from_u64(pk.copy()), n, 1 << 40,
                             small=kind == "linked_small")
    assert out_t is t and out_r is r  # in place
    return (np.asarray(jt), np.asarray(jr)), (to_u64(t), to_u64(r))


# What each scenario must show in the reference's own summary row.
EXPECT = {
    "passing": lambda s: s["n_fail"] == 0 and s["iters"] == 1,
    "limits": lambda s: {54, 55} & set(s["fail_codes"].tolist()),
    "chain_open": lambda s: 2 in s["fail_codes"].tolist() or s["cap_exceeded"],
    "static": lambda s: s["n_fail"] > 0,
    "multi_iter": lambda s: 1 < s["iters"] < 64,
    "nonconverge": lambda s: s["iters"] == 64 and s["precond"],
    "precond_hi": lambda s: s["precond"],
    "precond_row_hi": lambda s: s["precond"],
    "precond_row_lo": lambda s: s["precond"],
    "precond_sum": lambda s: s["precond"],
    "small_wrapped": lambda s: s["precond"],
    "overflow": lambda s: s["overflow"],
    "padding": lambda s: s["n_active"] < dk.B,
}


@pytest.mark.parametrize("scenario", sc.LINKED_SCENARIOS)
@pytest.mark.parametrize("kind", KINDS)
def test_linked_matches_jax(kind, scenario):
    table, meta, pk, n = sc.linked_case(
        100 + sc.LINKED_SCENARIOS.index(scenario), dk.B, scenario, A=A
    )
    (jt, jr), (pt, pr) = run_both(kind, table, meta, pk, n)
    assert np.array_equal(pr, jr)
    assert np.array_equal(pt, jt)
    s = dk.unpack_summary(jr[RING_AT])
    assert EXPECT[scenario](s), (scenario, s)
    flagged = s["overflow"] or s["precond"]
    assert np.array_equal(pt, table) == flagged  # a flagged batch keeps the table


@pytest.mark.parametrize("kind", KINDS)
def test_linked_sentinel_above_2_17_rows(kind):
    """Tables above 2^17 rows take the reference's u64-key sort with a
    u64-max sentinel (int64 -1: it would sort FIRST in signed lanes).
    The plain version runs on a 2^17 + 1024-row table with every slot
    above 2^17; JAX runs on the same rows relabelled 0..1023 — a
    monotone relabelling, so every sort, segment and search is the
    same — and the ring rows and the touched rows must agree."""
    big = (1 << 17) + A
    rows = np.arange(1 << 17, big)
    table_b, meta_b, pk_b, n = sc.linked_case(77, dk.B, "limits", A=big, rows=rows)
    table_s, meta_s, pk_s, _ = sc.linked_case(77, dk.B, "limits", A=A)
    assert np.array_equal(table_b[rows], table_s) and np.array_equal(meta_b[rows], meta_s)

    def slots(pk):
        w = pk[:n, dk.COL_SLOTS]
        return (w & np.uint64(0xFFFFFFFF)).astype(np.int64) - 1, (w >> np.uint64(32)).astype(np.int64) - 1

    for sb, ss in zip(slots(pk_b), slots(pk_s)):
        assert np.array_equal(sb, np.where(ss >= 0, ss + (1 << 17), -1))
    others = [c for c in range(dk.N_COLS) if c != dk.COL_SLOTS]
    assert np.array_equal(pk_b[:, others], pk_s[:, others])
    (jt, jr), _ = run_both(kind, table_s, meta_s, pk_s, n)
    ring = np.random.default_rng(n).integers(0, 1 << 62, (8, dk.SUMMARY_WORDS), dtype=np.uint64)
    t, r = from_u64(table_b.copy()), from_u64(ring)
    dk.linked(t, torch.from_numpy(meta_b.view(np.int32).copy()), r, RING_AT,
              from_u64(pk_b.copy()), n, 1 << 40, small=kind == "linked_small")
    assert np.array_equal(to_u64(r), jr)
    assert np.array_equal(to_u64(t)[rows], jt)
    assert not to_u64(t)[: 1 << 17].any()
    assert dk.unpack_summary(jr[RING_AT])["iters"] > 1


def test_wrapper_rejects_bad_inputs():
    table = torch.zeros((8, 8), dtype=torch.int64)
    meta = torch.zeros((8, 2), dtype=torch.int32)
    ring = torch.zeros((4, dk.SUMMARY_WORDS), dtype=torch.int64)
    pk = torch.zeros((dk.B, dk.N_COLS), dtype=torch.int64)
    with pytest.raises(ValueError):
        dk.linked(table, meta, ring, 4, pk, 0, 1)                       # ring_at outside
    with pytest.raises(ValueError):
        dk.linked(table, meta, ring, 0, pk, dk.B + 1, 1)                # n > B
    with pytest.raises(ValueError):
        dk.linked(table, meta, ring, 0, pk[:, :5].contiguous(), 1, 1)  # wrong width


# The non-small precondition sum against the reference's float64 test.
# Each case's expected precondition bit: the float total of the round
# cases reaches 2^61 (per-element rounding decides); the near-bound
# totals lie 2^30 from 2^61, far outside any order's rounding, so any
# order of the sum gives the same bit.
FLOAT_CASES = {
    "round_2": sc.FLOAT_SUM_AMOUNTS["round_2"],
    "round_3": sc.FLOAT_SUM_AMOUNTS["round_3"],
    "near_below": sc.near_bound_amounts(61, 512, (1 << 61) - (1 << 30)),
    "near_above": sc.near_bound_amounts(62, 512, (1 << 61) + (1 << 30)),
}
FLOAT_PRECOND = {"round_2": True, "round_3": True, "near_below": False, "near_above": True}


@pytest.mark.parametrize("case", sorted(FLOAT_CASES))
@pytest.mark.parametrize("kind", KINDS)
def test_linked_precondition_float_sum(kind, case):
    table, meta, pk, n = sc.float_sum_case(5, dk.B, FLOAT_CASES[case], A=A)
    (jt, jr), (pt, pr) = run_both(kind, table, meta, pk, n)
    assert np.array_equal(pr, jr)
    assert np.array_equal(pt, jt)
    precond = dk.unpack_summary(jr[RING_AT])["precond"]
    # linked_small's exact bound (2^31 - 1) flags every one of these.
    assert bool(precond) == (FLOAT_PRECOND[case] or kind == "linked_small")


def test_pairwise_sum_order():
    """The plain version's float64 sum is a pairwise tree of adjacent
    lanes, zero-padded to a power of two, with one rounding per u64."""
    x = torch.tensor([1 << 53, 1, 1, 0, 3], dtype=torch.int64)
    f = dk.u64_to_f64(x)
    assert f.tolist() == [float(1 << 53), 1.0, 1.0, 0.0, 3.0]
    # ((2^53 + 1) + (1 + 0)) + (3 + 0): 2^53 + 1 rounds to 2^53 (even).
    assert dk.pairwise_sum(f).item() == float((1 << 53) + 4)
    # 2^64 - 1, 2^64 - 2049 and the tie 2^64 - 3072 (ulp 2^11 there).
    top = torch.tensor([-1, -2049, -3072], dtype=torch.int64)
    assert dk.u64_to_f64(top).tolist() == [2.0 ** 64, 2.0 ** 64 - 2048, 2.0 ** 64 - 4096]

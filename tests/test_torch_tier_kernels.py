"""The tiering slice's kernels, plain versions on the CPU, against the
JAX package's functions, bit for bit:

- K10 ``device_kernels.tier_set_rows`` vs device_engine._TIER_SET, with
  the reference's distinct out-of-range padding;
- K2 admit ``commitment.admit`` vs commitment.device_fns()["admit"],
  with -1 padding slots and slots past the table (``testing/
  commit_cases.py``);
- K11 ``device_kernels.checksum`` vs device_kernels.checksum (balances)
  and mirror.digest_columns (meta words >= 2^31, zero-extended);
- the host digests ``mirror.digest_columns`` / ``checksum8`` and
  ``HostCommitment.partial`` vs theirs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from tigerbeetle_tpu.state_machine import commitment as ref_cm
from tigerbeetle_tpu.state_machine import device_kernels as ref_dk
from tigerbeetle_tpu.state_machine import mirror as ref_mirror
from tigerbeetle_tpu.state_machine.device_engine import _TIER_SET
from tigerbeetle_tpu_torch.ops.u128 import from_u64, to_u64
from tigerbeetle_tpu_torch.state_machine import commitment as cm
from tigerbeetle_tpu_torch.state_machine import device_kernels as dk
from tigerbeetle_tpu_torch.state_machine import mirror
from tigerbeetle_tpu_torch.testing import commit_cases


def _u64(rng, shape):
    return rng.integers(0, 1 << 64, shape, dtype=np.uint64)


def _u32_high(rng, shape):
    """u32 words, a third of them >= 2^31 (sign-extension would show)."""
    w = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    w[rng.random(shape) < 0.33] |= np.uint32(1 << 31)
    return w


def _t32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("H,k,width", [(64, 5, 8), (64, 64, 8), (257, 33, 8), (64, 5, 2),
                                       (257, 100, 2)])
def test_tier_set_rows_matches_jax(H, k, width):
    """Distinct admitted slots plus the reference's padding: distinct
    out-of-range indices H + i, dropped by both."""
    rng = np.random.default_rng(H * 31 + k + width)
    pad = 8
    idx = np.concatenate([rng.choice(H, k, replace=False), H + np.arange(pad)]).astype(np.int64)
    if width == 8:
        table, src = _u64(rng, (H, 8)), _u64(rng, (k + pad, 8))
        got = dk.tier_set_rows(from_u64(table.copy()), torch.from_numpy(idx), from_u64(src))
        got = to_u64(got)
    else:
        table, src = _u32_high(rng, (H, 2)), _u32_high(rng, (k + pad, 2))
        got = dk.tier_set_rows(_t32(table.copy()), torch.from_numpy(idx), _t32(src))
        got = got.numpy().view(np.uint32)
    want = np.asarray(_TIER_SET(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(src)))
    assert got.dtype == want.dtype and np.array_equal(got, want)


_I64, _I32 = torch.int64, torch.int32
_ON_TWO = "tensors must be contiguous and on one device"


def _z(shape, dtype=_I64, device="cpu"):
    return torch.zeros(shape, dtype=dtype, device=device)


# (table, idx, src) -> the ValueError's whole message.  A `meta` tensor
# stands in for a second device; `.t()` and `[::2]` make strided views.
_TIER_REFUSALS = {
    "table_dtype": (lambda: (_z((4, 8), torch.float32), _z(2), _z((2, 8))),
                    "table must be (H, W) int64 or int32, got (4, 8) torch.float32"),
    "table_rank": (lambda: (_z(4), _z(2), _z((2, 8))),
                   "table must be (H, W) int64 or int32, got (4,) torch.int64"),
    "idx_dtype": (lambda: (_z((4, 8)), _z(2, _I32), _z((2, 8))),
                  "idx must be (k,) int64, got (2,) torch.int32"),
    "idx_rank": (lambda: (_z((4, 8)), _z((2, 1)), _z((2, 8))),
                 "idx must be (k,) int64, got (2, 1) torch.int64"),
    "src_width": (lambda: (_z((4, 8)), _z(2), _z((2, 2))),
                  "src must be (2, 8) torch.int64, got (2, 2) torch.int64"),
    "src_rows": (lambda: (_z((4, 8)), _z(2), _z((3, 8))),
                 "src must be (2, 8) torch.int64, got (3, 8) torch.int64"),
    "src_rank": (lambda: (_z((4, 8)), _z(2), _z(16)),
                 "src must be (2, 8) torch.int64, got (16,) torch.int64"),
    "src_dtype": (lambda: (_z((4, 8)), _z(2), _z((2, 8), _I32)),
                  "src must be (2, 8) torch.int64, got (2, 8) torch.int32"),
    "src_dtype_meta_table": (lambda: (_z((4, 2), _I32), _z(2), _z((2, 2))),
                             "src must be (2, 2) torch.int32, got (2, 2) torch.int64"),
    "table_strided": (lambda: (_z((8, 4)).t(), _z(2), _z((2, 8))), _ON_TWO),
    "idx_strided": (lambda: (_z((4, 8)), _z(4)[::2], _z((2, 8))), _ON_TWO),
    "src_strided": (lambda: (_z((4, 8)), _z(2), _z((8, 2)).t()), _ON_TWO),
    "idx_elsewhere": (lambda: (_z((4, 8)), _z(2, device="meta"), _z((2, 8))), _ON_TWO),
    "src_elsewhere": (lambda: (_z((4, 8)), _z(2), _z((2, 8), device="meta")), _ON_TWO),
    "table_elsewhere": (lambda: (_z((4, 8), device="meta"), _z(2), _z((2, 8))), _ON_TWO),
}


@pytest.mark.parametrize("case", sorted(_TIER_REFUSALS))
def test_tier_set_rows_checks_its_inputs(case):
    """Every refusal of K10's wrapper, with its message: wrong dtype,
    rank, width or row count, a strided input, tensors on two devices."""
    make, message = _TIER_REFUSALS[case]
    table, idx, src = make()
    with pytest.raises(ValueError) as err:
        dk.tier_set_rows(table, idx, src)
    assert str(err.value) == message


@pytest.mark.parametrize("H,k", [(64, 1), (64, 40), (300, 256), (300, 7)])
def test_admit_matches_jax(H, k):
    """Row hashes (some zero: free slots) swapped at k distinct slots,
    padded with -1 to the reference's bucket."""
    rng = np.random.default_rng(H + k)
    row_hash = _u64(rng, (H, 2))
    row_hash[rng.random(H) < 0.2] = 0
    digest = _u64(rng, 2)
    slots = ref_cm.pad_slots(rng.choice(H, k, replace=False).astype(np.int64))
    new_lo, new_hi = _u64(rng, len(slots)), _u64(rng, len(slots))
    j_rh, j_dg = ref_cm.device_fns()["admit"](
        jnp.asarray(row_hash), jnp.asarray(digest), jnp.asarray(slots),
        jnp.asarray(new_lo), jnp.asarray(new_hi),
    )
    t_rh, t_dg = cm.admit(from_u64(row_hash.copy()), from_u64(digest.copy()),
                          torch.from_numpy(slots), from_u64(new_lo), from_u64(new_hi))
    assert np.array_equal(to_u64(t_rh), np.asarray(j_rh))
    assert np.array_equal(to_u64(t_dg), np.asarray(j_dg))
    assert "admit" in cm.PLAIN_FNS and cm.device_fns()["admit"] is cm.admit


_PAST = sorted(commit_cases.PAST_CASES)


@pytest.mark.parametrize("H", [13, 301])
@pytest.mark.parametrize("case", _PAST)
def test_admit_past_the_table_matches_jax(case, H):
    """Slots past the table are live in the reference: old is row H-1
    as it was before the call, nothing is stored; with and without a
    lane that owns row H-1 in the same call."""
    row_hash, digest, slots, new_lo, new_hi = commit_cases.admit_case(
        commit_cases.past_slots(case, H), H, 7 * H + _PAST.index(case))
    j_rh, j_dg = ref_cm.device_fns()["admit"](
        jnp.asarray(row_hash), jnp.asarray(digest), jnp.asarray(slots),
        jnp.asarray(new_lo), jnp.asarray(new_hi),
    )
    t_rh, t_dg = cm.admit(from_u64(row_hash.copy()), from_u64(digest.copy()),
                          torch.from_numpy(slots), from_u64(new_lo), from_u64(new_hi))
    assert np.array_equal(to_u64(t_rh), np.asarray(j_rh))
    assert np.array_equal(to_u64(t_dg), np.asarray(j_dg))


def test_admit_one_slot_past_the_table_worked_example():
    """H = 8, row i holding (100 + 2i, 101 + 2i), slots [1, 9, -1]: the
    digest moves by (5 - 102) + (7 - 114) in each lane, 114 being row
    7's; only row 1 changes."""
    H = 8
    row_hash = np.array([[100 + 2 * i, 101 + 2 * i] for i in range(H)], np.uint64)
    slots = np.array([1, 9, -1], np.int64)
    new_lo, new_hi = np.array([5, 7, 11], np.uint64), np.array([6, 8, 12], np.uint64)
    t_rh, t_dg = cm.admit(from_u64(row_hash.copy()), torch.zeros(2, dtype=torch.int64),
                          torch.from_numpy(slots), from_u64(new_lo), from_u64(new_hi))
    want = row_hash.copy()
    want[1] = (5, 6)
    assert np.array_equal(to_u64(t_rh), want)
    assert to_u64(t_dg).tolist() == [(1 << 64) - 204] * 2
    j_rh, j_dg = ref_cm.device_fns()["admit"](
        jnp.asarray(row_hash), jnp.zeros(2, jnp.uint64), jnp.asarray(slots),
        jnp.asarray(new_lo), jnp.asarray(new_hi),
    )
    assert np.array_equal(np.asarray(j_rh), want)
    assert np.array_equal(np.asarray(j_dg), to_u64(t_dg))


def test_admit_refuses_an_empty_table():
    z = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="row_hash has no rows"):
        cm.admit(torch.zeros((0, 2), dtype=torch.int64), torch.zeros(2, dtype=torch.int64),
                 z, z, z)


def test_admit_keeps_the_partial_exact():
    """Admission as the engine runs it: the device digest stays the host
    twin's partial over the resident rows."""
    from tigerbeetle_tpu_torch.state_machine.mirror import BalanceMirror

    rng = np.random.default_rng(5)
    A, H = 40, 6
    m = BalanceMirror(A)
    m.lo[:] = _u64(rng, (A, 4))
    meta = rng.integers(0, 9, (A, 2)).astype(np.uint32)
    twin = cm.HostCommitment(A, meta_fn=lambda s: meta[s])
    twin.refresh(np.arange(A), m)
    resident = np.full(H, -1, np.int64)
    row_hash = torch.zeros((H, 2), dtype=torch.int64)
    digest = torch.zeros(2, dtype=torch.int64)
    for batch in (np.array([3, 9, 1]), np.array([30, 31, 2, 17]), np.array([5])):
        slots = rng.choice(H, len(batch), replace=False)
        resident[slots] = batch
        cm.admit(row_hash, digest, torch.from_numpy(slots.astype(np.int64)),
                 from_u64(twin.row_lo[batch]), from_u64(twin.row_hi[batch]))
        want = twin.partial(resident[resident >= 0])
        assert np.array_equal(to_u64(digest), want)


@pytest.mark.parametrize("rows", [1, 7, 64, 1000])
def test_checksum_balances_matches_jax(rows):
    table = _u64(np.random.default_rng(rows), (rows, 8))
    want = np.asarray(ref_dk.checksum(jnp.asarray(table)))
    got = to_u64(dk.checksum(from_u64(table)))
    assert np.array_equal(got, want)
    assert np.array_equal(mirror.digest_columns(table), want)


@pytest.mark.parametrize("rows", [1, 9, 1000])
def test_checksum_meta_zero_extends(rows):
    """Meta words >= 2^31: K11 must zero-extend, as digest_columns' cast
    to u64 does (a sign-extending sum differs)."""
    meta = _u32_high(np.random.default_rng(rows + 1), (rows, 2))
    meta[0] = [0xFFFFFFFF, 0x80000000]
    want = np.asarray(ref_mirror.digest_columns(meta))
    assert np.array_equal(mirror.digest_columns(meta), want)
    assert np.array_equal(np.asarray(ref_mirror.digest_columns(jnp.asarray(meta))), want)
    got = to_u64(dk.checksum(_t32(meta)))
    assert np.array_equal(got, want)
    signed = meta.view(np.int32).astype(np.int64).astype(np.uint64)
    assert not np.array_equal(mirror.digest_columns(signed), want)


@pytest.mark.parametrize("cols", [1, 2, 4, 16, 32])
def test_checksum_widths(cols):
    table = _u64(np.random.default_rng(cols), (33, cols))
    got = to_u64(dk.checksum(from_u64(table)))
    assert np.array_equal(got, np.asarray(ref_dk.checksum(jnp.asarray(table))))


def test_checksum_refuses_other_widths():
    with pytest.raises(ValueError):
        dk.checksum(torch.zeros((4, 3), dtype=torch.int64))
    with pytest.raises(ValueError):
        dk.checksum(torch.zeros((4, 64), dtype=torch.int64))


def test_host_digests_match_reference():
    from tigerbeetle_tpu.state_machine.mirror import BalanceMirror as RefMirror
    from tigerbeetle_tpu_torch.state_machine.mirror import BalanceMirror

    rng = np.random.default_rng(8)
    mine, theirs = BalanceMirror(20), RefMirror(20)
    mine.lo[:], mine.hi[:] = _u64(rng, (20, 4)), _u64(rng, (20, 4))
    theirs.lo[:], theirs.hi[:] = mine.lo, mine.hi
    for cap in (20, 32):
        assert np.array_equal(mine.checksum8(cap), theirs.checksum8(cap))
    meta = rng.integers(0, 5, (20, 2)).astype(np.uint32)
    tw_m = cm.HostCommitment(20, meta_fn=lambda s: meta[s])
    tw_r = ref_cm.HostCommitment(20, meta_fn=lambda s: meta[s])
    tw_m.refresh(np.arange(20), mine)
    tw_r.refresh(np.arange(20), theirs)
    for rows in ([3, 3, 7, -1, 19], [], list(range(20))):
        assert np.array_equal(tw_m.partial(rows), tw_r.partial(rows))
    hot, cold = np.arange(0, 20, 3), np.setdiff1d(np.arange(20), np.arange(0, 20, 3))
    assert np.array_equal(tw_m.partial(hot) + tw_m.partial(cold), tw_m.digest)

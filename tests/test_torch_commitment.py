"""State commitment of the port (tigerbeetle_tpu_torch/state_machine/
commitment.py): the pinned golden digest, and the rebuild / update /
probe plain versions of kernel K2 against the JAX device_fns() — bit
for bit, -1 padding and slots past the table included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from tigerbeetle_tpu.state_machine import commitment as ref
from tigerbeetle_tpu_torch.ops.u128 import from_u64, to_u64
from tigerbeetle_tpu_torch.state_machine import commitment as cm
from tigerbeetle_tpu_torch.testing import commit_cases


def _fixture_table():
    bal = np.arange(64, dtype=np.uint64).reshape(8, 8) * np.uint64(0x0123456789ABCDEF)
    meta = np.arange(16, dtype=np.uint32).reshape(8, 2) + np.uint32(1)
    return bal, meta


def _meta_t(meta_u32):
    return torch.from_numpy(np.ascontiguousarray(meta_u32).view(np.int32))


def test_golden_digest_pinned():
    """The reference's pinned root (tests/test_commitment.py) holds on the
    host path and on the plain device version."""
    bal, meta = _fixture_table()
    d = cm.table_digest(bal, meta)
    assert int(d[0]) == 0xB84D53B618D40315, hex(int(d[0]))
    assert int(d[1]) == 0x924D31B47961A88B, hex(int(d[1]))
    assert cm.root_bytes(d).hex() == "1503d418b6534db88ba86179b4314d92"
    row_hash, digest = cm.rebuild(from_u64(bal), _meta_t(meta), torch.arange(8))
    assert np.array_equal(to_u64(digest), d)


def _random_tables(seed, rows):
    rng = np.random.default_rng(seed)
    bal = rng.integers(0, 1 << 63, (rows, 8), dtype=np.uint64)
    bal |= rng.integers(0, 2, (rows, 8), dtype=np.uint64) << np.uint64(63)
    bal[rng.random(rows) < 0.2] = 0  # all-zero rows hash to (0, 0)
    meta = rng.integers(0, 1 << 32, (rows, 2), dtype=np.uint64).astype(np.uint32)
    meta[rng.random(rows) < 0.2] = 0
    return bal, meta


@pytest.mark.parametrize("rows", [1, 8, 257, 1024])
def test_rebuild_matches_jax(rows):
    bal, meta = _random_tables(rows, rows)
    logical = np.arange(rows, dtype=np.uint64) + np.uint64(3)  # non-identity binding
    jrh, jdg = ref.device_fns()["rebuild"](
        jnp.asarray(bal), jnp.asarray(meta), jnp.asarray(logical)
    )
    trh, tdg = cm.rebuild(from_u64(bal), _meta_t(meta), from_u64(logical))
    assert np.array_equal(to_u64(trh), np.asarray(jrh))
    assert np.array_equal(to_u64(tdg), np.asarray(jdg))
    assert np.array_equal(to_u64(tdg), cm.table_digest(bal, meta, start_row=3))


@pytest.mark.parametrize("n_touched", [0, 1, 100, 300])
def test_update_matches_jax_with_padding(n_touched):
    rows = 512
    bal, meta = _random_tables(40 + n_touched, rows)
    fns = ref.device_fns()
    ident = np.arange(rows, dtype=np.uint64)
    jrh, jdg = fns["rebuild"](jnp.asarray(bal), jnp.asarray(meta), jnp.asarray(ident))
    rng = np.random.default_rng(n_touched)
    slots = np.sort(rng.choice(rows, n_touched, replace=False)).astype(np.int64)
    bal2 = bal.copy()
    bal2[slots, 1] += np.uint64(977)
    meta2 = meta.copy()
    meta2[slots[: n_touched // 2], 0] ^= np.uint32(5)
    padded = cm.pad_slots(slots)
    assert np.array_equal(padded, ref.pad_slots(slots))
    assert (padded[n_touched:] == -1).all()
    jrh2, jdg2 = fns["update"](
        jnp.asarray(bal2), jnp.asarray(meta2), jrh, jdg,
        jnp.asarray(padded), jnp.asarray(padded),
    )
    trh = from_u64(np.asarray(jrh).copy())
    tdg = from_u64(np.asarray(jdg).copy())
    out_rh, out_dg = cm.update(
        from_u64(bal2), _meta_t(meta2), trh, tdg,
        torch.from_numpy(padded), torch.from_numpy(padded),
    )
    assert out_rh is trh and out_dg is tdg  # updated in place
    assert np.array_equal(to_u64(trh), np.asarray(jrh2))
    assert np.array_equal(to_u64(tdg), np.asarray(jdg2))
    assert np.array_equal(to_u64(tdg), cm.table_digest(bal2, meta2))


_PAST = sorted(commit_cases.PAST_CASES)


def _update_both(bal, meta, row_hash, digest, slots, rows):
    """The reference's update and the port's on copies of one input:
    ((row_hash, digest) of JAX, (row_hash, digest) of the port)."""
    j = ref.device_fns()["update"](
        jnp.asarray(bal), jnp.asarray(meta), jnp.asarray(row_hash), jnp.asarray(digest),
        jnp.asarray(slots), jnp.asarray(rows),
    )
    t = cm.update(from_u64(bal), _meta_t(meta), from_u64(row_hash.copy()),
                  from_u64(digest.copy()), torch.from_numpy(slots), from_u64(rows))
    return [np.asarray(a) for a in j], [to_u64(a) for a in t]


@pytest.mark.parametrize("A", [13, 301])
@pytest.mark.parametrize("case", _PAST)
def test_update_past_the_table_matches_jax(case, A):
    """Slots past the table are live in the reference: row A-1's
    balances, meta and stored hash as they were before the call, hashed
    under the lane's own logical id; nothing is stored; with and
    without a lane that owns row A-1 in the same call."""
    inputs = commit_cases.update_case(commit_cases.past_slots(case, A), A,
                                      11 * A + _PAST.index(case))
    (j_rh, j_dg), (t_rh, t_dg) = _update_both(*inputs)
    assert np.array_equal(t_rh, j_rh)
    assert np.array_equal(t_dg, j_dg)


def test_update_one_slot_past_the_table_worked_example():
    """A = 8, slots [1, 9, -1] (the reference's result, where the port
    once raised IndexError): lane 9 hashes row 7's columns under its
    own logical id against row 7's stored hash; rows other than 1 keep
    their hashes."""
    A = 8
    bal, meta = _random_tables(8, A)
    row_hash = np.array([[100 + 2 * i, 101 + 2 * i] for i in range(A)], np.uint64)
    slots = np.array([1, 9, -1], np.int64)
    rows = np.array([1, 9, 0], np.uint64)
    (j_rh, j_dg), (t_rh, t_dg) = _update_both(bal, meta, row_hash, np.zeros(2, np.uint64),
                                              slots, rows)
    lo, hi = cm.rows_hash(rows[:2], bal[[1, 7]], meta[[1, 7]])
    want = np.array([lo[0] - np.uint64(102) + lo[1] - np.uint64(114),
                     hi[0] - np.uint64(103) + hi[1] - np.uint64(115)], np.uint64)
    assert np.array_equal(t_dg, want) and np.array_equal(j_dg, want)
    keep = np.arange(A) != 1
    assert np.array_equal(t_rh[keep], row_hash[keep])
    assert np.array_equal(t_rh, j_rh)


def test_update_refuses_empty_tables():
    z = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="the tables have no rows"):
        cm.update(torch.zeros((0, 8), dtype=torch.int64), torch.zeros((0, 2), dtype=torch.int32),
                  torch.zeros((0, 2), dtype=torch.int64), torch.zeros(2, dtype=torch.int64),
                  z, z)


def test_probe_matches_jax():
    bal, meta = _random_tables(77, 300)
    ident = np.arange(300, dtype=np.uint64)
    stale = np.array([12345, 67890], np.uint64)
    want = ref.device_fns()["probe"](
        jnp.asarray(bal), jnp.asarray(meta), jnp.asarray(stale), jnp.asarray(ident)
    )
    got = cm.probe(from_u64(bal), _meta_t(meta), from_u64(stale), from_u64(ident))
    assert np.array_equal(to_u64(got), np.asarray(want))


def test_host_commitment_refresh_tracks_from_scratch():
    from tigerbeetle_tpu_torch.state_machine.mirror import BalanceMirror

    rows = 64
    rng = np.random.default_rng(5)
    meta = rng.integers(1, 9, (rows, 2)).astype(np.uint32)
    mirror = BalanceMirror(rows)
    twin = cm.HostCommitment(rows, meta_fn=lambda s: meta[s])
    mirror.commitment = twin
    twin.rebuild(mirror)  # meta is nonzero from the start
    for step in range(5):
        s = rng.choice(rows, 10, replace=False)
        mirror.lo[s, step % 4] += np.uint64(step + 1)
        twin.refresh(s, mirror)
        assert np.array_equal(twin.digest, cm.table_digest(mirror.rows8(np.arange(rows)), meta))

"""The port's row-sharded apply (parallel/sharded.py) against the JAX
package's on the suite's 8 virtual CPU devices, bit for bit: tables and
admitted masks of build_apply_step at dp 1 and 2 (near-2^128 rows that
reject, out-of-range slots), the dryrun shape of
__graft_entry__.dryrun_multichip, own_rows / gather_rows inside a
shard_map, and K12-K14's plain versions against numpy."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from tigerbeetle_tpu.parallel import sharded as rs
from tigerbeetle_tpu_torch.ops.u128 import from_u64, to_u64
from tigerbeetle_tpu_torch.parallel import sharded
from tigerbeetle_tpu_torch.testing import shard_cases as sc

CPU8 = ["cpu"] * 8


def run_port(mesh, rows, balances, *events):
    step = sharded.build_apply_step(mesh, rows)
    tables, admitted = step(sharded.shard_balances(mesh, balances),
                            *sharded.shard_events(mesh, *events))
    return sc.join_tables(tables), admitted.numpy()


def run_ref(dp, rows, balances, *events):
    mesh = rs.make_mesh(jax.devices()[:8], dp=dp)
    step = rs.build_apply_step(mesh, rows)
    out, admitted = step(rs.shard_balances(mesh, balances), *rs.shard_events(mesh, *events))
    return np.asarray(out), np.asarray(admitted)


@pytest.mark.parametrize("dp", [1, 2])
def test_apply_step_matches_jax(dp):
    """Random slots and u128 amounts, rows near 2^128 in every column
    (their events reject), out-of-range slots on both sides."""
    rows = 4 * (8 // dp) * 4
    balances, *events = sc.apply_events(40 + dp, rows, 16 * dp)
    got, got_admitted = run_port(sharded.make_mesh(CPU8, dp=dp), rows, balances, *events)
    want, want_admitted = run_ref(dp, rows, balances, *events)
    np.testing.assert_array_equal(got_admitted, want_admitted)
    np.testing.assert_array_equal(got, want)
    oracle, oracle_admitted = sc.apply_oracle(balances, *events)
    np.testing.assert_array_equal(got_admitted, oracle_admitted)
    np.testing.assert_array_equal(got, oracle)
    assert 0 < got_admitted.sum() < len(got_admitted)


def test_apply_step_out_of_range_case_matches_jax():
    """tests/test_sharded.py's out-of-range case."""
    mesh = sharded.make_mesh(CPU8, dp=2)
    rows = 4 * mesh.shape["shard"]
    balances = np.zeros((rows, 8), np.uint64)
    events = (np.array([0, rows, -1, 2], np.int32), np.array([1, 1, 1, 3], np.int32),
              np.full(4, 10, np.uint64), np.zeros(4, np.uint64), np.zeros(4, bool))
    got, got_admitted = run_port(mesh, rows, balances, *events)
    want, want_admitted = run_ref(2, rows, balances, *events)
    np.testing.assert_array_equal(got_admitted, [True, False, False, True])
    np.testing.assert_array_equal(got_admitted, want_admitted)
    np.testing.assert_array_equal(got, want)


def test_dryrun_multichip_shape_matches_jax():
    """__graft_entry__.dryrun_multichip(8): the default mesh (dp 2),
    rows = 8 * n_shard, 4 * dp events, every event admitted."""
    mesh = sharded.make_mesh(CPU8)
    assert mesh.shape == {"dp": 2, "shard": 4}
    rows, n_events = 8 * mesh.shape["shard"], 4 * mesh.shape["dp"]
    rng = np.random.default_rng(0)
    dr = rng.integers(0, rows, n_events).astype(np.int32)
    events = (dr, (dr + 1) % rows, rng.integers(1, 100, n_events).astype(np.uint64),
              np.zeros(n_events, np.uint64), np.zeros(n_events, bool))
    balances = np.zeros((rows, 8), np.uint64)
    got, got_admitted = run_port(mesh, rows, balances, *events)
    want, want_admitted = run_ref(2, rows, balances, *events)
    assert got_admitted.all()
    np.testing.assert_array_equal(got_admitted, want_admitted)
    np.testing.assert_array_equal(got, want)


def test_plain_run_matches_kernel_wrappers():
    """build_apply_step(plain=True) is the same step (on the CPU both
    run the plain versions; on the card it is the reference run)."""
    mesh = sharded.make_mesh(CPU8, dp=2)
    rows = 32
    balances, *events = sc.apply_events(7, rows, 24)
    a = run_port(mesh, rows, balances, *events)
    step = sharded.build_apply_step(mesh, rows, plain=True)
    tables, admitted = step(sharded.shard_balances(mesh, balances),
                            *sharded.shard_events(mesh, *events))
    np.testing.assert_array_equal(sc.join_tables(tables), a[0])
    np.testing.assert_array_equal(admitted.numpy(), a[1])


def test_own_rows_and_gather_rows_match_jax():
    """The reference's own_rows / gather_rows inside a shard_map over
    the 8-device row mesh against the port's per shard."""
    rows, local = 64, 8
    rng = np.random.default_rng(3)
    table = rng.integers(0, 1 << 62, (rows, 8)).astype(np.uint64)
    slots = np.concatenate([rng.integers(-3, rows + 3, 40), [0, rows - 1, -1, rows]])
    slots = slots.astype(np.int32)
    clipped = np.clip(slots, 0, rows - 1)
    mesh = rs.make_row_mesh(jax.devices()[:8])

    def body(t, s, c):
        is_local, rel = rs.own_rows(s, local)
        return is_local[None], rel[None], rs.gather_rows(t, c, local)

    fn = jax.jit(rs.shard_map(body, mesh=mesh, in_specs=(P("shard", None), P(), P()),
                              out_specs=(P("shard"), P("shard"), P()), **rs.shard_map_kwargs()))
    ref_local, ref_rel, ref_rows = fn(jnp.asarray(table), jnp.asarray(slots),
                                      jnp.asarray(clipped))
    s_t = torch.from_numpy(slots)
    for s in range(8):
        is_local, rel = sharded.own_rows(s_t, local, s)
        np.testing.assert_array_equal(is_local.numpy(), np.asarray(ref_local)[s])
        np.testing.assert_array_equal(rel.numpy(), np.asarray(ref_rel)[s])
    tables = sharded.shard_balances(sharded.make_row_mesh(CPU8), table)
    got = sharded.gather_rows(tables, torch.from_numpy(clipped.astype(np.int64)))
    np.testing.assert_array_equal(to_u64(got), np.asarray(ref_rows))
    np.testing.assert_array_equal(to_u64(got), table[clipped])


def _np_limb_sums(local_rows, row0, dr, cr, lo, hi, pend, mask):
    acc = np.zeros((local_rows, 4, 4), np.uint64)
    for e in range(len(dr)):
        if not mask[e]:
            continue
        limbs = [int(lo[e]) & 0xFFFFFFFF, int(lo[e]) >> 32, int(hi[e]) & 0xFFFFFFFF,
                 int(hi[e]) >> 32]
        for slot, col in ((dr[e], 0 if pend[e] else 1), (cr[e], 2 if pend[e] else 3)):
            if row0 <= slot < row0 + local_rows:
                acc[slot - row0, col] += np.array(limbs, np.uint64)
    return acc


def _u128(table, r, c):
    return int(table[r, 2 * c]) | (int(table[r, 2 * c + 1]) << 64)


@pytest.mark.parametrize("shard", [0, 3])
def test_shard_kernels_plain_match_numpy(shard):
    """K12 (_accumulate, masked and not), K13 admit / apply and K14
    gather / scatter plain versions against Python-int arithmetic; the
    wrappers on CPU tensors are the plain versions."""
    local_rows, rows = 8, 32
    row0 = shard * local_rows
    balances, dr, cr, lo, hi, pend = sc.apply_events(11 + shard, rows, 40)
    ev = sharded.shard_events(sharded.make_mesh(["cpu"], dp=1), dr, cr, lo, hi, pend)
    ev = [x[0] for x in ev]
    mask = np.random.default_rng(shard).random(len(dr)) < 0.6
    table = balances[row0:row0 + local_rows].copy()
    t = from_u64(table).clone()
    for m in (None, mask):
        acc = sharded.accumulate(local_rows, row0, *ev,
                                 mask=None if m is None else torch.from_numpy(m))
        want = _np_limb_sums(local_rows, row0, dr, cr, lo, hi, pend,
                             np.ones(len(dr), bool) if m is None else m)
        np.testing.assert_array_equal(to_u64(acc), want)

    acc = sharded.accumulate(local_rows, row0, *ev)
    sums = to_u64(acc)
    total = [[sum(int(sums[r, c, k]) << (32 * k) for k in range(4)) for c in range(4)]
             for r in range(local_rows)]
    over = [any(_u128(table, r, c) + total[r][c] >= 1 << 128 for c in range(4))
            for r in range(local_rows)]
    want_reject = [any(row0 <= s < row0 + local_rows and over[s - row0] for s in (d, c))
                   for d, c in zip(dr, cr)]
    got = sharded.admit(t, acc, row0, ev[0], ev[1])
    np.testing.assert_array_equal(got.numpy(), want_reject)
    np.testing.assert_array_equal(sharded.admit_plain(t, acc, row0, ev[0], ev[1]).numpy(),
                                  want_reject)

    sharded.apply(t, acc)
    for r in range(local_rows):
        for c in range(4):
            v = (_u128(table, r, c) + total[r][c]) % (1 << 128)
            assert _u128(to_u64(t), r, c) == v

    slots = torch.tensor([0, row0, row0 + local_rows - 1, row0 + local_rows, rows - 1, 5],
                         dtype=torch.int64)
    part = sharded.gather_part(t, slots, shard)
    whole = to_u64(t)
    for k, s in enumerate(slots.tolist()):
        want = whole[s - row0] if row0 <= s < row0 + local_rows else np.zeros(8, np.uint64)
        np.testing.assert_array_equal(to_u64(part[k]), want)
    new_rows = torch.arange(slots.numel() * 8, dtype=torch.int64).view(-1, 8)
    before = whole.copy()
    sharded.scatter_part(t, slots, new_rows, shard)
    after = to_u64(t)
    for k, s in enumerate(slots.tolist()):
        if row0 <= s < row0 + local_rows:
            before[s - row0] = to_u64(new_rows[k])
    np.testing.assert_array_equal(after, before)


def test_make_mesh_defaults_and_no_card(monkeypatch):
    """dp=2 when the count allows, a pure shard mesh otherwise; with no
    devices named and no card, both constructors raise."""
    assert sharded.make_mesh(CPU8).shape == {"dp": 2, "shard": 4}
    assert sharded.make_mesh(["cpu"] * 6).shape == {"dp": 2, "shard": 3}
    assert sharded.make_mesh(["cpu"] * 2).shape == {"dp": 1, "shard": 2}
    assert sharded.make_mesh(["cpu"] * 3).shape == {"dp": 1, "shard": 3}
    assert sharded.make_row_mesh(CPU8).shape == {"shard": 8}
    assert rs.make_mesh(jax.devices()[:8]).shape == {"dp": 2, "shard": 4}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        sharded.make_mesh()
    with pytest.raises(RuntimeError):
        sharded.make_row_mesh()
    with pytest.raises(RuntimeError):
        sharded.make_mesh(["cuda:0"] * 4)


def test_divisibility_asserts():
    mesh = sharded.make_mesh(CPU8, dp=2)
    with pytest.raises(AssertionError):
        sharded.build_apply_step(mesh, 30)
    with pytest.raises(AssertionError):
        sharded.shard_events(mesh, np.zeros(5, np.int32))
    with pytest.raises(AssertionError):
        sharded.shard_balances(mesh, np.zeros((30, 8), np.uint64))

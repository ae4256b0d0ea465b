"""The port's sharded wave executor (waves._execute_plan_sharded over
an 8-shard CPU row mesh) against the JAX package's
(waves._execute_plan_sharded on make_row_mesh(jax.devices()[:8])) and
against the port's dense executor, bit for bit: the joined table and
the (B, 37) packed outputs, on wave_cases plans with wave and chain
segments only (one wide wave, one chain wave, and a wave, chains,
wave, chains plan with slot -1 events), at a capacity that divides by
8.  plan_shardable agrees with the reference's, a plan with a scan
segment is refused, and the slot remap is a bijection onto the compact
table that clips as the whole table does.  A stream of full batches
(shard_cases.wave_stream) runs batch after batch on one set of shard
tables as the dense executor runs it on the whole table."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from tigerbeetle_tpu.parallel import sharded as rs
from tigerbeetle_tpu.state_machine import waves as rw
from tigerbeetle_tpu_torch import kernels
from tigerbeetle_tpu_torch.parallel import sharded
from tigerbeetle_tpu_torch.state_machine import kernel as k3
from tigerbeetle_tpu_torch.state_machine import waves
from tigerbeetle_tpu_torch.testing import scan_cases, shard_cases as sc, wave_cases

B, A = 256, 1024
CASES = {name: case for name, case in sc.shardable_cases(61, B, A)}


def jax_events(ev):
    return {name: np.asarray(ev[name]).astype(dt) for name, dt in k3.EVENT_FIELDS}


@pytest.fixture(scope="module")
def ref_mesh():
    return rs.make_row_mesh(jax.devices()[:8])


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_plan_matches_jax_and_dense(name, ref_mesh):
    table, ev, dstat, n, ts_base, plan = CASES[name]
    fix = sc.hist_fix(plan, n, B)
    balances = jax.device_put(jnp.asarray(table), NamedSharding(ref_mesh, P("shard", None)))
    ref_table, ref_packed = rw._execute_plan_sharded(balances, jax_events(ev), dstat, n,
                                                     ts_base, plan, fix, ref_mesh)

    mesh = sharded.make_row_mesh(["cpu"] * 8)
    tables = sharded.shard_balances(mesh, table)
    assert all(t.shape == (A // 8, 8) for t in tables)
    tables, packed = waves._execute_plan_sharded(tables, ev, dstat, n, ts_base, plan, fix,
                                                 mesh)
    dense = torch.from_numpy(table.view(np.int64).copy())
    dense_packed = waves.run_create_transfers_waves(dense, ev, dstat, n, ts_base, plan, fix)

    got_table = sc.join_tables(tables)
    np.testing.assert_array_equal(got_table, np.asarray(ref_table))
    np.testing.assert_array_equal(packed.numpy().view(np.uint64), np.asarray(ref_packed))
    np.testing.assert_array_equal(got_table, dense.numpy().view(np.uint64))
    assert torch.equal(packed, dense_packed)
    res = k3.unpack_outputs(packed.numpy().view(np.uint64))["results"][:n]
    assert (res == 0).any() and (res != 0).any()


def test_plain_flag_and_no_launches_on_cpu():
    """plain=True gives the same bits; CPU tensors launch nothing."""
    table, ev, dstat, n, ts_base, plan = CASES["mixed"]
    fix = sc.hist_fix(plan, n, B)
    mesh = sharded.make_row_mesh(["cpu"] * 4)
    kernels.reset_launches()
    outs = []
    for plain in (False, True):
        tables, packed = waves._execute_plan_sharded(
            sharded.shard_balances(mesh, table), ev, dstat, n, ts_base, plan, fix, mesh,
            plain=plain)
        outs.append((sc.join_tables(tables), packed))
    assert not any(kernels.launches.values())
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_plan_shardable_matches_jax_and_scan_refused():
    plans = [case[5] for case in CASES.values()]
    for cls in ("linked", "mixed", "post_void"):
        plans.append(wave_cases.plan_case(70, B, cls, A=A)[5])
    verdicts = [waves.plan_shardable(p) for p in plans]
    assert verdicts == [rw.plan_shardable(p) for p in plans]
    assert verdicts[:3] == [True] * 3 and not any(verdicts[3:])

    table, ev, dstat, n, ts_base, plan = wave_cases.plan_case(70, B, "linked", A=A)
    mesh = sharded.make_row_mesh(["cpu"] * 8)
    with pytest.raises(AssertionError, match="plan_shardable"):
        waves._execute_plan_sharded(sharded.shard_balances(mesh, table), ev, dstat, n,
                                    ts_base, plan, sc.hist_fix(plan, n, B), mesh)


def test_slot_remap_is_a_clip_preserving_bijection():
    """_remap_slots / _unmap_slots over slots below, inside and past the
    table: the map is strictly increasing, inverts, and the compact
    clip names the row the whole table's clip does."""
    A_ = 40
    ev = {c: np.array([-5, -1, 0, 3, 17, 39, 40, 44, 3], np.int32) for c in waves._SLOT_COLS}
    rows = waves._batch_rows(ev, A_)
    np.testing.assert_array_equal(rows, [0, 3, 17, 39])
    mapped = waves._remap_slots(ev, rows, A_)["dr_slot"].astype(np.int64)
    orig = ev["dr_slot"].astype(np.int64)
    order = np.argsort(orig, kind="stable")
    assert (np.diff(mapped[order]) >= 0).all()
    assert ((np.diff(mapped[order]) == 0) == (np.diff(orig[order]) == 0)).all()
    K = len(rows)
    np.testing.assert_array_equal(rows[np.clip(mapped, 0, K - 1)], np.clip(orig, 0, A_ - 1))
    packed = torch.zeros((len(orig), k3.N_COLS), dtype=torch.int64)
    for col in waves._OUT_SLOT_COLS:
        packed[:, col] = torch.from_numpy(mapped)
    back = waves._unmap_slots(packed, torch.from_numpy(rows), A_)
    for col in waves._OUT_SLOT_COLS:
        np.testing.assert_array_equal(back[:, col].numpy(), orig)


def test_scan_case_batches_with_missing_accounts_shard():
    """A scan_cases batch (slots -1 among them) planned as one wave over
    the events the planner would run in waves: the first wave segment of
    a plan_case plan, executed alone, equals the dense executor (24
    rows, 3 per shard, so slots collide and some are -1)."""
    table, ev, dstat, n, ts_base = scan_cases.make_case(72, B, "mixed", A=24)
    plan = wave_cases.plan_case(72, B, "mixed", A=24)[5]
    first = next(idx for kind, idx in plan.segments if kind == "wave")
    sub = waves.WavePlan(n, segments=[("wave", first)])
    fix = np.zeros(B, bool)
    fix[first] = True
    assert (np.asarray(ev["dr_slot"][:n]) < 0).any() or (np.asarray(ev["cr_slot"][:n]) < 0).any()
    mesh = sharded.make_row_mesh(["cpu"] * 8)
    tables, packed = waves._execute_plan_sharded(sharded.shard_balances(mesh, table), ev,
                                                 dstat, n, ts_base, sub, fix, mesh)
    dense = torch.from_numpy(table.view(np.int64).copy())
    want = waves.run_create_transfers_waves(dense, ev, dstat, n, ts_base, sub, fix)
    np.testing.assert_array_equal(sc.join_tables(tables), dense.numpy().view(np.uint64))
    assert torch.equal(packed, want)


def test_wave_stream_batch_after_batch_matches_dense():
    """shard_cases.wave_stream's full batches, one of each shape, run in
    order on the same shard tables equal the dense executor's run on
    the whole table: every batch's packed outputs and the final table."""
    table, batches = sc.wave_stream(83, 3, B, A)
    mesh = sharded.make_row_mesh(["cpu"] * 8)
    tables = sharded.shard_balances(mesh, table)
    dense = torch.from_numpy(table.view(np.int64).copy())
    for ev, dstat, n, ts_base, plan in batches:
        assert n == B
        fix = sc.hist_fix(plan, n, B)
        tables, packed = waves._execute_plan_sharded(tables, ev, dstat, n, ts_base, plan, fix,
                                                     mesh)
        assert torch.equal(packed, waves.run_create_transfers_waves(dense, ev, dstat, n,
                                                                    ts_base, plan, fix))
    np.testing.assert_array_equal(sc.join_tables(tables), dense.numpy().view(np.uint64))
    assert (sc.join_tables(tables) != table).any()

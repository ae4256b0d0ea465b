"""The exact scan: kernel K3's plain version (the port's
state_machine/kernel.py) against the JAX package's
kernel.run_create_transfers on the CPU backend, bit for bit on the
table and on the whole (B, 37) packed output, padding lanes included.

Inputs are numpy-seeded event columns drawn from small value pools, so
ids, pending references, slots and balances collide: each case leans on
one class (linked chains with rollback, post/void against durable and
in-batch pendings, balancing, limit accounts, near-2^128 balances,
overdue posts, duplicate and existing ids, timeout overflow).  Two
shapes only (A = 24 rows, B in {32, 256}; the
inputs come from tigerbeetle_tpu_torch.testing.scan_cases), so the module compiles the
JAX scan twice."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tigerbeetle_tpu.state_machine import kernel as ref
from tigerbeetle_tpu_torch.state_machine import kernel as k3
from tigerbeetle_tpu_torch.testing.scan_cases import CLASSES, M64, make_case


def run_ref(table, ev, dstat, n, ts_base):
    jev = {name: jnp.asarray(np.asarray(ev[name]).astype(dt)) for name, dt in ref.EVENT_FIELDS}
    bal, packed = ref.run_create_transfers(jnp.asarray(table), jev, dstat, n, ts_base)
    return np.asarray(bal), np.asarray(packed)


def run_port(table, ev, dstat, n, ts_base):
    t = torch.from_numpy(table.copy().view(np.int64))
    pk = torch.from_numpy(k3.pack_events(ev).view(np.int64))
    out_t, packed = k3.run_create_transfers(
        t, pk, torch.from_numpy(dstat.view(np.int32)), n, ts_base
    )
    assert out_t is t  # in place
    return t.numpy().view(np.uint64), packed.numpy().view(np.uint64)


def test_layout_matches_reference():
    assert [name for name, _ in k3.EVENT_FIELDS] == [name for name, _ in ref.EVENT_FIELDS]
    assert k3.CREATED_FIELDS == ref.CREATED_FIELDS
    assert k3._SCALAR_COLS == ref._SCALAR_COLS and k3.N_COLS == ref.N_COLS == 37
    assert k3.N_EVENT_COLS == 52 and k3.BATCH_BUCKETS == ref.BATCH_BUCKETS


@pytest.mark.parametrize("B", [32, 256])
@pytest.mark.parametrize("cls", CLASSES)
def test_plain_scan_matches_jax(B, cls):
    seen = set()
    for seed in range(3):
        case = make_case(1000 * B + 17 * CLASSES.index(cls) + seed, B, cls)
        t_ref, p_ref = run_ref(*case)
        t_got, p_got = run_port(*case)
        np.testing.assert_array_equal(p_got, p_ref)
        np.testing.assert_array_equal(t_got, t_ref)
        seen |= set(ref.unpack_outputs(p_ref)["results"][: case[3]].tolist())
    assert len(seen) > 3, seen


def test_every_scan_code_is_reached():
    """Across the classes at B = 256, the scan produced every result
    code it owns (1-3 and 25-55) and passed static codes through."""
    seen = set()
    for cls in CLASSES:
        for seed in range(3):
            case = make_case(1000 * 256 + 17 * CLASSES.index(cls) + seed, 256, cls)
            _, p = run_port(*case)
            seen |= set(k3.unpack_outputs(p)["results"][: case[3]].tolist())
    owned = {1, 2, 3} | set(range(25, 56))
    assert owned <= seen, sorted(owned - seen)
    assert seen & set(range(4, 25))


def test_unpack_outputs_matches_reference():
    case = make_case(5, 32, "mixed")
    _, packed = run_port(*case)
    mine, theirs = k3.unpack_outputs(packed), ref.unpack_outputs(packed)
    assert mine["last_applied"] == theirs["last_applied"]
    for key in ("results", "created_mask", "inb_status", "dstat", "pulse_create",
                "pulse_remove", "hist_dr", "hist_cr"):
        np.testing.assert_array_equal(mine[key], theirs[key])
        assert mine[key].dtype == theirs[key].dtype
    for f in k3.CREATED_FIELDS:
        np.testing.assert_array_equal(mine["created"][f], theirs["created"][f])
        assert mine["created"][f].dtype == theirs["created"][f].dtype


def test_slot_minus_one_packs_sign_extended():
    """Trap 7: int32 -1 stored in a u64 column reads back as 2^64 - 1
    (jnp astype sign-extends), in the inputs and in the created slots."""
    assert np.asarray(jnp.asarray(np.int32(-1)).astype(jnp.uint64)) == M64
    ev = {name: np.zeros(4, dt) for name, dt in k3.EVENT_FIELDS}
    ev["dr_slot"][:] = -1
    pk = k3.pack_events(ev)
    assert (pk[:, k3.COL["dr_slot"]] == np.uint64(M64)).all()


def test_noop_is_identity():
    x = torch.arange(5)
    assert k3._noop(x) is x


def test_touched_slots_cover_pending_rows():
    ev = {name: np.zeros(4, dt) for name, dt in k3.EVENT_FIELDS}
    ev["dr_slot"][:] = [1, -1, 2, 9]
    ev["cr_slot"][:] = [3, -1, 4, 9]
    ev["p_dr_slot"][:] = [-1, 7, -1, 9]
    ev["p_cr_slot"][:] = [-1, 8, -1, 9]
    got = k3.touched_slots(k3.pack_events(ev), 3)
    assert got.tolist() == [1, 2, 3, 4, 7, 8]

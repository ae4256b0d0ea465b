"""The flagship step and the multi-device dry run, on the card.

    python -m tigerbeetle_tpu_torch.graft_entry [--device cpu]

Counterpart of the repository's ``__graft_entry__.py``:

- ``entry(device=None)`` returns ``(fn, example_args)``: ``fn`` is the
  sequential-semantics ``create_transfers`` scan (kernel K3,
  ``state_machine/kernel.py`` ``run_create_transfers``) on the reference's
  example, 8 posted transfers between consecutive slots in a 32-event
  bucket over a (64, 8) table.  PyTorch runs eagerly: nothing is
  compiled ahead.
- ``dryrun_multichip(n_devices, devices=None)`` runs one sharded apply
  step (K12, K13) over a (dp, shard) mesh against the ``np.add.at``
  expectation; a linked batch whose second chain trips a debit limit
  and rolls back, through K3 on a row-sharded table (K14 gather and
  scatter around it), against the CPU oracle on codes and rows; the
  device engine sharded over the mesh on order-free, linked and
  pending/post batches against the oracle byte for byte; and the
  sharded engine's wave dispatch under TB_DEV_WAVES=1.

Devices: with no ``devices``, every CUDA card when there are
``n_devices`` of them, else ``[cuda:0] * n_devices`` (a mesh may repeat a
device); ``["cpu"] * 8`` runs the plain versions on the CPU.
"""
# tbcheck: allow-file(no-print): the module's command-line entry prints
# its one-word verdict on stdout, as the repository's __graft_entry__.py does.

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from tigerbeetle_tpu_torch import envcheck, types
from tigerbeetle_tpu_torch.device import resolve_device
from tigerbeetle_tpu_torch.parallel import sharded
from tigerbeetle_tpu_torch.state_machine import kernel, waves
from tigerbeetle_tpu_torch.state_machine.cpu import CpuStateMachine
from tigerbeetle_tpu_torch.state_machine.gpu import TorchStateMachine
from tigerbeetle_tpu_torch.testing import harness as hz
from tigerbeetle_tpu_torch.types import Operation

_B = 32  # kernel batch bucket (smallest)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _example_events(n: int) -> dict:
    """A padded event dict in the kernel's layout: `n` simple posted
    transfers between consecutive account slots (the reference's
    ``_example_events``, as host arrays)."""
    u64 = lambda v=0: np.full(_B, v, np.uint64)  # noqa: E731
    u32 = lambda v=0: np.full(_B, v, np.uint32)  # noqa: E731
    i32 = lambda v=0: np.full(_B, v, np.int32)  # noqa: E731
    boo = lambda v=False: np.full(_B, v, bool)  # noqa: E731

    dr = np.zeros(_B, np.int32)
    cr = np.zeros(_B, np.int32)
    dr[:n] = np.arange(n)
    cr[:n] = np.arange(n) + 1
    amount = np.zeros(_B, np.uint64)
    amount[:n] = 1

    return {
        "i": np.arange(_B, dtype=np.int32),
        "flags": u32(), "ts_nonzero": boo(), "static_result": u32(),
        "amount_lo": amount, "amount_hi": u64(),
        "pending_lo": u64(), "pending_hi": u64(),
        "ud128_lo": u64(), "ud128_hi": u64(), "ud64": u64(), "ud32": u32(),
        "timeout": u64(), "ledger": u32(1), "code": u32(1),
        "dr_slot": dr, "cr_slot": cr,
        "dr_flags": u32(), "cr_flags": u32(),
        "dr_id_zero": boo(), "cr_id_zero": boo(),
        "id_group": np.arange(_B, dtype=np.int32),
        "p_group": i32(-1),
        "e_found": boo(), "e_flags": u32(),
        "e_dr_slot": i32(), "e_cr_slot": i32(),
        "e_amount_lo": u64(), "e_amount_hi": u64(),
        "e_pending_lo": u64(), "e_pending_hi": u64(),
        "e_ud128_lo": u64(), "e_ud128_hi": u64(),
        "e_ud64": u64(), "e_ud32": u32(), "e_timeout": u64(), "e_code": u32(),
        "p_found": boo(), "p_flags": u32(),
        "p_dr_slot": i32(), "p_cr_slot": i32(),
        "p_amount_lo": u64(), "p_amount_hi": u64(),
        "p_ud128_lo": u64(), "p_ud128_hi": u64(),
        "p_ud64": u64(), "p_ud32": u32(), "p_timeout": u64(),
        "p_ledger": u32(), "p_code": u32(), "p_timestamp": u64(),
        "p_tgt": i32(-1),
    }


def _events_tensor(ev: dict, device) -> torch.Tensor:
    return torch.from_numpy(kernel.pack_events(ev).view(np.int64)).to(device)


def entry(device=None):
    """(fn, example_args): fn(balances, events, dstat_init) runs K3 on
    `device` (default: the first CUDA card) and returns (balances,
    (B, 37) packed outputs); the table is updated in place."""
    dev = resolve_device(device)
    n = 8
    balances = torch.zeros((64, 8), dtype=torch.int64, device=dev)
    events = _events_tensor(_example_events(n), dev)
    dstat_init = torch.zeros(_B, dtype=torch.int32, device=dev)

    def step(balances, events, dstat_init):
        return kernel.run_create_transfers(balances, events, dstat_init, n=n, ts_base=1_000)

    return step, (balances, events, dstat_init)


def mesh_devices(n_devices: int, devices=None) -> list:
    """The dry run's devices: the first `n_devices` of `devices`; by
    default every CUDA card when there are enough, else the first card
    n_devices times."""
    if devices is None:
        resolve_device(None)  # raises without a card
        count = torch.cuda.device_count()
        devices = ([torch.device("cuda", k) for k in range(n_devices)] if count >= n_devices
                   else [torch.device("cuda", 0)] * n_devices)
    devs = sharded.resolve_devices(devices)[:n_devices]
    _check(len(devs) == n_devices, f"{len(devs)} devices, want {n_devices}")
    return devs


def _sync(devs) -> None:
    for d in set(devs):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint64)


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """One sharded apply step over an n-device (dp, shard) mesh, then
    the linked, device-engine and sharded-wave dry runs."""
    devs = mesh_devices(n_devices, devices)
    mesh = sharded.make_mesh(devs)
    dp = mesh.shape["dp"]
    n_shard = mesh.shape["shard"]

    rows = 8 * n_shard
    n_events = 4 * dp
    rng = np.random.default_rng(0)

    balances = np.zeros((rows, 8), np.uint64)
    dr = rng.integers(0, rows, n_events).astype(np.int32)
    cr = (dr + 1) % rows
    amount_lo = rng.integers(1, 100, n_events).astype(np.uint64)
    amount_hi = np.zeros(n_events, np.uint64)
    is_pending = np.zeros(n_events, bool)

    step = sharded.build_apply_step(mesh, rows)
    dev_balances = sharded.shard_balances(mesh, balances)
    ev = sharded.shard_events(mesh, dr, cr, amount_lo, amount_hi, is_pending)
    new_balances, admitted = step(dev_balances, *ev)
    _sync(devs)

    # Nothing overflows here, so every event must be admitted and the
    # posted columns must carry the exact scatter sums.
    _check(bool(admitted.cpu().all()), "sharded apply: an event was not admitted")
    expect = np.zeros((rows, 8), np.uint64)
    np.add.at(expect[:, 2], dr, amount_lo)  # debits_posted lo
    np.add.at(expect[:, 6], cr, amount_lo)  # credits_posted lo
    got = np.concatenate([_u64(t) for t in new_balances])
    np.testing.assert_array_equal(got, expect)

    _dryrun_linked_on_mesh(mesh, rows)


def _oracle_balances(h, rows: int) -> np.ndarray:
    out = np.zeros((rows, 8), np.uint64)
    for i, row in enumerate(h.lookup_accounts(list(range(1, rows + 1)))):
        for j, f in enumerate(("debits_pending", "debits_posted", "credits_pending",
                               "credits_posted")):
            v = types.u128_get(row, f)
            out[i, 2 * j] = v & types.U64_MAX
            out[i, 2 * j + 1] = v >> 64
    return out


def _dryrun_linked_on_mesh(mesh, rows: int) -> None:
    """Order-dependent work on the mesh: one linked-chain batch (with a
    balance-limit rollback) through K3 on the balance table split over
    the mesh's "shard" axis — the K14 gather of the rows the batch can
    touch onto the first device, the scan there, the K14 scatter back
    onto the owners.  Result codes and the final table must equal the
    CPU oracle's, bit for bit."""
    AF = types.AccountFlags
    TF = types.TransferFlags
    # Accounts: slot 0 is debit-limited; chain B trips it and rolls
    # back whole; chains A and C apply.
    acct_flags = np.zeros(rows, np.uint16)
    acct_flags[0] = int(AF.debits_must_not_exceed_credits)
    chain = [
        # (dr_slot, cr_slot, amount, linked)
        (1, 2, 10, True), (2, 3, 11, True), (3, 4, 12, False),   # A: ok
        (1, 0, 5, True), (0, 2, 10_000, True), (2, 4, 7, False), # B: rolls back
        (4, 5, 9, True), (5, 6, 3, False),                       # C: ok
    ]
    n = len(chain)

    # CPU oracle.
    h = hz.SingleNodeHarness(CpuStateMachine())
    h.create_accounts([hz.account(i + 1, flags=int(acct_flags[i])) for i in range(rows)])
    oracle_reply = h.create_transfers([
        hz.transfer(100 + i, debit_account_id=dr + 1, credit_account_id=cr + 1, amount=amt,
                    flags=int(TF.linked) if linked else 0)
        for i, (dr, cr, amt, linked) in enumerate(chain)
    ])
    oracle_codes = np.zeros(n, np.uint32)
    for index, code in oracle_reply:
        oracle_codes[index] = int(code)
    oracle_bal = _oracle_balances(h, rows)

    # Mesh path: K3 on the rows the batch touches, gathered from the
    # row-sharded table and scattered back.
    ev = _example_events(0)
    for i, (dr, cr, amt, linked) in enumerate(chain):
        ev["flags"][i] = int(TF.linked) if linked else 0
        ev["dr_slot"][i] = dr
        ev["cr_slot"][i] = cr
        ev["amount_lo"][i] = amt
        ev["dr_flags"][i] = int(acct_flags[dr])
        ev["cr_flags"][i] = int(acct_flags[cr])
    row_mesh = sharded.make_row_mesh(list(mesh.devices[0]))
    home = row_mesh.device(0)
    table = sharded.ShardedTable.split(row_mesh,
                                       torch.zeros((rows, 8), dtype=torch.int64, device=home))
    touched = waves._batch_rows(ev, rows)
    slots = torch.from_numpy(touched).to(home)
    compact = table.gather(slots)
    _, packed = kernel.run_create_transfers(
        compact, _events_tensor(waves._remap_slots(ev, touched, rows), home),
        torch.zeros(_B, dtype=torch.int32, device=home), n=n, ts_base=1_000_000)
    table.scatter(slots, compact)
    packed = waves._unmap_slots(packed, slots, rows)
    out = kernel.unpack_outputs(_u64(packed))
    np.testing.assert_array_equal(out["results"][:n], oracle_codes)
    np.testing.assert_array_equal(_u64(table.join()), oracle_bal)

    _dryrun_device_engine(list(mesh.devices.ravel()))


def _dryrun_device_engine(devices) -> None:
    """The device-authoritative TorchStateMachine sharded over the
    mesh's devices: order-free, linked-chain and two-phase batches all
    flow through it and must match the CPU oracle byte for byte."""
    TF = types.TransferFlags
    AF = types.AccountFlags
    sm = TorchStateMachine(engine="device", account_capacity=1 << 12, devices=devices)
    _check(len(devices) < 2 or sm._dev.sharding is not None,
           "engine table must be mesh-sharded")
    h = hz.SingleNodeHarness(sm)
    hc = hz.SingleNodeHarness(CpuStateMachine())
    n_acct = 16
    flags = [int(AF.debits_must_not_exceed_credits) if i < 4 else 0 for i in range(n_acct)]
    ops = [(Operation.create_accounts,
            hz.pack([hz.account(i + 1, flags=flags[i]) for i in range(n_acct)]))]
    rng = np.random.default_rng(9)
    # Fund the limited accounts, then: order-free, linked (limit trips
    # + rollbacks), and a pending/post pair.
    ops.append((Operation.create_transfers, hz.pack([
        hz.transfer(100 + i, debit_account_id=16, credit_account_id=i + 1, amount=60)
        for i in range(4)
    ])))
    rows = []
    tid = 1000
    for i in range(40):
        dr = int(rng.integers(1, n_acct + 1))
        cr = dr % n_acct + 1
        rows.append(hz.transfer(tid, debit_account_id=dr, credit_account_id=cr,
                                amount=int(rng.integers(1, 40)),
                                flags=int(TF.linked) if i % 3 == 0 else 0))
        tid += 1
    ops.append((Operation.create_transfers, hz.pack(rows)))
    ops.append((Operation.create_transfers, hz.pack([
        hz.transfer(tid, debit_account_id=5, credit_account_id=6, amount=30,
                    flags=int(TF.pending)),
        hz.transfer(tid + 1, pending_id=tid, flags=int(TF.post_pending_transfer)),
    ])))
    ops.append((Operation.lookup_accounts, hz.ids_bytes(list(range(1, n_acct + 1)))))
    futs = [h.submit_async(op, body) for op, body in ops]
    got = [f.result() for f in futs]
    exp = [hc.submit(op, body) for op, body in ops]
    _check(got == exp, "sharded device engine diverges from oracle")
    _check(sm._dev.stat_semantic_events > 0, "no batch took the device kernels")
    sm.verify_device_mirror()

    _dryrun_sharded_waves(devices)


def _dryrun_sharded_waves(devices) -> None:
    """Wave dispatch on the row-sharded engine: off-kernel batches
    (pending/post pairs + balancing riders, and independent
    pending-member chains) that no semantic kernel expresses execute
    their wave plans inside the window through the sharded executor
    (waves._execute_plan_sharded) instead of declining to the host
    drain — replies must match the CPU oracle byte for byte and no
    batch may decline."""
    TF = types.TransferFlags
    with envcheck.env_pinned("TB_DEV_WAVES", "1"):
        sm = TorchStateMachine(engine="device", account_capacity=1 << 12, devices=devices)
        _check(len(devices) < 2 or sm._dev.sharding is not None,
               "engine table must be mesh-sharded")
        _check(len(devices) < 2 or sm._dev.wave_mesh() is not None, "no wave mesh")
        h = hz.SingleNodeHarness(sm)
        hc = hz.SingleNodeHarness(CpuStateMachine())
        rng = np.random.default_rng(11)
        n_acct = 48
        ops = [(Operation.create_accounts,
                hz.pack([hz.account(i) for i in range(1, n_acct + 1)]))]
        tid = 100
        for _b in range(2):
            rows = []
            for _ in range(5):
                a, b = rng.choice(np.arange(1, 41), 2, replace=False)
                rows.append(hz.transfer(tid, debit_account_id=int(a), credit_account_id=int(b),
                                        amount=int(rng.integers(1, 50)), flags=int(TF.pending)))
                rows.append(hz.transfer(tid + 1, amount=0, pending_id=tid,
                                        flags=int(TF.post_pending_transfer)))
                tid += 2
            for k in range(2):
                rows.append(hz.transfer(tid, debit_account_id=41 + 2 * k,
                                        credit_account_id=42 + 2 * k, amount=3,
                                        flags=int(TF.balancing_debit)))
                tid += 1
            ops.append((Operation.create_transfers, hz.pack(rows)))
        # Independent chains with pending members: the device `linked`
        # kernel declines these; the sharded chain-wave executor owns them.
        rows = []
        for c in range(8):
            for j in range(3):
                f = int(TF.linked) if j < 2 else 0
                if j == 0:
                    f |= int(TF.pending)
                rows.append(hz.transfer(tid, debit_account_id=1 + 2 * c,
                                        credit_account_id=2 + 2 * c, amount=2 + j, flags=f))
                tid += 1
        ops.append((Operation.create_transfers, hz.pack(rows)))
        ops.append((Operation.lookup_accounts, hz.ids_bytes(list(range(1, n_acct + 1)))))
        futs = [h.submit_async(op, body) for op, body in ops]
        got = [f.result() for f in futs]
        exp = [hc.submit(op, body) for op, body in ops]
        _check(got == exp, "sharded wave dispatch diverges from oracle")
        _check(sm.stat_dev_wave_batches == 3, f"{sm.stat_dev_wave_batches} wave batches, want 3")
        _check(sm.stat_dev_wave_declined == 0, f"declined: {sm.stat_dev_wave_decline_reasons}")
        if len(devices) >= 2:
            _check(sm._dev.stat_wave_sharded == 3,
                   f"{sm._dev.stat_wave_sharded} sharded wave plans, want 3")
        sm.verify_device_mirror()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="K3 on the example batch, then the dry run")
    p.add_argument("--device", default=None,
                   help="'cpu' runs the plain versions on an 8-device CPU mesh "
                        "(default: the CUDA cards)")
    args = p.parse_args(argv)
    fn, example = entry(args.device)
    _, packed = fn(*example)
    codes = kernel.unpack_outputs(_u64(packed))["results"][:8]
    _check(not codes.any(), f"entry: codes {codes.tolist()}")
    if args.device == "cpu":
        dryrun_multichip(8, ["cpu"] * 8)
    else:
        dryrun_multichip(max(4, torch.cuda.device_count()))
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Differential fuzzing of the port's exact lane: TorchStateMachine on
both engines (the kernels' plain versions, on the CPU) against
CpuStateMachine on randomized streams biased toward the hard cases, as
tests/test_parity_fuzz.py does for the JAX package: in-batch id
collisions, linked chains, two-phase races, balancing flags, limit and
history accounts, timeouts and the expiry pulses a clock jump injects.
Every reply, pulse_next_timestamp and commit_timestamp after each
batch, then every account and transfer row, bit for bit."""

import numpy as np
import pytest

from tigerbeetle_tpu.state_machine.cpu import CpuStateMachine
from tigerbeetle_tpu.testing import harness as ref_hz
from tigerbeetle_tpu_torch.state_machine.gpu import TorchStateMachine
from tigerbeetle_tpu_torch.testing import harness as hz
from tigerbeetle_tpu_torch.types import AccountFlags, Operation, TransferFlags

TF = TransferFlags
AF = AccountFlags


def random_transfer(rng, ids, account_ids, t_index):
    """One event (the reference fuzz's distribution)."""
    kind = rng.random()
    flags = 0
    amount = int(rng.integers(0, 50))
    timeout = 0
    pending_id = 0
    if kind < 0.45:
        if rng.random() < 0.4:
            flags |= TF.pending
            if rng.random() < 0.5:
                timeout = int(rng.integers(1, 4))
        if rng.random() < 0.25:
            flags |= TF.balancing_debit if rng.random() < 0.5 else TF.balancing_credit
    elif kind < 0.75:
        flags |= TF.post_pending_transfer if rng.random() < 0.6 else TF.void_pending_transfer
        pending_id = int(rng.choice(ids)) if len(ids) and rng.random() < 0.8 else int(rng.integers(0, 30))
    else:
        flags |= TF.pending if rng.random() < 0.3 else 0
    if rng.random() < 0.25:
        flags |= TF.linked
    # Reuse ids often: exists and in-batch duplicate paths.
    new_id = int(rng.choice(ids)) if len(ids) and rng.random() < 0.35 else t_index + 100
    return hz.transfer(
        new_id,
        debit_account_id=int(rng.choice(account_ids)) if rng.random() < 0.9 else int(rng.integers(0, 99)),
        credit_account_id=int(rng.choice(account_ids)) if rng.random() < 0.9 else int(rng.integers(0, 99)),
        amount=amount,
        pending_id=pending_id,
        user_data_128=int(rng.integers(0, 3)),
        user_data_64=int(rng.integers(0, 3)),
        user_data_32=int(rng.integers(0, 3)),
        timeout=timeout,
        ledger=int(rng.choice([1, 1, 1, 2])),
        code=int(rng.integers(0, 3)),
        flags=int(flags),
    ), new_id


@pytest.mark.parametrize("engine", ["host", "device"])
@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5, 6, 7, 8, 18, 22, 24])
def test_random_stream_matches_oracle(seed, engine):
    rng = np.random.default_rng(seed)
    cpu = ref_hz.SingleNodeHarness(CpuStateMachine())
    port = hz.SingleNodeHarness(
        TorchStateMachine(account_capacity=1 << 10, device="cpu", engine=engine)
    )
    account_ids = list(range(1, 13))
    rows = []
    for aid in account_ids:
        flags = 0
        r = rng.random()
        if r < 0.2:
            flags |= AF.debits_must_not_exceed_credits
        elif r < 0.4:
            flags |= AF.credits_must_not_exceed_debits
        if rng.random() < 0.3:
            flags |= AF.history
        rows.append(hz.account(aid, flags=int(flags), ledger=1 if rng.random() < 0.85 else 2))
    body = hz.pack(rows)
    assert cpu.submit(Operation.create_accounts, body) == port.submit(
        Operation.create_accounts, body)

    ids: list[int] = []
    t_index = 0
    realtime = 0
    for batch_no in range(16):
        batch = []
        for _ in range(int(rng.integers(1, 30))):
            row, new_id = random_transfer(rng, ids, account_ids, t_index)
            batch.append(row)
            ids.append(new_id)
            t_index += 1
        if rng.random() < 0.8:  # sometimes leave a chain open
            last = batch[-1].copy()
            last["flags"] = int(last["flags"]) & ~int(TF.linked)
            batch[-1] = last
        if rng.random() < 0.3:  # jump the clock: expiry pulses
            realtime += int(rng.integers(1, 4)) * 10**9
        body = hz.pack(batch)
        want = cpu.submit(Operation.create_transfers, body, realtime=realtime)
        got = port.submit(Operation.create_transfers, body, realtime=realtime)
        assert got == want, f"batch {batch_no} replies diverge"
        assert port.sm.pulse_next_timestamp == cpu.sm.pulse_next_timestamp
        assert port.sm.commit_timestamp == cpu.sm.commit_timestamp

    assert port.lookup_accounts(account_ids).tobytes() == cpu.lookup_accounts(
        account_ids).tobytes()
    probe = sorted(set(ids))
    assert port.lookup_transfers(probe).tobytes() == cpu.lookup_transfers(probe).tobytes()
    assert port.sm.state_root() == cpu.sm.state_root()
    port.sm.verify_device_mirror()

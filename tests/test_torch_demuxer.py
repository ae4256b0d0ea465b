"""The port's reply demuxer (state_machine/demuxer.py) against the
reference's: tests/test_demuxer.py's unit cases, a seeded differential
over random failure sets and sub-batch splits, and the slices of a real
batched create_transfers reply of TorchStateMachine.  The reference's
cluster case needs the VSR replica (ROADMAP queue 1, item 5)."""

import numpy as np
import pytest

from tigerbeetle_tpu.state_machine import demuxer as ref_demuxer
from tigerbeetle_tpu_torch.state_machine import demuxer
from tigerbeetle_tpu_torch.state_machine.demuxer import Demuxer
from tigerbeetle_tpu_torch.state_machine.gpu import TorchStateMachine
from tigerbeetle_tpu_torch.testing import harness as hz
from tigerbeetle_tpu_torch.types import CREATE_RESULT_DTYPE, CreateTransferResult, Operation
from torch_link_quiet import link_quiet  # noqa: F401  (autouse: no engine lost its link)


def _results(*pairs):
    arr = np.zeros(len(pairs), CREATE_RESULT_DTYPE)
    for i, (index, result) in enumerate(pairs):
        arr[i]["index"] = index
        arr[i]["result"] = result
    return arr.tobytes()


def test_batch_logical_allowed():
    assert demuxer.batch_logical_allowed(Operation.create_transfers)
    assert demuxer.batch_logical_allowed(Operation.create_accounts)
    assert not demuxer.batch_logical_allowed(Operation.lookup_accounts)
    assert not demuxer.batch_logical_allowed(Operation.get_account_transfers)
    assert demuxer.EVENT_SIZE == ref_demuxer.EVENT_SIZE
    assert demuxer.TRAILER_DTYPE == ref_demuxer.TRAILER_DTYPE


def test_demuxer_slices_and_rebases():
    # 3 sub-batches of 4/3/5 events; failures at global 1, 4, 6, 11.
    reply = _results((1, 10), (4, 20), (6, 30), (11, 40))
    dm = Demuxer(Operation.create_transfers, reply)
    a = np.frombuffer(dm.decode(0, 4), CREATE_RESULT_DTYPE)
    b = np.frombuffer(dm.decode(4, 3), CREATE_RESULT_DTYPE)
    c = np.frombuffer(dm.decode(7, 5), CREATE_RESULT_DTYPE)
    assert [(int(r["index"]), int(r["result"])) for r in a] == [(1, 10)]
    assert [(int(r["index"]), int(r["result"])) for r in b] == [(0, 20), (2, 30)]
    assert [(int(r["index"]), int(r["result"])) for r in c] == [(4, 40)]


def test_demuxer_empty_slices():
    dm = Demuxer(Operation.create_accounts, b"")
    assert dm.decode(0, 10) == b""
    assert dm.decode(10, 5) == b""


def test_trailer_roundtrip():
    subs = [(1000, 3, 4), ((7 << 64) | 9, 1, 2)]
    body = b"\x00" * (6 * demuxer.EVENT_SIZE) + demuxer.encode_trailer(subs)
    assert demuxer.encode_trailer(subs) == ref_demuxer.encode_trailer(subs)
    events, got = demuxer.decode_trailer(body, 2)
    assert got == subs
    assert len(events) == 6 * demuxer.EVENT_SIZE
    assert demuxer.strip_trailer(body, subs) == events


@pytest.mark.parametrize("seed", range(3))
def test_demuxer_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 400))
    fail = np.sort(rng.choice(n, int(rng.integers(0, n)), replace=False))
    reply = _results(*[(int(i), int(rng.integers(1, 56))) for i in fail])
    cuts = np.sort(rng.choice(np.arange(1, n), min(n - 1, 5), replace=False)) if n > 1 else []
    bounds = [0, *map(int, cuts), n]
    ours = Demuxer(Operation.create_transfers, reply)
    theirs = ref_demuxer.Demuxer(ref_demuxer.Operation.create_transfers, reply)
    for lo, hi in zip(bounds, bounds[1:]):
        assert ours.decode(lo, hi - lo) == theirs.decode(lo, hi - lo)


def test_demuxes_a_batched_reply_of_the_port():
    """Two clients' create_transfers sub-batches in one batch of the
    port's machine: each slice holds that client's failures, rebased."""
    sm = TorchStateMachine(device="cpu", engine="device")
    h = hz.SingleNodeHarness(sm)
    assert h.submit(Operation.create_accounts, hz.pack([hz.account(1), hz.account(2)])) == b""
    a = [hz.transfer(10, debit_account_id=1, credit_account_id=2, amount=1),
         hz.transfer(11, debit_account_id=1, credit_account_id=2, amount=2)]
    b = [hz.transfer(12, debit_account_id=2, credit_account_id=1, amount=3),
         hz.transfer(13, debit_account_id=1, credit_account_id=1, amount=4),
         hz.transfer(14, debit_account_id=2, credit_account_id=1, amount=5)]
    reply = h.submit(Operation.create_transfers, hz.pack(a + b))
    dm = Demuxer(Operation.create_transfers, reply)
    assert dm.decode(0, 2) == b""
    rb = np.frombuffer(dm.decode(2, 3), CREATE_RESULT_DTYPE)
    assert [(int(r["index"]), int(r["result"])) for r in rb] == [
        (1, int(CreateTransferResult.accounts_must_be_different))
    ]

"""The host engine's order-dependent lanes: TorchStateMachine against
TpuStateMachine and the CPU oracle on tests/test_resolve.py's streams.

Each case runs with both lane sets (`lanes`): "native", the native
library's serial resolvers (csrc/host/tb_linked.inc, tb_two_phase.inc,
tb_exact.inc) on both sides, and "python", TB_FASTPATH_DISABLE=1 on
the port's side (and the reference's library dropped), where the numpy resolvers (resolve.linked_resolve,
two_phase_resolve) take the batches.  Replies, the final lookups, the
state roots and the routing counters (which lane took each batch, which
bookkeeping tail ran) must be equal; the counters also show that the
lane under test ran.  The port's machine is unsharded on the CPU, so
its account capacity does not divide by 8 (the suite's conftest makes 8
virtual JAX devices, over which the reference shards a table whose rows
divide among them)."""

import numpy as np
import pytest

from test_resolve import chain_batch, make_accounts, two_phase_batch
from tigerbeetle_tpu.state_machine import CpuStateMachine
from tigerbeetle_tpu.state_machine.tpu import TpuStateMachine
from tigerbeetle_tpu.testing import harness as ref_hz
from tigerbeetle_tpu_torch.state_machine.gpu import TorchStateMachine
from tigerbeetle_tpu_torch.testing import harness as hz
from tigerbeetle_tpu_torch.types import (
    TRANSFER_DTYPE,
    U128_PAIR_DTYPE,
    Operation,
    TransferFlags,
)
from torch_link_quiet import link_quiet  # noqa: F401  (autouse: no engine lost its link)

Op = Operation
TF = TransferFlags
ROWS = (1 << 12) + 3
ROUTING = (
    "stat_linked_batches", "stat_two_phase_batches", "stat_exact_events",
    "stat_device_events", "stat_hot_tail_batches", "stat_slow_tail_batches",
    "stat_resolve_iters", "stat_host_semantic_events",
)


@pytest.fixture(params=["native", "python"])
def lanes(request, monkeypatch):
    if request.param == "python":
        monkeypatch.setenv("TB_FASTPATH_DISABLE", "1")
    else:
        monkeypatch.delenv("TB_FASTPATH_DISABLE", raising=False)
    monkeypatch.delenv("TB_WAVES", raising=False)
    return request.param


def run_three(ops, account_ids, transfer_ids, lanes, rows=ROWS, engine="host"):
    """Replay `ops` on the port, the reference and the oracle; every
    reply, the final lookups, the roots and the routing counters must be
    equal.  Returns the port's machine."""
    sm_t = TorchStateMachine(account_capacity=rows, device="cpu", engine=engine)
    sm_j = TpuStateMachine(account_capacity=rows, engine=engine)
    if lanes == "python":
        # The reference reads TB_FASTPATH_DISABLE only until its library
        # has loaded in this process: drop it as tests/test_resolve.py
        # does (the mirror keeps the native memory alive).
        sm_j._native = None
    assert (sm_t._native is not None) == (sm_j._native is not None) == (lanes == "native")
    h_t, h_j = hz.SingleNodeHarness(sm_t), ref_hz.SingleNodeHarness(sm_j)
    h_c = ref_hz.SingleNodeHarness(CpuStateMachine())
    for i, (op, body) in enumerate(ops):
        got = h_t.submit(op, body)
        assert got == h_j.submit(op, body) == h_c.submit(op, body), f"reply {i} differs"
    lk = np.zeros(len(account_ids), dtype=U128_PAIR_DTYPE)
    lk["lo"] = account_ids
    lt = np.zeros(len(transfer_ids), dtype=U128_PAIR_DTYPE)
    lt["lo"] = transfer_ids
    for op, body in ((Op.lookup_accounts, lk.tobytes()), (Op.lookup_transfers, lt.tobytes())):
        assert h_t.submit(op, body) == h_j.submit(op, body) == h_c.submit(op, body), op
    assert sm_t.state_root() == sm_j.state_root()
    for stat in ROUTING:
        assert getattr(sm_t, stat) == getattr(sm_j, stat), stat
    sm_t.verify_device_mirror()
    return sm_t


def _linked_limit_ops(seed):
    rng = np.random.default_rng(seed)
    n_acct = 24
    ops = [(Op.create_accounts, make_accounts(n_acct, limit_frac=0.5).tobytes())]
    k = n_acct // 2
    f = np.zeros(k, dtype=TRANSFER_DTYPE)
    f["id_lo"] = np.arange(900_000, 900_000 + k)
    f["debit_account_id_lo"] = n_acct
    f["credit_account_id_lo"] = np.arange(1, k + 1)
    f["amount_lo"] = rng.integers(100, 800, k)
    f["ledger"] = 1
    f["code"] = 1
    ops.append((Op.create_transfers, f.tobytes()))
    tid = []
    for b in range(4):
        tf = chain_batch(rng, 300, n_acct, 1_000 + b * 10_000)
        tid.extend(tf["id_lo"])
        ops.append((Op.create_transfers, tf.tobytes()))
    return ops, np.arange(1, n_acct + 1), np.asarray(tid)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_linked_limit_parity(seed, lanes):
    """Chains over limit accounts: failure cascades, rollbacks and
    re-credits across the batch land on the sequential answer."""
    sm = run_three(*_linked_limit_ops(seed), lanes)
    assert sm.stat_linked_batches >= 4


def test_linked_static_failures_in_chains(lanes):
    rng = np.random.default_rng(99)
    n_acct = 10
    ops = [(Op.create_accounts, make_accounts(n_acct, limit_frac=0.4).tobytes())]
    tf = chain_batch(rng, 120, n_acct, 5_000)
    tf["ledger"][10] = 9
    tf["amount_lo"][33] = 0
    tf["debit_account_id_lo"][57] = 4_242
    tf["credit_account_id_lo"][80] = tf["debit_account_id_lo"][80]
    ops.append((Op.create_transfers, tf.tobytes()))
    sm = run_three(ops, np.arange(1, n_acct + 1), tf["id_lo"], lanes)
    assert sm.stat_linked_batches >= 1


def test_linked_chain_open_tail(lanes):
    n_acct = 6
    ops = [(Op.create_accounts, make_accounts(n_acct, limit_frac=0.5).tobytes())]
    tf = np.zeros(5, dtype=TRANSFER_DTYPE)
    tf["id_lo"] = np.arange(100, 105)
    tf["flags"] = [0, int(TF.linked), int(TF.linked), int(TF.linked), int(TF.linked)]
    tf["debit_account_id_lo"] = [4, 1, 4, 5, 4]
    tf["credit_account_id_lo"] = [5, 4, 5, 4, 6]
    tf["amount_lo"] = [5, 1_000_000, 7, 8, 9]
    tf["ledger"] = 1
    tf["code"] = 1
    ops.append((Op.create_transfers, tf.tobytes()))
    sm = run_three(ops, np.arange(1, n_acct + 1), tf["id_lo"], lanes)
    assert sm.stat_linked_batches >= 1


def test_plain_batch_on_limit_accounts_routes(lanes):
    """Chain-free batches on limit accounts take the linked lane (chains
    of length 1), not the exact path."""
    rng = np.random.default_rng(5)
    n_acct = 16
    ops = [(Op.create_accounts, make_accounts(n_acct, limit_frac=0.5).tobytes())]
    tf = np.zeros(200, dtype=TRANSFER_DTYPE)
    tf["id_lo"] = np.arange(300, 500)
    dr = rng.integers(1, n_acct + 1, 200)
    cr = rng.integers(1, n_acct + 1, 200)
    clash = cr == dr
    cr[clash] = dr[clash] % n_acct + 1
    tf["debit_account_id_lo"] = dr
    tf["credit_account_id_lo"] = cr
    tf["amount_lo"] = rng.integers(1, 50, 200)
    tf["ledger"] = 1
    tf["code"] = 1
    ops.append((Op.create_transfers, tf.tobytes()))
    sm = run_three(ops, np.arange(1, n_acct + 1), tf["id_lo"], lanes)
    assert sm.stat_linked_batches >= 1 and sm.stat_exact_events == 0


def _two_phase_ops(seed):
    rng = np.random.default_rng(seed)
    n_acct = 40
    ops = [(Op.create_accounts, make_accounts(n_acct).tobytes())]
    prev_pend, tid = [], []
    for b in range(4):
        tf, pend_ids = two_phase_batch(rng, 250, n_acct, 1 + b * 100_000, prev_pend)
        tid.extend(tf["id_lo"])
        ops.append((Op.create_transfers, tf.tobytes()))
        prev_pend.extend(pend_ids[rng.random(len(pend_ids)) < 0.25])
    return ops, np.arange(1, n_acct + 1), np.asarray(tid)


@pytest.mark.parametrize("seed", [10, 11, 12])
def test_two_phase_parity(seed, lanes):
    """Pending / post / void with in-batch and durable references, races,
    inherits, partial posts and mismatch codes."""
    sm = run_three(*_two_phase_ops(seed), lanes)
    assert sm.stat_two_phase_batches >= 3


def test_two_phase_cross_batch_status(lanes):
    n_acct = 4
    ops = [(Op.create_accounts, make_accounts(n_acct).tobytes())]
    t1 = np.zeros(2, dtype=TRANSFER_DTYPE)
    t1["id_lo"] = [10, 11]
    t1["flags"] = [int(TF.pending), int(TF.post_pending_transfer)]
    t1["debit_account_id_lo"][0] = 1
    t1["credit_account_id_lo"][0] = 2
    t1["amount_lo"][0] = 50
    t1["pending_id_lo"][1] = 10
    t1["ledger"][0] = 1
    t1["code"][0] = 1
    ops.append((Op.create_transfers, t1.tobytes()))
    t2 = np.zeros(2, dtype=TRANSFER_DTYPE)
    t2["id_lo"] = [20, 21]
    t2["flags"] = [int(TF.void_pending_transfer), int(TF.post_pending_transfer)]
    t2["pending_id_lo"] = [10, 10]
    ops.append((Op.create_transfers, t2.tobytes()))
    sm = run_three(ops, np.arange(1, n_acct + 1), np.asarray([10, 11, 20, 21]), lanes)
    assert sm.stat_two_phase_batches >= 2


def _punt_ops():
    rng = np.random.default_rng(77)
    n_acct = 12
    ops = [(Op.create_accounts, make_accounts(n_acct, limit_frac=0.5).tobytes())]
    tf = chain_batch(rng, 60, n_acct, 3_000)
    tf["flags"][5] |= int(TF.balancing_debit)
    ops.append((Op.create_transfers, tf.tobytes()))
    dup = np.zeros(4, dtype=TRANSFER_DTYPE)
    dup["id_lo"] = [7_000, 7_000, 7_001, 7_002]
    dup["flags"][3] = int(TF.post_pending_transfer)
    dup["debit_account_id_lo"][:3] = 9
    dup["credit_account_id_lo"][:3] = 10
    dup["amount_lo"][:3] = 5
    dup["pending_id_lo"][3] = 7_000
    dup["ledger"][:3] = 1
    dup["code"][:3] = 1
    ops.append((Op.create_transfers, dup.tobytes()))
    return ops, np.arange(1, n_acct + 1), np.concatenate([tf["id_lo"], dup["id_lo"]])


@pytest.mark.parametrize("engine", ["host", "device"])
def test_resolver_punts_stay_exact(engine, lanes):
    """Shapes outside the resolvers' contracts (a balancing flag in a
    chain, duplicate ids in a pv batch) take the exact path: the native
    serial engine, or without the library the exact path on the device
    (a wave plan or K3).  The device engine's window dispatch may take
    them first; either way the routing equals the reference's."""
    ops, acct, tids = _punt_ops()
    sm = run_three(ops, acct, tids, lanes, engine=engine)
    if engine == "host":
        assert sm.stat_exact_events == len(tids)
        on_device = sm.stat_exact_batches + sm.stat_wave_batches
        assert on_device == (0 if lanes == "native" else 2)


def test_growth_mid_stream(lanes):
    """Accounts past the capacity mid-stream: the table grows twice, and
    with the library on the native object is rebuilt at each growth
    (balances copied, accounts and transfer ids registered again, the
    mirror re-pointed).  Order-free, linked, two-phase and exact batches
    on both sides of each growth."""
    rows = 67
    rng = np.random.default_rng(31)
    tid = []
    ops = []
    spans = ((1, 60), (61, 130), (131, 300))
    for stage, (a0, a1) in enumerate(spans):
        acc = make_accounts(a1, limit_frac=0.3)[a0 - 1 :]
        ops.append((Op.create_accounts, acc.tobytes()))
        base = 1_000_000 * (stage + 1)
        plain = np.zeros(100, dtype=TRANSFER_DTYPE)
        plain["id_lo"] = np.arange(base, base + 100)
        dr = rng.integers(1, a1 + 1, 100)
        plain["debit_account_id_lo"] = dr
        plain["credit_account_id_lo"] = dr % a1 + 1
        plain["amount_lo"] = rng.integers(1, 50, 100)
        plain["ledger"] = 1
        plain["code"] = 1
        ops.append((Op.create_transfers, plain.tobytes()))
        chains = chain_batch(rng, 80, a1, base + 1_000)
        ops.append((Op.create_transfers, chains.tobytes()))
        # Pendings between this stage's accounts (limit-free past the
        # first stage, so the two-phase lane takes them).
        pv, _ = two_phase_batch(rng, 40, a1 - a0 + 1, base + 10_000, [])
        pv["debit_account_id_lo"][0::2] += a0 - 1
        pv["credit_account_id_lo"][0::2] += a0 - 1
        ops.append((Op.create_transfers, pv.tobytes()))
        bal = chain_batch(rng, 30, a1, base + 20_000)
        bal["flags"][3] |= int(TF.balancing_credit)
        ops.append((Op.create_transfers, bal.tobytes()))
        tid += [*plain["id_lo"], *chains["id_lo"], *pv["id_lo"], *bal["id_lo"]]
    sm = run_three(ops, np.arange(1, 301), np.asarray(tid), lanes, rows=rows)
    assert sm._dev.capacity >= 300 and len(sm._mirror.lo) == sm._dev.capacity
    if lanes == "native":
        assert sm._native.capacity == sm._dev.capacity
        assert sm._mirror.lo is sm._native.lo or np.shares_memory(sm._mirror.lo, sm._native.lo)
    assert sm.stat_linked_batches >= 3 and sm.stat_two_phase_batches >= 2
    assert sm.stat_exact_events > 0

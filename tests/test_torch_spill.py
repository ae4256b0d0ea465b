"""The LSM spill tier behind TorchStateMachine, against the reference.

tests/test_lsm_spill.py's spill-across-checkpoints and midstream-restart
cases on both engines: the port's Replica + TorchStateMachine(device=
"cpu") and the reference's Replica + TpuStateMachine replay one stream
on MemoryStorage; replies, query bytes, state roots, checkpoint blob
sizes and storage images must be equal, and the replies also equal the
port's oracle (a CpuStateMachine replica, no forest).

The stream reaches every site that reads or writes the transfer store
by GLOBAL row once rows have spilled: a spilled pending is posted, one
is voided and one expires (the status write goes to the LSM), spilled
ids are looked up and resubmitted (the exists ladder's durable join),
the queries compose spilled and RAM rows (ScanBuilder + RAM tail, the
spilled history), and a restart rebuilds the id directories and the
native id set over the spilled rows.
"""

import numpy as np
import pytest

from tigerbeetle_tpu import constants as ref_cfg
from tigerbeetle_tpu.state_machine.tpu import TpuStateMachine
from tigerbeetle_tpu.vsr import replica as ref_replica
from tigerbeetle_tpu.vsr import storage as ref_storage
from tigerbeetle_tpu_torch import constants as cfg
from tigerbeetle_tpu_torch import types
from tigerbeetle_tpu_torch.state_machine import CpuStateMachine
from tigerbeetle_tpu_torch.state_machine.gpu import TorchStateMachine
from tigerbeetle_tpu_torch.testing.harness import account, ids_bytes, pack, transfer
from tigerbeetle_tpu_torch.vsr import replica as vsr_replica
from tigerbeetle_tpu_torch.vsr import storage as vsr_storage
from torch_link_quiet import link_quiet  # noqa: F401  (autouse: no engine lost its link)

CLUSTER = 11
N_ACCOUNTS = 40
BATCH = 100
# 2,400 transfers: four checkpoints each spill six batches, so the
# transfers groove holds four runs and the pendings of batch 3 lie in
# the oldest of them.
N_BATCHES = 24
# Not a multiple of 8 (the reference's device table stays whole on the
# suite's eight virtual devices).
CAPACITY = (1 << 10) + 3
S = 1_000_000_000

Op = types.Operation
TF = types.TransferFlags
AF = types.AccountFlags

CONF = cfg.Config(
    name="test_spill", message_size_max=1 << 16, lsm_batch_multiple=4,
    pipeline_prepare_queue_max=4, journal_slot_count=64, clients_max=4,
)
REF_CONF = ref_cfg.Config(**{f: getattr(CONF, f) for f in CONF.__dataclass_fields__})

# Pendings created in batch 3 (before the checkpoint after batch 5
# spills them) and finalized well after it.
POST, VOID, EXPIRE = 0, 1, 2


class Side:
    """One package's replica over MemoryStorage."""

    def __init__(self, pkg, engine):
        """`pkg`: "port", "ref" or "oracle" (the port's CpuStateMachine)."""
        self.pkg, self.engine = pkg, engine
        self.conf = REF_CONF if pkg == "ref" else CONF
        storage_mod = ref_storage if pkg == "ref" else vsr_storage
        self.replica_mod = ref_replica if pkg == "ref" else vsr_replica
        self.storage = storage_mod.MemoryStorage(
            storage_mod.ZoneLayout(config=self.conf, grid_size=1 << 20)
        )
        self.replica_mod.format(self.storage, CLUSTER)
        self.r = self.open()

    def open(self):
        if self.pkg == "port":
            sm = TorchStateMachine(self.conf, account_capacity=CAPACITY, device="cpu",
                                   engine=self.engine)
        elif self.pkg == "ref":
            sm = TpuStateMachine(self.conf, account_capacity=CAPACITY, engine=self.engine)
        else:
            sm = CpuStateMachine(self.conf)
        r = self.replica_mod.Replica(self.storage, CLUSTER, sm)
        r.open()
        return r


def build_stream():
    """[(op, body, checkpoint_after)] and the pending ids: accounts
    (some with history), posted transfers, three pendings created
    before a spilling checkpoint and posted, voided and expired after
    it, and a batch resubmitting spilled ids."""
    rng = np.random.default_rng(7)
    ops = [(Op.create_accounts, pack([
        account(i, flags=int(AF.history) if i <= 4 else 0) for i in range(1, N_ACCOUNTS + 1)
    ]), False)]
    next_id = 1
    pendings = []
    for b in range(N_BATCHES):
        rows = []
        for _ in range(BATCH):
            dr = int(rng.integers(1, N_ACCOUNTS + 1))
            rows.append(transfer(next_id, debit_account_id=dr, credit_account_id=dr % N_ACCOUNTS + 1,
                                 amount=int(rng.integers(1, 50))))
            next_id += 1
        if b == 3:
            for k in range(3):
                rid = next_id - 1 - k
                rows[-1 - k] = transfer(rid, debit_account_id=5 + k, credit_account_id=2,
                                        amount=17 + k, flags=int(TF.pending),
                                        timeout=12 if k == EXPIRE else 0)
                pendings.append(rid)
        if b == 9:
            rows[0] = transfer(next_id - BATCH, amount=0, flags=int(TF.post_pending_transfer),
                               pending_id=pendings[POST])
            rows[1] = transfer(next_id - BATCH + 1, amount=0,
                               flags=int(TF.void_pending_transfer), pending_id=pendings[VOID])
        if b == 15:
            # Durable duplicates of spilled rows: the same fields (exists)
            # and a changed amount (exists_with_different_amount).
            rows[0] = transfer(1, debit_account_id=int(rng.integers(1, 9)), credit_account_id=3,
                               amount=999)
            rows[1] = transfer(next_id - 10 * BATCH + 7, debit_account_id=1,
                               credit_account_id=2, amount=1)
        ops.append((Op.create_transfers, pack(rows), b % 6 == 5))
    return ops, next_id - 1, pendings


def query_suite(r, max_tid, pendings):
    out = [r.on_request(int(Op.lookup_accounts), ids_bytes(list(range(1, N_ACCOUNTS + 1))))]
    sample = [1, 2, 3, max_tid // 2, max_tid - 1, max_tid, max_tid + 999, *pendings]
    out.append(r.on_request(int(Op.lookup_transfers), ids_bytes(sample)))
    for acct in (1, 5, 17):
        for flags in (3, 1, 2, 3 | 4):
            f = np.zeros(1, types.ACCOUNT_FILTER_DTYPE)
            f[0]["account_id_lo"] = acct
            f[0]["limit"] = 100
            f[0]["flags"] = flags
            out.append(r.on_request(int(Op.get_account_transfers), f.tobytes()))
    for acct, ts_min in ((2, 0), (3, 0), (4, 0)):
        f = np.zeros(1, types.ACCOUNT_FILTER_DTYPE)
        f[0]["account_id_lo"] = acct
        f[0]["limit"] = 50
        f[0]["flags"] = 3
        f[0]["timestamp_min"] = ts_min
        out.append(r.on_request(int(Op.get_account_balances), f.tobytes()))
    return out


def replay(side, ops, pendings, *, checkpoint=True, restart_at=None):
    """Replies, roots and blob sizes; realtime moves one second an op,
    so the timed pending expires after the spilling checkpoint."""
    replies, roots, blob_sizes = [], [], []
    for i, (op, body, ckpt) in enumerate(ops):
        r = side.r
        if side.pkg == "port" and i in (10, 14):
            # The pendings the next batches finalize live in the LSM.
            base = r.sm._store.base
            rows = [r.sm._transfer_row(p) for p in pendings]
            assert all(row is not None and row < base for row in rows), (rows, base)
        replies.append(r.on_request(int(op), body, realtime=i * S))
        if side.pkg != "oracle":
            roots.append(r.sm.state_root())
        if ckpt and checkpoint:
            r.checkpoint()
            blob_sizes.append(int(r.superblock.working["checkpoint_size"]))
        if restart_at is not None and i == restart_at:
            side.r = side.open()
    return replies, roots, blob_sizes


@pytest.mark.parametrize("engine", ["host", "device"])
def test_spill_across_checkpoints_restart_and_queries(engine):
    ops, max_tid, pendings = build_stream()
    port, ref = Side("port", engine), Side("ref", engine)
    assert port.r.forest is not None and ref.r.forest is not None
    got = replay(port, ops, pendings)
    want = replay(ref, ops, pendings)
    assert got == want

    oracle = Side("oracle", engine)
    assert oracle.r.forest is None
    assert replay(oracle, ops, pendings, checkpoint=False)[0] == got[0]

    sm = port.r.sm
    assert sm._store.base > 16 * BATCH, sm._store.base
    assert sm._store.ram.count < 10 * BATCH
    assert sm._hspill.base > 0
    assert sm.pending_status(pendings[POST]) == types.TransferPendingStatus.posted
    assert sm.pending_status(pendings[VOID]) == types.TransferPendingStatus.voided
    assert sm.pending_status(pendings[EXPIRE]) == types.TransferPendingStatus.expired
    blob_sizes = got[2]
    assert max(blob_sizes) < 600_000, blob_sizes
    assert blob_sizes[-1] < blob_sizes[0] + 200_000

    q = query_suite(port.r, max_tid, pendings)
    assert q == query_suite(ref.r, max_tid, pendings)
    assert q == query_suite(oracle.r, max_tid, pendings)
    assert port.storage._pages.keys() == ref.storage._pages.keys()
    assert all(bytes(port.storage._pages[k]) == bytes(ref.storage._pages[k])
               for k in port.storage._pages)

    # Restart from storage: the forest reopens from its manifest, the
    # id directories and the native id set cover the spilled rows.
    port.r, ref.r = port.open(), ref.open()
    assert port.r.sm._store.base == sm._store.base
    assert port.r.sm.state_root() == ref.r.sm.state_root() == sm.state_root()
    q2 = query_suite(port.r, max_tid, pendings)
    assert q2 == query_suite(ref.r, max_tid, pendings) == q
    dup = pack([transfer(1, debit_account_id=1, credit_account_id=2, amount=1),
                transfer(2, debit_account_id=1, credit_account_id=2, amount=1),
                transfer(max_tid + 5000, debit_account_id=1, credit_account_id=2, amount=1)])
    rep = port.r.on_request(int(Op.create_transfers), dup)
    assert rep == ref.r.on_request(int(Op.create_transfers), dup)
    assert rep == oracle.r.on_request(int(Op.create_transfers), dup)
    assert len(np.frombuffer(rep, types.CREATE_RESULT_DTYPE)) == 2


@pytest.mark.parametrize("engine", ["host", "device"])
def test_spill_restart_midstream(engine):
    """A restart between checkpoints: WAL replay on top of a spilled
    checkpoint reconverges with the reference and the oracle."""
    ops, max_tid, pendings = build_stream()
    port, ref = Side("port", engine), Side("ref", engine)
    got = replay(port, ops, pendings, restart_at=len(ops) // 2)
    want = replay(ref, ops, pendings, restart_at=len(ops) // 2)
    assert got == want
    oracle = Side("oracle", engine)
    assert replay(oracle, ops, pendings, checkpoint=False)[0] == got[0]
    q = query_suite(port.r, max_tid, pendings)
    assert q == query_suite(ref.r, max_tid, pendings)
    assert q == query_suite(oracle.r, max_tid, pendings)


@pytest.mark.parametrize("engine", ["host", "device"])
def test_spilled_snapshot_restores(engine):
    """sm.snapshot() with rows spilled equals the reference's blob, and
    restore() of that blob on a machine with the same forest attached
    answers as the original."""
    ops, max_tid, pendings = build_stream()
    port, ref = Side("port", engine), Side("ref", engine)
    replay(port, ops[:13], pendings)
    replay(ref, ops[:13], pendings)
    blob = port.r.sm.snapshot()
    assert blob == ref.r.sm.snapshot()
    assert port.r.sm._store.base > 0
    fresh = TorchStateMachine(CONF, account_capacity=CAPACITY, device="cpu", engine=engine)
    fresh.attach_forest(type(port.r.forest)(
        port.storage, base_offset=port.r.forest.grid.base,
        block_count=port.r.forest.grid.block_count,
    ))
    fresh.restore(blob)
    assert fresh.snapshot() == blob
    assert fresh.state_root() == port.r.sm.state_root()
    for p in pendings + [1, 2, max_tid // 3]:
        assert fresh.transfer_timestamp(p) == port.r.sm.transfer_timestamp(p)
        assert fresh.pending_status(p) == port.r.sm.pending_status(p)

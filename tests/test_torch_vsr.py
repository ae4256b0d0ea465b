"""The port's durable single replica against the reference's.

tests/test_vsr_durability.py's cases that need no cluster (wire
headers, journal recovery, superblock quorum, replica restart, crash,
WAL wrap, dedupe, two-phase expiry across a restart, the fsync crash,
the crash inside an async checkpoint, the free set's quarantine),
re-pointed at the port's vsr/ modules.  Each case is a scenario run
twice on the same inputs, over the port and over the reference, and the
two runs must give equal replies, headers, recoveries and storage
images; a replica runs on TorchStateMachine(device="cpu") (either
engine, held to TpuStateMachine) or on the port's oracle (held to the
reference's CpuStateMachine).

Then the data file itself: one op stream through the reference's
Replica + TpuStateMachine and the port's Replica + TorchStateMachine on
a FileStorage each, synchronous and asynchronous checkpoints, ends in
byte-equal superblock copies, WAL zone and grid zone; and a file either
package wrote opens in the other and continues with the writer's
replies and state roots.
"""

import importlib
import os
import types as pytypes

import numpy as np
import pytest

from tigerbeetle_tpu.state_machine.tpu import TpuStateMachine
from tigerbeetle_tpu_torch.state_machine.gpu import TorchStateMachine
from torch_link_quiet import link_quiet  # noqa: F401  (autouse: no engine lost its link)

_MODULES = {
    "cfg": "constants",
    "types": "types",
    "wire": "vsr.wire",
    "journal": "vsr.journal",
    "storage": "vsr.storage",
    "superblock": "vsr.superblock",
    "replica": "vsr.replica",
    "free_set": "vsr.free_set",
    "grid": "vsr.grid",
    "harness": "testing.harness",
    "cpu": "state_machine.cpu",
}


def _package(root: str):
    return pytypes.SimpleNamespace(
        **{k: importlib.import_module(f"{root}.{v}") for k, v in _MODULES.items()}
    )


PORT = _package("tigerbeetle_tpu_torch")
REF = _package("tigerbeetle_tpu")
CLUSTER = 7
# Not a multiple of 8: the reference's machine then keeps its device
# table whole on the suite's eight virtual devices, as the port does.
CAPACITY = (1 << 10) + 3
KINDS = ["host", "device", "oracle"]


def machine(m, kind, config=None):
    """A state machine of `kind` from package `m`: the port's
    TorchStateMachine (held to TpuStateMachine) on an engine, or the
    oracle."""
    config = config or m.cfg.TEST_MIN
    if kind == "oracle":
        return m.cpu.CpuStateMachine(config)
    if m is PORT:
        return TorchStateMachine(config, account_capacity=CAPACITY, device="cpu", engine=kind)
    return TpuStateMachine(config, account_capacity=CAPACITY, engine=kind)


class Image:
    """A MemoryStorage's current pages, compared as bytes."""

    def __init__(self, storage):
        self.pages = {k: bytes(v) for k, v in storage._pages.items()}

    def __eq__(self, other):
        return isinstance(other, Image) and self.pages == other.pages

    def __repr__(self):
        return f"Image({len(self.pages)} pages)"


def _same(a, b, what="obs"):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, what
        assert a.tobytes() == b.tobytes(), what
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _same(a[k], b[k], f"{what}[{k!r}]")
    else:
        assert a == b, what


def both(scenario, *args):
    got = scenario(PORT, *args)
    want = scenario(REF, *args)
    _same(got, want)
    return got


def layout(m, config=None):
    return m.storage.ZoneLayout(config=config or m.cfg.TEST_MIN, grid_size=1 << 20)


def fresh_replica(m, kind, storage=None):
    storage = storage or m.storage.MemoryStorage(layout(m))
    m.replica.format(storage, CLUSTER)
    r = m.replica.Replica(storage, CLUSTER, machine(m, kind))
    r.open()
    return storage, r


def reopen(m, kind, storage):
    r = m.replica.Replica(storage, CLUSTER, machine(m, kind))
    r.open()
    return r


def debits_posted(m, r, ids):
    out = r.on_request(m.types.Operation.lookup_accounts, m.harness.ids_bytes(ids))
    rows = np.frombuffer(out, m.types.ACCOUNT_DTYPE)
    return [m.types.u128_get(row, "debits_posted") for row in rows], out


# ----------------------------------------------------------------------
# Wire.


def _header_roundtrip(m):
    wire = m.wire
    h = wire.make_header(
        command=wire.Command.prepare, operation=m.types.Operation.create_transfers,
        cluster=CLUSTER, op=3, timestamp=99, parent=(1 << 100) + 5,
    )
    body = b"x" * 128
    wire.finalize_header(h, body)
    assert wire.verify_header(h, body)
    h2 = wire.header_from_bytes(h.tobytes())
    assert wire.verify_header(h2, body)
    assert wire.u128(h2, "parent") == (1 << 100) + 5
    raw = bytearray(h.tobytes())
    raw[40] ^= 0xFF
    assert not wire.verify_header(wire.header_from_bytes(bytes(raw)), body)
    assert not wire.verify_header(h, body + b"y")
    # The batch finalize (the replica's reply encode) gives the
    # per-header finalize's bytes.
    hs = np.zeros(3, wire.HEADER_DTYPE)
    bodies = [b"", b"a" * 7, b"b" * 300]
    for i in range(3):
        hs[i] = wire.make_header(command=wire.Command.reply, cluster=CLUSTER, op=i + 1,
                                 request=i)
    one = hs.copy()
    for i in range(3):
        wire.finalize_header(one[i:i + 1][0], bodies[i])
    wire.finalize_headers_py(hs, bodies)
    assert hs.tobytes() == one.tobytes()
    return [h.tobytes(), bytes(raw), hs.tobytes(), wire.checksum(body)]


def test_header_roundtrip_and_checksum():
    both(_header_roundtrip)


def _root_prepare(m):
    a = m.wire.root_prepare(5)
    assert a.tobytes() == m.wire.root_prepare(5).tobytes()
    assert a["op"] == 0 and m.wire.verify_header(a, b"")
    return [a.tobytes(), m.wire.root_prepare(CLUSTER).tobytes()]


def test_root_prepare_deterministic():
    both(_root_prepare)


# ----------------------------------------------------------------------
# Journal.


def make_prepare(m, op, parent, body=b"", timestamp=None):
    h = m.wire.make_header(
        command=m.wire.Command.prepare, operation=m.types.Operation.create_accounts,
        cluster=CLUSTER, op=op, timestamp=timestamp or op * 10, parent=parent,
    )
    return m.wire.finalize_header(h, body)


def _journal_with(m, n_ops, body=lambda op: b"", sync=lambda op: True, storage=None):
    storage = storage or m.storage.MemoryStorage(layout(m))
    j = m.journal.Journal(storage, CLUSTER)
    root = m.wire.root_prepare(CLUSTER)
    j.write_prepare(root, b"")
    parent = m.wire.u128(root, "checksum")
    for op in range(1, n_ops + 1):
        h = make_prepare(m, op, parent, body=body(op))
        j.write_prepare(h, body(op), sync=sync(op))
        parent = m.wire.u128(h, "checksum")
    return storage, j


def _recovery(rec):
    return [rec.op_head, rec.faulty_ops, rec.truncated_ops,
            {op: h.tobytes() for op, h in rec.headers.items()}]


def _journal_write_read_recover(m):
    storage, _ = _journal_with(m, 5, body=lambda op: bytes([op]) * 100)
    j2 = m.journal.Journal(storage, CLUSTER)
    rec = j2.recover(commit_min=0)
    assert rec.op_head == 5
    assert not rec.faulty_ops and not rec.truncated_ops
    h, body = j2.read_prepare(3)
    assert body == b"\x03" * 100
    return [_recovery(rec), h.tobytes(), j2.headers.tobytes(), Image(storage)]


def test_journal_write_read_recover():
    both(_journal_write_read_recover)


def _journal_torn_head(m):
    storage, _ = _journal_with(m, 3, sync=lambda op: op < 3)
    storage.crash()
    rec = m.journal.Journal(storage, CLUSTER).recover(commit_min=0)
    assert rec.op_head == 2
    assert rec.faulty_ops == []
    return [_recovery(rec), Image(storage)]


def test_journal_torn_head_truncated():
    both(_journal_torn_head)


def _journal_corrupt_below_head(m):
    storage, _ = _journal_with(m, 4)
    storage.corrupt_sector(storage.layout.prepare_slot_offset(2))
    rec = m.journal.Journal(storage, CLUSTER).recover(commit_min=0)
    assert rec.faulty_ops == [2]
    assert rec.op_head == 4
    return [_recovery(rec)]


def test_journal_corrupt_prepare_below_head_is_faulty():
    both(_journal_corrupt_below_head)


def _journal_ring_wrap(m):
    last = m.cfg.TEST_MIN.journal_slot_count + 10
    storage, _ = _journal_with(m, last)
    rec = m.journal.Journal(storage, CLUSTER).recover(commit_min=last - 5)
    assert rec.op_head == last
    return [_recovery(rec), Image(storage)]


def test_journal_ring_wrap():
    both(_journal_ring_wrap)


def _recover_both_ways(m, storage, commit_min, window=3):
    out = []
    for probe_all in (False, True):
        j = m.journal.Journal(storage, CLUSTER)
        j.RECOVER_HEAD_WINDOW = window
        j.RECOVER_PROBE_ALL = probe_all
        reads0 = storage.reads
        rec = j.recover(commit_min=commit_min)
        out.append((_recovery(rec), j.headers.tobytes(), storage.reads - reads0))
    (rec_w, ring_w, reads_w), (rec_f, ring_f, reads_f) = out
    assert rec_w == rec_f and ring_w == ring_f
    return out


def _write_raw_prepare(m, storage, h, body):
    msg = h.tobytes() + body
    storage.write(
        storage.layout.prepare_slot_offset(int(h["op"]) % m.cfg.TEST_MIN.journal_slot_count),
        msg.ljust(m.storage._sectors(len(msg)), b"\x00"),
    )


def _windowed_recover(m):
    slots = m.cfg.TEST_MIN.journal_slot_count

    def build(n_ops):
        return _journal_with(m, n_ops, body=lambda op: bytes([op & 0xFF]) * 64)[0]

    obs = []
    storage = build(slots + 12)
    w, f = _recover_both_ways(m, storage, commit_min=slots + 4)
    assert w[2] < f[2]
    obs.append(w)

    storage = build(slots + 12)
    storage.corrupt_sector(storage.layout.prepare_slot_offset((slots + 12 - 20) % slots))
    obs.append(_recover_both_ways(m, storage, commit_min=slots + 4)[0])

    storage = build(slots + 12)
    storage.corrupt_sector(storage.layout.prepare_slot_offset((slots + 6) % slots))
    w, _ = _recover_both_ways(m, storage, commit_min=slots + 4)
    assert slots + 6 in w[0][1]
    obs.append(w)

    storage = build(slots + 8)
    j = m.journal.Journal(storage, CLUSTER)
    rec = j.recover(commit_min=slots)
    parent = m.wire.u128(rec.headers[rec.op_head], "checksum")
    for op in range(slots + 9, slots + 12):
        h = make_prepare(m, op, parent, body=b"t" * 32)
        j.write_prepare(h, b"t" * 32, sync=(op < slots + 11))
        parent = m.wire.u128(h, "checksum")
    storage.crash()
    obs.append(_recover_both_ways(m, storage, commit_min=slots + 2)[0])

    storage = build(slots + 12)
    j = m.journal.Journal(storage, CLUSTER)
    j.recover(commit_min=slots + 4)
    new_op = slots + 13
    h = make_prepare(m, new_op, m.wire.u128(j.headers[(slots + 12) % slots], "checksum"),
                     body=b"n" * 48)
    _write_raw_prepare(m, storage, h, b"n" * 48)
    storage.sync()
    w, _ = _recover_both_ways(m, storage, commit_min=slots + 5)
    assert w[0][0] == new_op
    obs.append(w)

    storage = build(slots + 12)
    j = m.journal.Journal(storage, CLUSTER)
    j.recover(commit_min=slots + 4)
    h13 = make_prepare(m, slots + 13, m.wire.u128(j.headers[(slots + 12) % slots], "checksum"),
                       body=b"a" * 48)
    _write_raw_prepare(m, storage, h13, b"a" * 48)
    h14 = make_prepare(m, slots + 14, m.wire.u128(h13, "checksum"), body=b"b" * 48)
    _write_raw_prepare(m, storage, h14, b"b" * 48)
    j.headers[(slots + 14) % slots] = h14
    j._write_header_sector((slots + 14) % slots)
    storage.sync()
    w, _ = _recover_both_ways(m, storage, commit_min=slots + 5)
    assert w[0][0] == slots + 14
    obs.append(w)
    return obs


def test_journal_windowed_recover_equivalence():
    both(_windowed_recover)


# ----------------------------------------------------------------------
# SuperBlock.


def _superblock_quorum(m):
    storage = m.storage.MemoryStorage(layout(m))
    sb = m.superblock.SuperBlock(storage, CLUSTER)
    sb.format(replica=0, replica_count=1)
    sb.checkpoint(
        commit_min=24, commit_min_checksum=123, commit_max=24,
        checkpoint_offset=storage.layout.grid_offset, checkpoint_size=100,
        checkpoint_checksum=9,
    )
    h = m.superblock.SuperBlock(storage, CLUSTER).open()
    assert int(h["sequence"]) == 2 and int(h["commit_min"]) == 24
    image = Image(storage)
    storage.corrupt_sector(0)
    storage.corrupt_sector(4096)
    assert int(m.superblock.SuperBlock(storage, CLUSTER).open()["sequence"]) == 2
    storage.corrupt_sector(2 * 4096)
    with pytest.raises(RuntimeError, match="no quorum"):
        m.superblock.SuperBlock(storage, CLUSTER).open()
    return [h.tobytes(), image]


def test_superblock_quorum_and_sequence():
    both(_superblock_quorum)


# ----------------------------------------------------------------------
# Replica end to end.


def _basic_restart_replay(m, kind):
    hz, Op = m.harness, m.types.Operation
    storage, r = fresh_replica(m, kind)
    assert r.on_request(Op.create_accounts, hz.pack([hz.account(1), hz.account(2)])) == b""
    assert r.on_request(Op.create_transfers, hz.pack(
        [hz.transfer(10, debit_account_id=1, credit_account_id=2, amount=100)])) == b""
    r2 = reopen(m, kind, storage)
    assert r2.op == r.op
    out = r2.on_request(Op.lookup_accounts, hz.ids_bytes([1, 2]))
    rows = np.frombuffer(out, m.types.ACCOUNT_DTYPE)
    assert m.types.u128_get(rows[0], "debits_posted") == 100
    assert m.types.u128_get(rows[1], "credits_posted") == 100
    return [out, r2.op, Image(storage)]


@pytest.mark.parametrize("kind", KINDS)
def test_replica_basic_and_restart_replay(kind):
    both(_basic_restart_replay, kind)


def _crash_loses_unsynced_tail(m, kind):
    hz, Op = m.harness, m.types.Operation
    storage, r = fresh_replica(m, kind)
    r.on_request(Op.create_accounts, hz.pack([hz.account(1), hz.account(2)]))
    r.on_request(Op.create_transfers, hz.pack(
        [hz.transfer(10, debit_account_id=1, credit_account_id=2, amount=7)]))
    storage.crash()
    posted, out = debits_posted(m, reopen(m, kind, storage), [1])
    assert posted == [7]
    return [out, Image(storage)]


@pytest.mark.parametrize("kind", KINDS)
def test_replica_crash_loses_unsynced_tail_only(kind):
    both(_crash_loses_unsynced_tail, kind)


def _checkpoint_and_wal_wrap(m, kind):
    hz, Op = m.harness, m.types.Operation
    storage, r = fresh_replica(m, kind)
    r.on_request(Op.create_accounts, hz.pack([hz.account(1), hz.account(2)]))
    n_ops = m.cfg.TEST_MIN.journal_slot_count * 3
    roots = []
    for i in range(n_ops):
        r.on_request(Op.create_transfers, hz.pack(
            [hz.transfer(100 + i, debit_account_id=1, credit_account_id=2, amount=1)]))
        if kind != "oracle" and i % 16 == 0:
            roots.append(r.sm.state_root())
    assert r.checkpoint_op > 0
    r2 = reopen(m, kind, storage)
    assert r2.commit_min == r.commit_min
    posted, out = debits_posted(m, r2, [1])
    assert posted == [n_ops]
    return [out, roots, r.checkpoint_op, r.superblock.working.tobytes(), Image(storage)]


@pytest.mark.parametrize("kind", KINDS)
def test_replica_checkpoint_and_wal_wrap(kind):
    both(_checkpoint_and_wal_wrap, kind)


def _dedupe(m, kind):
    hz, Op, types = m.harness, m.types.Operation, m.types
    storage, r = fresh_replica(m, kind)
    r.register_client(42)
    b1 = r.on_request(Op.create_accounts, hz.pack([hz.account(1)]), client=42, request=1)
    b2 = r.on_request(Op.create_accounts, hz.pack([hz.account(1)]), client=42, request=1)
    assert b1 == b2 == b""
    b3 = r.on_request(Op.create_accounts, hz.pack([hz.account(1)]), client=42, request=2)
    arr = np.frombuffer(b3, types.CREATE_RESULT_DTYPE)
    assert types.CreateAccountResult(int(arr[0]["result"])).name == "exists"
    return [b3, r.sessions[42].reply_header, Image(storage)]


@pytest.mark.parametrize("kind", KINDS)
def test_replica_dedupe_replays_reply(kind):
    both(_dedupe, kind)


def _two_phase_expiry(m, kind, path):
    hz, Op, types = m.harness, m.types.Operation, m.types
    storage = m.storage.FileStorage(path, layout(m), create=True)
    m.replica.format(storage, CLUSTER)
    r = m.replica.Replica(storage, CLUSTER, machine(m, kind))
    r.open()
    r.on_request(Op.create_accounts, hz.pack([hz.account(1), hz.account(2)]))
    r.on_request(Op.create_transfers, hz.pack([hz.transfer(
        10, debit_account_id=1, credit_account_id=2, amount=50, timeout=1,
        flags=types.TransferFlags.pending)]))
    r.close()
    storage.close()
    storage = m.storage.FileStorage(path, layout(m))
    r2 = m.replica.Replica(storage, CLUSTER, machine(m, kind))
    r2.open()
    out = r2.on_request(Op.lookup_accounts, hz.ids_bytes([1]), realtime=10 * types.NS_PER_S)
    row = np.frombuffer(out, types.ACCOUNT_DTYPE)[0]
    assert types.u128_get(row, "debits_pending") == 0
    assert r2.sm.pending_status(10) == types.TransferPendingStatus.expired
    ts = r2.sm.transfer_timestamp(10)
    assert ts is not None
    r2.close()
    storage.close()
    with open(path, "rb") as f:
        control = f.read()
    return [out, ts, control]


@pytest.mark.parametrize("kind", KINDS)
def test_replica_two_phase_expiry_survives_restart(kind, tmp_path):
    got = _two_phase_expiry(PORT, kind, str(tmp_path / "port.tb"))
    want = _two_phase_expiry(REF, kind, str(tmp_path / "ref.tb"))
    _same(got, want)


def _fsync_crash(m, kind):
    hz, Op = m.harness, m.types.Operation
    storage, r = fresh_replica(m, kind)
    r.on_request(Op.create_accounts, hz.pack([hz.account(1), hz.account(2)]))
    r.on_request(Op.create_transfers, hz.pack(
        [hz.transfer(10, debit_account_id=1, credit_account_id=2, amount=5)]))
    op_before = r.op
    storage.crash_at_fsync = 1
    with pytest.raises(m.storage.FsyncCrash):
        r.on_request(Op.create_transfers, hz.pack(
            [hz.transfer(11, debit_account_id=1, credit_account_id=2, amount=900)]))
    storage.crash()
    r2 = reopen(m, kind, storage)
    assert r2.op == op_before
    posted, out = debits_posted(m, r2, [1])
    assert posted == [5]
    return [out, Image(storage)]


@pytest.mark.parametrize("kind", KINDS)
def test_crash_at_fsync_request_never_acked(kind):
    both(_fsync_crash, kind)


def _mid_async_checkpoint_crash(m, kind):
    hz, Op = m.harness, m.types.Operation
    storage, r = fresh_replica(m, kind)
    r.on_request(Op.create_accounts, hz.pack([hz.account(1), hz.account(2)]))
    n_ops = m.cfg.TEST_MIN.vsr_checkpoint_interval + 7
    for i in range(n_ops):
        r.on_request(Op.create_transfers, hz.pack(
            [hz.transfer(100 + i, debit_account_id=1, credit_account_id=2, amount=2)]))
    assert r.checkpoint_op > 0
    seq_before = int(r.superblock.working["sequence"])
    commit_before = r.commit_min
    r._checkpoint_freeze()  # the freeze half only; the flip never runs
    storage.crash()
    r2 = reopen(m, kind, storage)
    assert int(r2.superblock.working["sequence"]) == seq_before
    assert r2.checkpoint_op == r.checkpoint_op
    assert r2.commit_min == commit_before
    out = r2.on_request(Op.lookup_accounts, hz.ids_bytes([1, 2]))
    rows = np.frombuffer(out, m.types.ACCOUNT_DTYPE)
    assert m.types.u128_get(rows[0], "debits_posted") == 2 * n_ops
    assert m.types.u128_get(rows[1], "credits_posted") == 2 * n_ops
    return [out, Image(storage)]


@pytest.mark.parametrize("kind", KINDS)
def test_mid_async_checkpoint_crash_recovers_previous_superblock(kind):
    both(_mid_async_checkpoint_crash, kind)


def _free_set_quarantine(m):
    fs = m.free_set.FreeSet(8)
    res = fs.reserve(3)
    a, b, c = fs.acquire(res), fs.acquire(res), fs.acquire(res)
    fs.forfeit(res)
    fs.release(a)
    fs.release(b)
    fs.checkpoint()
    assert fs.is_free(a) and fs.is_free(b)
    res2 = fs.reserve(5)
    got = {fs.acquire(res2) for _ in range(5)}
    fs.forfeit(res2)
    assert a not in got and b not in got
    blob = fs.encode()
    decoded = m.free_set.FreeSet.decode(blob, 8)
    assert decoded.is_free(a) and decoded.is_free(b)
    fs.checkpoint()
    res3 = fs.reserve(2)
    got3 = {fs.acquire(res3) for _ in range(2)}
    fs.forfeit(res3)
    assert got3 == {a, b}
    fs.release(c)
    fs.checkpoint()
    fs.release_quarantine()
    res4 = fs.reserve(1)
    assert fs.acquire(res4) == c
    fs.forfeit(res4)
    return [sorted(got), bytes(blob), sorted(got3), fs.encode()]


def test_free_set_quarantines_released_blocks_until_flip():
    both(_free_set_quarantine)


def _checkpoint_restart(m, kind):
    hz, Op = m.harness, m.types.Operation
    storage, r = fresh_replica(m, kind)
    r.on_request(Op.create_accounts, hz.pack([hz.account(1), hz.account(2)]))
    n_ops = m.cfg.TEST_MIN.vsr_checkpoint_interval + 5
    for i in range(n_ops):
        r.on_request(Op.create_transfers, hz.pack(
            [hz.transfer(100 + i, debit_account_id=1, credit_account_id=2, amount=2)]))
    assert r.checkpoint_op > 0
    assert r.forest is not None and r.sm._store.base > 0
    r2 = reopen(m, kind, storage)
    assert r2.commit_min == r.commit_min
    assert r2.sm.state_root() == r.sm.state_root()
    out = r2.on_request(Op.lookup_accounts, hz.ids_bytes([1, 2]))
    rows = np.frombuffer(out, m.types.ACCOUNT_DTYPE)
    assert m.types.u128_get(rows[0], "debits_posted") == 2 * n_ops
    tr = r2.on_request(Op.lookup_transfers, hz.ids_bytes([100, 101, 100 + n_ops - 1]))
    assert len(tr) == 3 * 128
    return [out, tr, r.sm.state_root(), Image(storage)]


@pytest.mark.parametrize("kind", ["host", "device"])
def test_replica_state_machine_checkpoint_restart(kind):
    both(_checkpoint_restart, kind)


# ----------------------------------------------------------------------
# The data file: byte equality and opens across the packages.

# A configuration whose batches outgrow the forest's memtable quickly
# (test_min's 4 KiB messages cap a batch at 30 events).
def spill_config(m):
    return m.cfg.Config(
        name="test_spill", message_size_max=1 << 16, lsm_batch_multiple=4,
        pipeline_prepare_queue_max=4, journal_slot_count=64, clients_max=4,
    )


N_ACCOUNTS = 20


def op_stream(m, n_batches=14, batch=300, seed=3):
    """[(op, body, checkpoint_after)]: accounts (some with history), then
    transfer batches with a pending created early and posted, voided or
    left to expire across checkpoints."""
    hz, Op, TF, AF = m.harness, m.types.Operation, m.types.TransferFlags, m.types.AccountFlags
    rng = np.random.default_rng(seed)
    ops = [(Op.create_accounts, hz.pack([
        hz.account(i, flags=int(AF.history) if i <= 3 else 0) for i in range(1, N_ACCOUNTS + 1)
    ]), False)]
    next_id = 1
    pendings = []
    for b in range(n_batches):
        rows = []
        for _ in range(batch):
            dr = int(rng.integers(1, N_ACCOUNTS + 1))
            rows.append(hz.transfer(next_id, debit_account_id=dr,
                                    credit_account_id=dr % N_ACCOUNTS + 1,
                                    amount=int(rng.integers(1, 50))))
            next_id += 1
        if b in (1, 2):
            for k in range(3):
                rows[-1 - k] = hz.transfer(next_id - 1 - k, debit_account_id=4 + k,
                                           credit_account_id=8, amount=11 + k,
                                           flags=int(TF.pending), timeout=2 if k == 2 else 0)
                pendings.append(next_id - 1 - k)
        if b == 9:
            rows[0] = hz.transfer(next_id - batch, amount=0, pending_id=pendings[0],
                                  flags=int(TF.post_pending_transfer))
            rows[1] = hz.transfer(next_id - batch + 1, amount=0, pending_id=pendings[1],
                                  flags=int(TF.void_pending_transfer))
        ops.append((Op.create_transfers, hz.pack(rows), b % 4 == 3))
    return ops, next_id - 1


def query_suite(m, r, max_tid):
    hz, Op, types = m.harness, m.types.Operation, m.types
    out = [r.on_request(Op.lookup_accounts, hz.ids_bytes(list(range(1, N_ACCOUNTS + 1))))]
    sample = [1, 2, 3, max_tid // 2, max_tid - 1, max_tid, max_tid + 999]
    out.append(r.on_request(Op.lookup_transfers, hz.ids_bytes(sample)))
    for acct in (1, 4, 8):
        for flags in (3, 1, 2, 3 | 4):
            f = np.zeros(1, types.ACCOUNT_FILTER_DTYPE)
            f[0]["account_id_lo"] = acct
            f[0]["limit"] = 100
            f[0]["flags"] = flags
            out.append(r.on_request(Op.get_account_transfers, f.tobytes()))
    f = np.zeros(1, types.ACCOUNT_FILTER_DTYPE)
    f[0]["account_id_lo"] = 2
    f[0]["limit"] = 50
    f[0]["flags"] = 3
    out.append(r.on_request(Op.get_account_balances, f.tobytes()))
    return out


def _file_machine(m, engine, config):
    if m is PORT:
        return TorchStateMachine(config, account_capacity=CAPACITY, device="cpu", engine=engine)
    return TpuStateMachine(config, account_capacity=CAPACITY, engine=engine)


def open_file(m, path, engine, create=False):
    config = spill_config(m)
    storage = m.storage.FileStorage(path, layout(m, config), create=create)
    if create:
        m.replica.format(storage, CLUSTER)
    r = m.replica.Replica(storage, CLUSTER, _file_machine(m, engine, config))
    r.open()
    return storage, r


def drive(r, ops, realtime0=0):
    """Replies and state roots after each op; a checkpoint where the
    stream asks for one; realtime moves so the timed pending expires."""
    replies, roots = [], []
    for i, (op, body, ckpt) in enumerate(ops):
        replies.append(r.on_request(int(op), body, realtime=realtime0 + i * 1_000_000_000))
        roots.append(r.sm.state_root())
        if ckpt:
            r.checkpoint()
    return replies, roots


def _extents(fd, size):
    """Data extents of a sparse file ([(lo, hi)]), or the whole file
    where SEEK_DATA is not supported."""
    out, at = [], 0
    try:
        while at < size:
            lo = os.lseek(fd, at, os.SEEK_DATA)
            hi = os.lseek(fd, lo, os.SEEK_HOLE)
            out.append((lo, hi))
            at = hi
    except OSError:
        return [(0, size)] if size else []
    return out


def assert_files_equal(path_a, path_b, layout_):
    for suffix in ("", ".grid"):
        a, b = path_a + suffix, path_b + suffix
        sa, sb = os.path.getsize(a), os.path.getsize(b)
        assert sa == sb, f"{suffix or 'control'} file sizes differ: {sa} vs {sb}"
        with open(a, "rb") as fa, open(b, "rb") as fb:
            spans = sorted(set(_extents(fa.fileno(), sa)) | set(_extents(fb.fileno(), sb)))
            assert spans or not sa
            for lo, hi in spans:
                fa.seek(lo)
                fb.seek(lo)
                while lo < hi:
                    n = min(1 << 24, hi - lo)
                    da, db = fa.read(n), fb.read(n)
                    if da != db:
                        at = lo + next(i for i in range(n) if da[i] != db[i])
                        if not suffix:
                            zone = ("superblock" if at < layout_.wal_headers_offset
                                    else "wal" if at < layout_.client_replies_offset
                                    else "client replies")
                        else:
                            zone = "grid"
                        raise AssertionError(f"{zone} zone differs at byte {at}")
                    lo += n


@pytest.mark.parametrize("ckpt_async", ["0", "1"])
@pytest.mark.parametrize("engine", ["host", "device"])
def test_data_file_bytes_equal_reference(engine, ckpt_async, tmp_path, monkeypatch):
    """One op stream through both packages' replicas on FileStorage:
    equal replies and roots, and after close() byte-equal superblock
    copies, WAL zone, client replies and grid zone."""
    monkeypatch.setenv("TB_CKPT_ASYNC", ckpt_async)
    results = {}
    for name, m in (("port", PORT), ("ref", REF)):
        ops, max_tid = op_stream(m)
        path = str(tmp_path / f"{name}.tb")
        storage, r = open_file(m, path, engine, create=True)
        replies, roots = drive(r, ops)
        queries = query_suite(m, r, max_tid)
        assert r.sm._store.base > 0, "the stream spilled no rows"
        flips = int(r.superblock.working["sequence"])
        r.close()
        r.forest.grid.flush_writes()  # the reference's close() leaves them queued
        storage.close()
        results[name] = (replies, roots, queries, flips)
    _same(results["port"], results["ref"])
    assert results["port"][3] >= 3  # format + at least two checkpoint flips
    assert_files_equal(str(tmp_path / "port.tb"), str(tmp_path / "ref.tb"),
                       layout(PORT, spill_config(PORT)))


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_file_opens_in_the_other_package(writer, tmp_path):
    """A file one package wrote and checkpointed (rows spilled) opens in
    the other, which carries on with the writer's replies and roots."""
    pkgs = {"port": PORT, "ref": REF}
    reader = "port" if writer == "ref" else "ref"
    ops, max_tid = op_stream(PORT)
    head, tail = ops[:11], ops[11:]
    paths = {}
    for copy in ("a", "b"):  # the writer's stream twice: one file each
        m = pkgs[writer]
        path = str(tmp_path / f"{copy}.tb")
        storage, r = open_file(m, path, "host", create=True)
        drive(r, op_stream(m)[0][:11])
        assert r.sm._store.base > 0
        r.close()
        r.forest.grid.flush_writes()
        storage.close()
        paths[copy] = path
    assert_files_equal(paths["a"], paths["b"], layout(PORT, spill_config(PORT)))
    out = {}
    for name, copy in ((writer, "a"), (reader, "b")):
        m = pkgs[name]
        storage, r = open_file(m, paths[copy], "host")
        root0 = r.sm.state_root()
        replies, roots = drive(r, op_stream(m)[0][11:], realtime0=11 * 1_000_000_000)
        out[name] = (root0, replies, roots, query_suite(m, r, max_tid))
        r.close()
        r.forest.grid.flush_writes()
        storage.close()
    assert len(tail) == len(out[reader][1])
    _same(out[reader], out[writer])


def test_close_lands_queued_grid_writes(tmp_path):
    """The port's close() joins the grid's queued block writes (spill
    and merge beats queue them on the grid's writer thread) before the
    caller closes the storage; the reference's leaves them queued."""
    ops, _ = op_stream(PORT, n_batches=6)
    storage, r = open_file(PORT, str(tmp_path / "port.tb"), "host", create=True)
    drive(r, ops)
    grid = r.forest.grid
    res = grid.free_set.reserve(1)
    address = grid.free_set.acquire(res)
    grid.free_set.forfeit(res)
    grid.write_block(address, b"x" * 100)
    assert grid._write_futures
    r.close()
    assert not grid._write_futures and not grid._pending_writes
    storage.close()
    storage = PORT.storage.FileStorage(str(tmp_path / "port.tb"), layout(PORT, spill_config(PORT)))
    assert PORT.grid.Grid(storage, base_offset=grid.base,
                          block_count=grid.block_count).read_block(address) == b"x" * 100
    storage.close()

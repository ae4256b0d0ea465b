"""The port's native library and its bindings against the reference's.

- Call by call: TpuStateMachine runs seeded streams with its native
  object replaced by a tee that forwards every call to the reference's
  NativeFastpath (whose outputs it returns) and to the port's, fed the
  same balances first.  Each commit_transfers, commit_linked,
  commit_two_phase and commit_exact call must give equal results,
  slots, deltas, last_applied and the same balances after it.
- decode_store on random wire records, column for column.
- linked_resolve / two_phase_resolve: the port's on the arguments the
  reference's received during a TpuStateMachine run, output for output.
- The build: a changed source gets a library under a new digest, and a
  broken one raises unless TB_FASTPATH_DISABLE=1 (then the machine runs
  its Python lanes).
"""

import collections

import numpy as np
import pytest

from test_resolve import chain_batch, make_accounts, two_phase_batch
from tigerbeetle_tpu.runtime import fastpath as ref_fp
from tigerbeetle_tpu.state_machine import resolve as ref_resolve
from tigerbeetle_tpu.state_machine.tpu import TpuStateMachine
from tigerbeetle_tpu.testing import harness as ref_hz
from tigerbeetle_tpu_torch import workload
from tigerbeetle_tpu_torch.kernels import host_build
from tigerbeetle_tpu_torch.runtime import fastpath
from tigerbeetle_tpu_torch.state_machine import resolve
from tigerbeetle_tpu_torch.state_machine.gpu import TorchStateMachine
from tigerbeetle_tpu_torch.types import TRANSFER_DTYPE, Operation, TransferFlags

Op = Operation
TF = TransferFlags
ROWS = (1 << 10) + 3


def _same(a, b, what):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _same(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, tuple):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


class Tee:
    """A reference NativeFastpath and a port one in lockstep: state
    calls go to both; each commit call first copies the reference's
    balances into the port's (Python paths mutate the shared mirror
    between calls) and then holds every output and the balances after
    it equal."""

    calls: collections.Counter = collections.Counter()

    def __init__(self, capacity):
        self.ref = _REF_NATIVE(capacity)
        self.port = fastpath.NativeFastpath(capacity)
        self.capacity = capacity
        self.lo, self.hi = self.ref.lo, self.ref.hi

    def __getattr__(self, name):
        ref_fn, port_fn = getattr(self.ref, name), getattr(self.port, name)
        if not name.startswith("commit_"):
            def both(*args, **kw):
                port_fn(*args, **kw)
                return ref_fn(*args, **kw)
            return both

        def compared(*args, **kw):
            self.port.lo[:] = self.ref.lo
            self.port.hi[:] = self.ref.hi
            want = ref_fn(*args, **kw)
            got = port_fn(*args, **kw)
            assert (want is None) == (got is None), name
            if want is not None:
                _same(want, got, name)
                key = name + ("/join" if name == "commit_two_phase" and args[3] is not None
                              else "")
                Tee.calls[key] += 1
            np.testing.assert_array_equal(self.port.lo, self.ref.lo, err_msg=f"{name} lo")
            np.testing.assert_array_equal(self.port.hi, self.ref.hi, err_msg=f"{name} hi")
            return want
        return compared


_REF_NATIVE = ref_fp.NativeFastpath


def _streams():
    """Order-free, linked (limit accounts), two-phase (in-batch and
    durable targets, races) and exact-path (balancing) batches, with the
    accounts growing past the first capacity mid-stream."""
    rng = np.random.default_rng(17)
    ops = [(Op.create_accounts, make_accounts(40, limit_frac=0.5).tobytes())]
    f = np.zeros(20, dtype=TRANSFER_DTYPE)
    f["id_lo"] = np.arange(900_000, 900_020)
    f["debit_account_id_lo"] = 40
    f["credit_account_id_lo"] = np.arange(1, 21)
    f["amount_lo"] = rng.integers(100, 800, 20)
    f["ledger"] = 1
    f["code"] = 1
    ops.append((Op.create_transfers, f.tobytes()))
    for b in range(2):
        ops.append((Op.create_transfers, chain_batch(rng, 200, 40, 1_000 + b * 10_000).tobytes()))
        bal = chain_batch(rng, 50, 40, 50_000 + b * 1_000)
        bal["flags"][7] |= int(TF.balancing_debit)
        ops.append((Op.create_transfers, bal.tobytes()))
    more = make_accounts(1100)[40:]
    ops.append((Op.create_accounts, more.tobytes()))  # past ROWS: the tee is rebuilt
    prev = []
    for b in range(3):
        tf, pend = two_phase_batch(rng, 150, 1000, 100_000 * (b + 1), prev)
        tf["debit_account_id_lo"][0::2] += 100
        tf["credit_account_id_lo"][0::2] += 100
        ops.append((Op.create_transfers, tf.tobytes()))
        prev.extend(pend[rng.random(len(pend)) < 0.3])
    for b in range(3):  # order-free, between limit-free accounts
        dr = rng.integers(100, 1100, 600).astype(np.uint64)
        ids = np.arange(500_000 + b * 600, 500_600 + b * 600, dtype=np.uint64)
        ops.append((Op.create_transfers, workload.transfers_bytes(
            ids, dr, dr % np.uint64(1000) + np.uint64(100),
            rng.integers(1, 100, 600).astype(np.uint64))))
    return ops


def test_native_calls_equal_reference(monkeypatch):
    monkeypatch.delenv("TB_FASTPATH_DISABLE", raising=False)
    monkeypatch.delenv("TB_WAVES", raising=False)
    monkeypatch.setattr(ref_fp, "NativeFastpath", Tee)
    Tee.calls.clear()
    sm = TpuStateMachine(account_capacity=ROWS)
    assert isinstance(sm._native, Tee) and sm._native.capacity == ROWS
    h = ref_hz.SingleNodeHarness(sm)
    for op, body in _streams():
        h.submit(op, body)
    assert isinstance(sm._native, Tee) and sm._native.capacity > ROWS  # rebuilt by the growth
    for name in ("commit_transfers", "commit_linked", "commit_two_phase",
                 "commit_two_phase/join", "commit_exact"):
        assert Tee.calls[name] > 0, (name, dict(Tee.calls))


def test_decode_store_equals_reference():
    rng = np.random.default_rng(3)
    n = 777
    wire = rng.integers(0, 256, (n, 128), dtype=np.uint8)
    events = wire.reshape(-1).view(TRANSFER_DTYPE)
    from tigerbeetle_tpu_torch.state_machine.gpu import _STORE_FIELDS

    cols = [{k: np.zeros(n + 9, v) for k, v in _STORE_FIELDS.items()} for _ in range(2)]
    ref_fp.decode_store(events, n, 123_456, cols[0], 9)
    fastpath.decode_store(events, n, 123_456, cols[1], 9)
    for k in _STORE_FIELDS:
        np.testing.assert_array_equal(cols[0][k], cols[1][k], err_msg=k)
    assert cols[1]["timestamp"][9] == 123_456 and cols[1]["id_lo"][:9].sum() == 0


def _recorded(monkeypatch, name, ops):
    """The reference's resolver `name`'s calls during a run of `ops`
    (Python lanes): (args with the mirror copied at the call, output)."""
    real = getattr(ref_resolve, name)
    seen = []

    class Mirror:
        def __init__(self, m):
            self.lo, self.hi = m.lo.copy(), m.hi.copy()

    def record(*args):
        args = tuple(Mirror(a) if hasattr(a, "lo") and hasattr(a, "hi") else a for a in args)
        out = real(*args)
        seen.append((args, out))
        return out

    monkeypatch.setattr(ref_resolve, name, record)
    sm = TpuStateMachine(account_capacity=ROWS)
    sm._native = None
    h = ref_hz.SingleNodeHarness(sm)
    for op, body in ops:
        h.submit(op, body)
    return seen


@pytest.mark.parametrize("seed", [1, 2])
def test_linked_resolve_equals_reference(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    ops = [(Op.create_accounts, make_accounts(24, limit_frac=0.5).tobytes())]
    for b in range(3):
        ops.append((Op.create_transfers, chain_batch(rng, 300, 24, 1_000 + b * 10_000).tobytes()))
    seen = _recorded(monkeypatch, "linked_resolve", ops)
    assert len(seen) >= 3
    for args, want in seen:
        _same(want, resolve.linked_resolve(*args), "linked_resolve")


@pytest.mark.parametrize("seed", [10, 11])
def test_two_phase_resolve_equals_reference(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    ops = [(Op.create_accounts, make_accounts(40).tobytes())]
    prev = []
    for b in range(3):
        tf, pend = two_phase_batch(rng, 200, 40, 1 + b * 100_000, prev)
        ops.append((Op.create_transfers, tf.tobytes()))
        prev.extend(pend[rng.random(len(pend)) < 0.25])
    seen = _recorded(monkeypatch, "two_phase_resolve", ops)
    assert len(seen) >= 3 and any(out is not None for _, out in seen)
    for args, want in seen:
        _same(want, resolve.two_phase_resolve(*args), "two_phase_resolve")


def _copy_sources(dst):
    dst.mkdir()
    for path in host_build.sources():
        (dst / path.name).write_bytes(path.read_bytes())
    return dst


def test_source_change_rebuilds_under_new_digest(tmp_path):
    src = _copy_sources(tmp_path / "src")
    assert host_build.digest(src) == host_build.digest()
    with open(src / "tb_linked.inc", "a") as f:
        f.write("\n// edited\n")
    out = tmp_path / "build"
    path, seconds = host_build.build(src, out)
    assert path.name != host_build.library_path().name and path.is_file() and seconds > 0
    assert path == host_build.library_path(src, out)
    assert host_build.build(src, out) == (path, 0.0)  # found, not rebuilt
    lib = fastpath.load(src, out)
    nf = fastpath.NativeFastpath(8, lib=lib)
    assert nf.lo.shape == (8, 4)


def test_broken_build_raises_unless_disabled(tmp_path, monkeypatch):
    src = _copy_sources(tmp_path / "src")
    text = (src / host_build.MAIN).read_text()
    (src / host_build.MAIN).write_text("#error deliberately broken\n" + text)
    monkeypatch.setattr(host_build, "HOST_SRC", src)
    monkeypatch.setattr(host_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.delenv("TB_FASTPATH_DISABLE", raising=False)
    with pytest.raises(fastpath.NativeFastpathError, match="deliberately broken"):
        TorchStateMachine(account_capacity=64, device="cpu", engine="host")
    monkeypatch.setenv("TB_FASTPATH_DISABLE", "1")
    sm = TorchStateMachine(account_capacity=64, device="cpu", engine="host")
    assert sm._native is None and not fastpath.available()

"""Run a reference test module's cases twice: on the reference and on the port.

The port's cluster, server and client modules are copies of the
reference's, so a reference test of them is re-pointed by loading its
source a second time with every ``tigerbeetle_tpu`` module name
rewritten to ``tigerbeetle_tpu_torch`` (and, where the source names the
reference's JAX state machine, the port's ``TorchStateMachine`` on the
CPU in its place).  `run_both` runs one case in each package under a
recorder that keeps what the case's clusters did: every client reply
the case asked for, every reply each of its clusters' clients received,
each replica's ``HashLog`` digests op by op, its commit point and state
root, the bytes of every ``MemoryStorage``, and what each of its
``SimFollower``s served and refused (with each ``FollowerVopr``'s
nemesis and read counters), and every op each ``SingleNodeHarness``
submitted with its reply and its machine's final state root.
The two recordings must be equal, and each run must pass the case's own
assertions (or, for a case both packages are known to fail, fail the
same assertion: ``fails=True``).  A case that imports ``jax.numpy as
jnp`` gets numpy under that name in the port's run, so it hands the
port numpy arrays.  Its calls of the reference's
``waves._spec_conflicts`` (K9 over a dict of event columns) go through
`spec_conflicts`, which records the flags of the lanes below `n`: in
the reference's run to ``waves._spec_conflicts`` itself, in the port's
to `port_spec_conflicts`, the port's plain K9 over the same columns
packed.

An `arm` picks the state machine every cluster of the case runs:
"oracle" keeps the case's own (the CPU oracle, by default), "host" and
"device" put ``TorchStateMachine(device="cpu")`` on that engine in the
port's run and ``TpuStateMachine`` on it in the reference's.  In the
port's run the chaos factory (``testing/chaos.device_chaos_factory``,
the VOPR's device-loss nemesis) builds its machines on the CPU too.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import importlib.util
import inspect
import re
import sys
import time
import types as pytypes
from pathlib import Path

import pytest

from tigerbeetle_tpu_torch.testing.seeded import FOLLOWER_VOPR_COUNTERS

TESTS = Path(__file__).resolve().parent
PORT, REF = "tigerbeetle_tpu_torch", "tigerbeetle_tpu"
# Not a multiple of 8: the reference's machine then keeps its device
# table whole on the suite's eight virtual devices, as the port does.
CAPACITY = (1 << 10) + 3


def _port_source(text: str) -> str:
    # Every rewrite keeps the source's line numbers (a failure's line is
    # part of the recording).
    text = re.sub(r"\btigerbeetle_tpu\b", PORT, text)
    # At module level or inside a case (kept at the import's indent).
    text = re.sub(
        rf"^( *)from {PORT}\.state_machine\.tpu import TpuStateMachine$",
        lambda m: (
            f"{m[1]}from {PORT}.state_machine.gpu import TorchStateMachine as _Torch; "
            "TpuStateMachine = lambda *a, **kw: _Torch(*a, device='cpu', **kw)"
        ),
        text, flags=re.M,
    )
    # A subprocess's source in a string builds the port's machine on the
    # CPU where the reference's builds TpuStateMachine.
    text = text.replace(
        f'"from {PORT}.state_machine.tpu import TpuStateMachine;"',
        f'"from {PORT}.state_machine.gpu import TorchStateMachine;"'
        '"TpuStateMachine = lambda *a, **kw: TorchStateMachine(*a, device=\'cpu\', **kw);"',
    )
    # The port takes numpy (and torch) arrays, never jax's.
    text = re.sub(r"^import jax\.numpy as jnp$", "import numpy as jnp", text, flags=re.M)
    text = _spec_calls(text, PORT)
    # The port's engine keeps its speculation counters as ints (its
    # registry pulls them); the reference's are registry handles.
    text = text.replace(
        "name: handle.value\n        for name, handle in sm._dev.spec_stats.items()\n"
        "        if hasattr(handle, \"value\")",
        "name: getattr(handle, \"value\", handle)\n"
        "        for name, handle in sm._dev.spec_stats.items()\n"
        "        if hasattr(handle, \"value\") or isinstance(handle, int)",
    )
    # A module-level import of a module the port does not have yet
    # (testing/vopr.py, ...) is dropped; the cases that use it are not
    # re-pointed.
    text = re.sub(
        rf"^from ({PORT}[\w.]*) import .*$",
        lambda m: m.group(0) if importlib.util.find_spec(m.group(1)) else "",
        text, flags=re.M,
    )
    # Likewise a module-level parenthesized import naming something the
    # port's module does not have (test_envcheck.py's device_engine
    # helper lives in the port's envcheck.py).
    text = re.sub(
        rf"^from ({PORT}[\w.]*) import \(([^)]*)\)\n",
        lambda m: m.group(0) if _has_names(m.group(1), m.group(2)) else "\n" * m[0].count("\n"),
        text, flags=re.M,
    )
    return text


def _spec_calls(text: str, package: str) -> str:
    """`text` with its calls of ``waves._spec_conflicts`` made through
    `spec_conflicts` for `package`."""
    if "waves._spec_conflicts(" not in text:
        return text
    text = text.replace("waves._spec_conflicts(", f"_torch_repoint.spec_conflicts({package!r}, ")
    return text + "\nimport torch_repoint as _torch_repoint\n"


# The recording's list of spec_conflicts flags while a case runs.
_SPEC_FLAGS: list | None = None


def spec_conflicts(package: str, ev: dict, serial, n, A: int, B: int):
    """A re-pointed case's call of ``waves._spec_conflicts(ev, serial,
    n, A, B)``: the reference's in its run, `port_spec_conflicts` in the
    port's.  The flags of the lanes below `n` go into the recording."""
    if package == PORT:
        out = port_spec_conflicts(ev, serial, n, A, B)
    else:
        out = importlib.import_module(f"{REF}.state_machine.waves")._spec_conflicts(
            ev, serial, n, A, B)
    if _SPEC_FLAGS is not None:
        import numpy as np

        _SPEC_FLAGS.append(np.asarray(out).astype(bool)[:int(n)].tolist())
    return out


def port_spec_conflicts(ev: dict, serial, n, A: int, B: int):
    """The reference's ``waves._spec_conflicts(ev, serial, n, A, B)``
    computed by the port's plain K9: the (B,) event columns `ev` (the
    ones K9 reads; every other column zero) packed as K3 packs them, all
    B lanes, the (B,) bool force-conflict mask `serial`.  Returns (B,)
    bool flags as a numpy array."""
    import numpy as np
    import torch

    from tigerbeetle_tpu_torch.state_machine import kernel, waves

    cols = {name: np.zeros(B, dtype) for name, dtype in kernel.EVENT_FIELDS}
    cols.update({k: np.asarray(v) for k, v in ev.items()})
    packed = torch.from_numpy(kernel.pack_events(cols).view(np.int64))
    lanes = torch.arange(B, dtype=torch.int32)
    mask = torch.from_numpy(np.asarray(serial, bool).astype(np.uint8))
    return waves.spec_conflicts_plain(packed, lanes, mask, int(n), A).numpy()


def _has_names(module: str, names: str) -> bool:
    if importlib.util.find_spec(module) is None:
        return False
    mod = importlib.import_module(module)
    wanted = [n.split(" as ")[0].strip() for n in names.split(",")]
    return all(hasattr(mod, n) for n in wanted if n)


_LOADED: dict[tuple[str, str], pytypes.ModuleType] = {}


def load(test_file: str, package: str) -> pytypes.ModuleType:
    """The test module `test_file` (a name under tests/) loaded for
    `package`, its pytest fixtures unwrapped into plain functions."""
    key = (test_file, package)
    mod = _LOADED.get(key)
    if mod is not None:
        return mod
    text = (TESTS / test_file).read_text()
    text = _port_source(text) if package == PORT else _spec_calls(text, REF)
    # Helpers imported from another reference test module come from
    # that module loaded for the same package.
    for dep in sorted(set(re.findall(r"^from (test_\w+) import", text, flags=re.M))):
        text = text.replace(f"from {dep} import", f"from {load(dep + '.py', package).__name__} import")
    mod = exec_source(test_file, f"_repoint_{package}_{Path(test_file).stem}", text)
    _LOADED[key] = mod
    return mod


def exec_source(test_file: str, name: str, text: str) -> pytypes.ModuleType:
    """`text` (a test module's source, already re-pointed) run as module
    `name`, its pytest fixtures unwrapped into plain functions."""
    text = re.sub(r"^@pytest\.fixture(\(.*\))?\n", "\n", text, flags=re.M)
    mod = pytypes.ModuleType(name)
    mod.__file__ = str(TESTS / test_file)
    sys.modules[name] = mod
    exec(compile(text, str(TESTS / test_file), "exec"), mod.__dict__)
    return mod


def case_names(test_file: str) -> list[str]:
    text = (TESTS / test_file).read_text()
    return re.findall(r"^def (test_\w+)\(", text, flags=re.M)


def _machine_factory(package: str, arm: str, config):
    if arm == "oracle":
        return None
    if package == PORT:
        from tigerbeetle_tpu_torch.state_machine.gpu import TorchStateMachine

        return lambda: TorchStateMachine(
            config, account_capacity=CAPACITY, device="cpu", engine=arm
        )
    from tigerbeetle_tpu.state_machine.tpu import TpuStateMachine

    return lambda: TpuStateMachine(config, account_capacity=CAPACITY, engine=arm)


def machine(package: str, arm: str):
    """A fresh state machine of `package` on `arm`, for a case's ``sm``
    fixture (tests/conftest.py's): "oracle" the package's CPU oracle,
    "host" and "device" as `_machine_factory` builds them."""
    if arm == "oracle":
        return importlib.import_module(f"{package}.state_machine.cpu").CpuStateMachine()
    config = importlib.import_module(f"{package}.constants").PRODUCTION
    return _machine_factory(package, arm, config)()


class Recorder:
    """What the clusters of one case did."""

    def __init__(self) -> None:
        self.clusters: list = []
        self.sharded: list = []
        self.follower_voprs: list = []
        self.replies: list[bytes] = []
        # Per SingleNodeHarness: its machine and [(op, body, reply future)].
        self.harnesses: list[tuple[object, list]] = []
        # Per spec_conflicts call: the flags of the lanes below n.
        self.spec_flags: list[list[bool]] = []

    def harness_observations(self) -> list:
        out = []
        for sm, ops in self.harnesses:
            root = sm.state_root() if hasattr(sm, "state_root") else None
            out.append((
                [(int(op), body, fut.result() if fut.done() else None)
                 for op, body, fut in ops],
                root,
            ))
        return out

    def observations(self) -> list:
        out = []
        for c in self.clusters:
            replicas = []
            for r in c.replicas:
                sm = getattr(r, "sm", None)
                root = sm.state_root() if hasattr(sm, "state_root") else None
                replicas.append((r.commit_min, root))
            hash_logs = [sorted(h._digests.items()) for h in c.hash_logs]
            images = [
                sorted((k, bytes(v)) for k, v in s._pages.items()) for s in c.storages
            ]
            client_replies = [
                (cid, list(cl.replies)) for cid, cl in sorted(c.clients.items())
                if hasattr(cl, "replies")
            ]
            followers = [
                (list(f.served), list(f.refusals), f.crashes, f.core.commit_min,
                 f.core.attested_op, f.core.poisoned,
                 sorted(f.core.registry.snapshot().items()))
                for f in getattr(c, "followers", ())
            ]
            out.append({
                "replicas": replicas, "hash_logs": hash_logs, "images": images,
                "client_replies": client_replies, "followers": followers,
            })
        routed = [
            [(cl.id, list(cl.replies)) for cl in sc.clients] for sc in self.sharded
        ]
        voprs = [
            {k: getattr(v, k) for k in FOLLOWER_VOPR_COUNTERS} for v in self.follower_voprs
        ]
        return [{"replies": self.replies, "routed_replies": routed,
                 "follower_voprs": voprs, "harnesses": self.harness_observations(),
                 "spec_flags": self.spec_flags}, *out]



@contextlib.contextmanager
def recording(package: str, arm: str, monkeypatch):
    cl = importlib.import_module(f"{package}.testing.cluster")
    rec = Recorder()
    init = cl.Cluster.__init__
    run_request = cl.Cluster.run_request

    def recording_init(self, *args, **kwargs):
        config = kwargs.get("config", cl.cfg.TEST_MIN)
        factory = _machine_factory(package, arm, config)
        if factory is not None:
            kwargs["state_machine_factory"] = factory
        init(self, *args, **kwargs)
        rec.clusters.append(self)

    def recording_run_request(self, *args, **kwargs):
        reply = run_request(self, *args, **kwargs)
        rec.replies.append(reply)
        return reply

    def pinned(request):
        # A request's trace_ts is the client's monotonic clock
        # (observability only); pinned to (client, request) here so the
        # two runs frame byte-equal prepares.
        def pinned_request(self, *args, **kwargs):
            with monkeypatch.context() as m:
                m.setattr(time, "perf_counter_ns",
                          lambda: (self.id << 32) | (self.request_number + 1))
                return request(self, *args, **kwargs)

        return pinned_request

    with monkeypatch.context() as m:
        m.setattr(cl.Cluster, "__init__", recording_init)
        m.setattr(cl.Cluster, "run_request", recording_run_request)
        for client in (cl.SimClient, cl.RoutedClient):
            m.setattr(client, "request", pinned(client.request))
        # The router's harness: its shards are Clusters (recorded
        # above); its replies and routed clients are recorded here.
        sharded_init = cl.ShardedCluster.__init__
        sharded_run_request = cl.ShardedCluster.run_request

        def recording_sharded_init(self, *args, **kwargs):
            sharded_init(self, *args, **kwargs)
            rec.sharded.append(self)

        def recording_sharded_run_request(self, *args, **kwargs):
            reply = sharded_run_request(self, *args, **kwargs)
            rec.replies.append(reply)
            return reply

        m.setattr(cl.ShardedCluster, "__init__", recording_sharded_init)
        m.setattr(cl.ShardedCluster, "run_request", recording_sharded_run_request)
        vopr = importlib.import_module(f"{package}.testing.vopr")
        follower_vopr_init = vopr.FollowerVopr.__init__

        def recording_follower_vopr_init(self, *args, **kwargs):
            follower_vopr_init(self, *args, **kwargs)
            rec.follower_voprs.append(self)

        m.setattr(vopr.FollowerVopr, "__init__", recording_follower_vopr_init)
        harness = importlib.import_module(f"{package}.testing.harness")
        dispatch = harness.SingleNodeHarness._dispatch

        def recording_dispatch(self, operation, input_bytes):
            fut = dispatch(self, operation, input_bytes)
            ops = next((o for sm, o in rec.harnesses if sm is self.sm), None)
            if ops is None:
                ops = []
                rec.harnesses.append((self.sm, ops))
            ops.append((operation, bytes(input_bytes), fut))
            return fut

        m.setattr(harness.SingleNodeHarness, "_dispatch", recording_dispatch)
        m.setattr(sys.modules[__name__], "_SPEC_FLAGS", rec.spec_flags)
        if package == PORT:
            chaos = importlib.import_module(f"{PORT}.testing.chaos")
            m.setattr(
                chaos, "device_chaos_factory",
                functools.partial(chaos.device_chaos_factory, device="cpu"),
            )
        yield rec


def _call(mod, fn, fixtures: dict, teardown: list):
    """Call `fn` with its parameters resolved: the given fixtures, or
    the module's own fixture functions (generators run to their yield,
    finished in `teardown`)."""
    kwargs = {
        name: _fixture(mod, name, fixtures, teardown)
        for name in inspect.signature(fn).parameters
    }
    return fn(**kwargs)


def _fixture(mod, name: str, fixtures: dict, teardown: list):
    """The value of fixture `name`: given, or the module's fixture
    function called once (a generator run to its yield, finished in
    `teardown`)."""
    if name in fixtures:
        return fixtures[name]
    value = _call(mod, getattr(mod, name), fixtures, teardown)
    if inspect.isgenerator(value):
        gen = value
        value = next(gen)
        teardown.append(gen)
    fixtures[name] = value
    return value


def reference_native_loaded() -> None:
    """Load the reference's native libraries in this process, retrying
    after a failed load.  The reference builds them with `make -C
    native` at first use and caches a failure for the process; its
    runtime library is not committed, so on a fresh checkout the xdist
    workers run that make at once and a worker can load a library
    another worker is still writing.  Here the loads happen under a file
    lock in build/, and a cached failure is cleared and retried."""
    import fcntl

    from tigerbeetle_tpu.runtime import fastpath as ref_fastpath
    from tigerbeetle_tpu.runtime import native as ref_native

    if ref_native._lib is not None and ref_fastpath._lib is not None:
        return
    lock_dir = TESTS.parent / "build"
    lock_dir.mkdir(exist_ok=True)
    with open(lock_dir / ".reference_native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        for _ in range(3):
            if ref_native._load() is not None and ref_fastpath._load() is not None:
                return
            ref_native._lib_failed = ref_native._make_attempted = False
            ref_fastpath._lib_failed = False
            time.sleep(1.0)
    raise RuntimeError("the reference's native libraries did not load")


def first_engine_ordinal(package: str, monkeypatch) -> None:
    """Count `package`'s device engines from 0 again.  Each engine seeds
    its first scrub's offset with the process's engine ordinal
    (device_engine._ENGINE_SEQ), so a package that built more engines
    earlier in the same process (an xdist worker's earlier files) would
    scrub at other fetches than the other package."""
    engine = sys.modules.get(f"{package}.state_machine.device_engine")
    if engine is not None:
        monkeypatch.setattr(engine, "_ENGINE_SEQ", 0)


def _failure(test_file: str, err: AssertionError) -> tuple[int, str]:
    """Where in `test_file` the case's assertion `err` failed: the line
    of its last frame in that file, and its message."""
    line, tb = 0, err.__traceback__
    while tb is not None:
        if tb.tb_frame.f_code.co_filename == str(TESTS / test_file):
            line = tb.tb_lineno
        tb = tb.tb_next
    return line, str(err)


def run_case(test_file: str, case: str, package: str, arm: str, tmp_path, extra=None,
             autouse=(), per_package=None, fails=False):
    """One run of `case` in `package`; returns its recording.  `extra`:
    more fixtures by name (capsys, ...) or parameter values; `autouse`:
    names of the module's autouse fixtures to run first; `per_package`:
    fixtures by name whose value is made for the package (name ->
    function of the package's name); `fails`: the case must fail one of
    its own assertions, and the recording's "failure" says which (its
    line and message; None when `fails` is false)."""
    if package == REF:
        reference_native_loaded()
    mod = load(test_file, package)
    with pytest.MonkeyPatch.context() as mp:
        first_engine_ordinal(package, mp)
        with recording(package, arm, mp) as rec:
            teardown: list = []
            fixtures = {"monkeypatch": mp, "tmp_path": tmp_path / package, **(extra or {})}
            for name, make in (per_package or {}).items():
                fixtures[name] = make(package)
            fixtures["tmp_path"].mkdir()
            failure = None
            try:
                for name in autouse:
                    _fixture(mod, name, fixtures, teardown)
                try:
                    _call(mod, getattr(mod, case), fixtures, teardown)
                except AssertionError as err:
                    if not fails:
                        raise
                    failure = _failure(test_file, err)
                else:
                    if fails:
                        raise AssertionError(f"{case} passed in {package}; it should fail")
            finally:
                for gen in reversed(teardown):
                    with contextlib.suppress(StopIteration):
                        next(gen)
    obs = rec.observations()
    obs[0]["failure"] = failure
    return obs


def run_both(test_file: str, case: str, arm: str, tmp_path, extra=None, autouse=(),
             per_package=None, fails=False) -> list:
    """`case` on the port and on the reference: both pass (with `fails`,
    both fail the same assertion), and their recordings are equal.
    Returns the port's."""
    got = run_case(test_file, case, PORT, arm, tmp_path, extra, autouse, per_package, fails)
    want = run_case(test_file, case, REF, arm, tmp_path, extra, autouse, per_package, fails)
    assert got[0]["failure"] == want[0]["failure"], "the runs failed differently"
    assert len(got) == len(want), "the runs built different numbers of clusters"
    assert got[0]["replies"] == want[0]["replies"], "client replies differ"
    assert got[0]["routed_replies"] == want[0]["routed_replies"], "routed client replies differ"
    assert got[0]["follower_voprs"] == want[0]["follower_voprs"], "FollowerVopr counters differ"
    assert got[0]["spec_flags"] == want[0]["spec_flags"], "spec_conflicts flags differ"
    assert len(got[0]["harnesses"]) == len(want[0]["harnesses"]), "harness counts differ"
    for i, (g, w) in enumerate(zip(got[0]["harnesses"], want[0]["harnesses"])):
        assert g[0] == w[0], f"harness {i}: ops or replies differ"
        assert g[1] == w[1], f"harness {i}: state roots differ"
    for i, (g, w) in enumerate(zip(got[1:], want[1:])):
        for key in ("replicas", "hash_logs", "images", "client_replies", "followers"):
            assert g[key] == w[key], f"cluster {i}: {key} differ"
    return got

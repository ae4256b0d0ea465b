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
nemesis and read counters).
The two recordings must be equal, and each run must pass the case's own
assertions.

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
    text = re.sub(r"\btigerbeetle_tpu\b", PORT, text)
    # At module level or inside a case (kept at the import's indent).
    text = re.sub(
        rf"^( *)from {PORT}\.state_machine\.tpu import TpuStateMachine$",
        lambda m: (
            f"{m[1]}from {PORT}.state_machine.gpu import TorchStateMachine as _Torch\n"
            f"{m[1]}def TpuStateMachine(*a, **kw):\n"
            f"{m[1]}    return _Torch(*a, device='cpu', **kw)\n"
        ),
        text, flags=re.M,
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
        lambda m: m.group(0) if _has_names(m.group(1), m.group(2)) else "",
        text, flags=re.M,
    )
    return text


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
    if package == PORT:
        text = _port_source(text)
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
    text = re.sub(r"^@pytest\.fixture(\(.*\))?\n", "", text, flags=re.M)
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


class Recorder:
    """What the clusters of one case did."""

    def __init__(self) -> None:
        self.clusters: list = []
        self.sharded: list = []
        self.follower_voprs: list = []
        self.replies: list[bytes] = []

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
                 "follower_voprs": voprs}, *out]



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


def run_case(test_file: str, case: str, package: str, arm: str, tmp_path, extra=None,
             autouse=()):
    """One run of `case` in `package`; returns its recording.  `extra`:
    more fixtures by name (capsys, ...) or parameter values; `autouse`:
    names of the module's autouse fixtures to run first."""
    if package == REF:
        reference_native_loaded()
    mod = load(test_file, package)
    with pytest.MonkeyPatch.context() as mp:
        first_engine_ordinal(package, mp)
        with recording(package, arm, mp) as rec:
            teardown: list = []
            fixtures = {"monkeypatch": mp, "tmp_path": tmp_path / package, **(extra or {})}
            fixtures["tmp_path"].mkdir()
            try:
                for name in autouse:
                    _fixture(mod, name, fixtures, teardown)
                _call(mod, getattr(mod, case), fixtures, teardown)
            finally:
                for gen in reversed(teardown):
                    with contextlib.suppress(StopIteration):
                        next(gen)
    return rec.observations()


def run_both(test_file: str, case: str, arm: str, tmp_path, extra=None, autouse=()) -> list:
    """`case` on the port and on the reference: both pass, and their
    recordings are equal.  Returns the port's."""
    got = run_case(test_file, case, PORT, arm, tmp_path, extra, autouse)
    want = run_case(test_file, case, REF, arm, tmp_path, extra, autouse)
    assert len(got) == len(want), "the runs built different numbers of clusters"
    assert got[0]["replies"] == want[0]["replies"], "client replies differ"
    assert got[0]["routed_replies"] == want[0]["routed_replies"], "routed client replies differ"
    assert got[0]["follower_voprs"] == want[0]["follower_voprs"], "FollowerVopr counters differ"
    for i, (g, w) in enumerate(zip(got[1:], want[1:])):
        for key in ("replicas", "hash_logs", "images", "client_replies", "followers"):
            assert g[key] == w[key], f"cluster {i}: {key} differ"
    return got

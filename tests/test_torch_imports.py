"""The PyTorch port stands alone: it imports neither JAX nor any module
of the JAX package, at import time or lazily inside a function."""

import ast
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "tigerbeetle_tpu_torch"


def _forbidden(name: str) -> bool:
    return (
        name in ("jax", "jaxlib", "tigerbeetle_tpu")
        or name.startswith(("jax.", "jaxlib.", "tigerbeetle_tpu."))
    )


def test_port_modules_import_without_jax():
    """A fresh interpreter imports every port module and chip_smoke.py;
    afterwards no jax*, tigerbeetle_tpu or tigerbeetle_tpu.* module is
    loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import tigerbeetle_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', 'tigerbeetle_tpu')\n"
        "             or m.startswith(('jax.', 'jaxlib.', 'tigerbeetle_tpu.')))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def test_port_sources_name_no_jax_import():
    """Static scan: no import statement anywhere in the port or in
    chip_smoke.py names JAX or the JAX package (catches lazy imports
    inside functions the subprocess check never runs)."""
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.name}:{node.lineno} {n}" for n in names if _forbidden(n)]
    assert not offenders, offenders


def test_runtime_subpackage_imports_without_jax():
    """The runtime subpackage (the native library's bindings) imports
    and loads its library in a fresh interpreter without JAX or the JAX
    package."""
    code = (
        "import sys\n"
        "from tigerbeetle_tpu_torch.runtime import fastpath\n"
        "assert fastpath.available()\n"
        "nf = fastpath.NativeFastpath(16)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', 'tigerbeetle_tpu')\n"
        "             or m.startswith(('jax.', 'jaxlib.', 'tigerbeetle_tpu.')))\n"
        "assert not bad, bad\n"
        "print(fastpath.build_info['path'])\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env.pop("TB_FASTPATH_DISABLE", None)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert Path(out.stdout.strip()).parent == REPO / "build" / "native"


def test_native_build_reads_only_the_port_sources():
    """The native library is built from csrc/host/ of the port and
    nothing else: the compile command names only that directory's main
    file, the digest covers exactly its files, and no source there
    includes a file from elsewhere (the reference's native/ included)."""
    import re

    from tigerbeetle_tpu_torch.kernels import host_build

    src = PORT / "csrc" / "host"
    assert host_build.HOST_SRC == src
    cmd = host_build.command(Path("/dev/null"))
    paths = [a for a in cmd[1:] if "/" in a and a != "/dev/null"]
    assert paths == [str(src / host_build.MAIN), str(src / "tb_pipeline.cpp")], paths
    cmd = host_build.command(Path("/dev/null"), name="runtime")
    paths = [a for a in cmd[1:] if "/" in a and a != "/dev/null"]
    assert paths == [str(src / "tb_runtime.cpp"), str(src / "tb_async.cpp")], paths
    names = {p.name for p in host_build.sources()}
    assert names == {"tb_fastpath.cpp", "tb_exact.inc", "tb_linked.inc", "tb_two_phase.inc",
                     "tb_lsm.inc", "tb_pipeline.cpp", "sha256.h", "hash_pool.h",
                     "tb_runtime.cpp", "tb_async.cpp", "tb_client.h"}
    for path in host_build.sources():
        for inc in re.findall(r'#include\s+"([^"]+)"', path.read_text()):
            assert "/" not in inc and (src / inc).is_file(), (path.name, inc)
    for module in ("kernels/host_build.py", "runtime/native.py", "runtime/fastpath.py"):
        text = (PORT / module).read_text()
        assert "native/" not in text.replace("build/native/", ""), module


# The modules of the VSR, server, client and CLI slice.
VSR_SLICE = (
    "vsr.clock", "vsr.scrubber", "vsr.aof", "vsr.multi", "qos", "testing.hash_log",
    "testing.cluster", "runtime.native", "runtime.affinity", "obs.flight", "obs.scrape",
    "runtime.server", "client", "flags", "cli",
)


def test_vsr_slice_loads_nothing_of_native_or_jax(tmp_path):
    """A fresh interpreter imports the slice's modules, builds and loads
    both native libraries, opens a bus and serves a request: neither JAX
    nor the JAX package is loaded, and no shared object of the
    reference's native/ directory is mapped."""
    code = (
        "import importlib, sys\n"
        f"for m in {VSR_SLICE!r}: importlib.import_module('tigerbeetle_tpu_torch.' + m)\n"
        "from tigerbeetle_tpu_torch import constants as cfg\n"
        "from tigerbeetle_tpu_torch.runtime import fastpath, native\n"
        "from tigerbeetle_tpu_torch.runtime.server import ReplicaServer, format_data_file\n"
        "from tigerbeetle_tpu_torch.state_machine import CpuStateMachine\n"
        "from tigerbeetle_tpu_torch.vsr import wire\n"
        "assert fastpath.pipeline_available()\n"
        "assert native.native_checksum128(b'x') == wire.checksum(b'x')\n"
        f"p = {str(tmp_path / 'r.tb')!r}\n"
        "format_data_file(p, cluster=1, config=cfg.TEST_MIN)\n"
        "s = ReplicaServer(p, cluster=1, addresses=['127.0.0.1:0'], replica_index=0,\n"
        "                  state_machine_factory=lambda: CpuStateMachine(cfg.TEST_MIN),\n"
        "                  config=cfg.TEST_MIN)\n"
        "s.poll_once(1)\n"
        "s.close()\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', 'tigerbeetle_tpu')\n"
        "             or m.startswith(('jax.', 'jaxlib.', 'tigerbeetle_tpu.')))\n"
        "assert not bad, bad\n"
        "maps = open('/proc/self/maps').read()\n"
        f"assert {str(REPO / 'native')!r} + '/' not in maps\n"
        "libs = sorted({l.split()[-1] for l in maps.splitlines() if 'libtb_' in l})\n"
        "print('\\n'.join('LIB ' + l for l in libs))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env["TB_FLIGHT_PATH"] = str(tmp_path / "flight.json")
    env.pop("TB_FASTPATH_DISABLE", None)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=180,
    )
    assert out.returncode == 0, out.stderr
    libs = [line[4:] for line in out.stdout.splitlines() if line.startswith("LIB ")]
    assert {Path(p).name.split("-")[0] for p in libs} == {"libtb_fastpath", "libtb_runtime"}
    assert all(Path(p).parent == REPO / "build" / "native" for p in libs), libs


def test_cli_version_loads_neither_jax_nor_the_jax_package():
    """`python -m tigerbeetle_tpu_torch version` in a fresh interpreter,
    with sys.modules checked at exit."""
    code = (
        "import atexit, runpy, sys\n"
        "def check():\n"
        "    bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', 'tigerbeetle_tpu')\n"
        "                 or m.startswith(('jax.', 'jaxlib.', 'tigerbeetle_tpu.')))\n"
        "    print('BAD', bad) if bad else print('CLEAN')\n"
        "atexit.register(check)\n"
        "sys.argv = ['tigerbeetle_tpu_torch', 'version']\n"
        "runpy.run_module('tigerbeetle_tpu_torch', run_name='__main__')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["0.1.0", "CLEAN"], out.stdout
    plain = subprocess.run(
        [sys.executable, "-m", "tigerbeetle_tpu_torch", "version"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert plain.returncode == 0 and plain.stdout.strip() == "0.1.0", plain.stderr


# The modules of the VOPR, fuzzer, soak and CLI tools slice.
TOOLS_SLICE = (
    "utils.statsd", "testing.vopr", "testing.fuzz", "testing.soak", "testing.cluster",
    "repl", "bindings", "benchmark", "cli",
)


def test_tools_slice_runs_without_jax(tmp_path):
    """A fresh interpreter imports the slice's modules and runs each
    once: a short VOPR, one fuzzer, the bindings, the trace demo and the
    in-process benchmark on the oracle.  Neither JAX nor the JAX package
    is loaded."""
    code = (
        "import importlib, sys\n"
        f"for m in {TOOLS_SLICE!r}: importlib.import_module('tigerbeetle_tpu_torch.' + m)\n"
        "from tigerbeetle_tpu_torch import bindings\n"
        "from tigerbeetle_tpu_torch.benchmark import run_benchmark\n"
        "from tigerbeetle_tpu_torch.testing.cluster import trace_demo\n"
        "from tigerbeetle_tpu_torch.testing.fuzz import FUZZERS\n"
        "from tigerbeetle_tpu_torch.testing.vopr import Vopr\n"
        "Vopr(3, requests=10).run()\n"
        "FUZZERS['journal'](1, 5)\n"
        f"bindings.generate({str(tmp_path / 'b')!r})\n"
        f"trace_demo({str(tmp_path / 't.json')!r}, batches=1)\n"
        "r = run_benchmark(addresses=None, cluster=0, n_transfers=200, n_accounts=20,\n"
        "                  batch=100, use_cpu=True)\n"
        "assert r['transfers'] == 200\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', 'tigerbeetle_tpu')\n"
        "             or m.startswith(('jax.', 'jaxlib.', 'tigerbeetle_tpu.')))\n"
        "assert not bad, bad\n"
        "print('CLEAN')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env["TB_FLIGHT_PATH"] = str(tmp_path / "flight.json")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=180,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "CLEAN", out.stdout


# The modules of the router slice.
ROUTER_SLICE = (
    "types", "envcheck", "state_machine.commitment", "runtime.router", "testing.cluster",
    "testing.vopr", "cli",
)


def test_router_slice_runs_without_jax(tmp_path):
    """A fresh interpreter imports the slice's modules, runs a short
    ShardedVopr (the router core over two shard clusters) and the CLI's
    `router` usage and flag check, and serves a TCP RouterServer for one
    poll: neither JAX nor the JAX package is loaded."""
    code = (
        "import importlib, io, sys, contextlib\n"
        f"for m in {ROUTER_SLICE!r}: importlib.import_module('tigerbeetle_tpu_torch.' + m)\n"
        "from tigerbeetle_tpu_torch import cli\n"
        "from tigerbeetle_tpu_torch.runtime.router import RouterServer\n"
        "from tigerbeetle_tpu_torch.testing.vopr import ShardedVopr\n"
        "v = ShardedVopr(11, requests=6, packet_loss=0.0, crash_probability=0.0,\n"
        "                fsync_crash_probability=0.0, partition_probability=0.0,\n"
        "                coordinator_kill_probability=0.0)\n"
        "v.run()\n"
        "assert 'router     --listen=' in cli.USAGE\n"
        "err = io.StringIO()\n"
        "with contextlib.redirect_stderr(err):\n"
        "    try:\n"
        "        cli.main(['router', '--listen=127.0.0.1:0'])\n"
        "    except SystemExit as exc:\n"
        "        assert exc.code != 0\n"
        "assert '--shards' in err.getvalue(), err.getvalue()\n"
        "r = RouterServer('127.0.0.1:0', ['127.0.0.1:1'], cluster=3, recover=False)\n"
        "r.poll_once(1)\n"
        "r.close()\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', 'tigerbeetle_tpu')\n"
        "             or m.startswith(('jax.', 'jaxlib.', 'tigerbeetle_tpu.')))\n"
        "assert not bad, bad\n"
        "print('CLEAN')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env["TB_FLIGHT_PATH"] = str(tmp_path / "flight.json")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=180,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "CLEAN", out.stdout


def test_cli_usage_and_router_run_without_a_card():
    """`python -m tigerbeetle_tpu_torch` prints the usage, `router`
    among its commands, and `router` without --shards exits non-zero
    naming the flag; neither needs a card."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env["CUDA_VISIBLE_DEVICES"] = ""
    usage = subprocess.run(
        [sys.executable, "-m", "tigerbeetle_tpu_torch"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert usage.returncode == 1 and "\n  router     --listen=" in usage.stdout, usage.stdout
    bad = subprocess.run(
        [sys.executable, "-m", "tigerbeetle_tpu_torch", "router", "--listen=127.0.0.1:0"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert bad.returncode != 0 and "--shards" in bad.stderr, bad.stderr


# The modules of the follower and tbcheck slice.
FOLLOWER_SLICE = (
    "envcheck", "runtime.follower", "testing.cluster", "testing.vopr", "analysis",
    "analysis.core", "analysis.imports", "analysis.layout", "analysis.rules", "cli",
)


def test_follower_and_tbcheck_slice_run_without_jax(tmp_path):
    """A fresh interpreter imports the slice's modules, runs one pinned
    FollowerVopr seed, serves one poll of a TCP FollowerServer over an
    empty AOF, lints one module of the port, and checks the CLI's
    `follower` and `lint` usage: neither JAX nor the JAX package is
    loaded."""
    code = (
        "import importlib, io, sys, contextlib, time\n"
        f"for m in {FOLLOWER_SLICE!r}: importlib.import_module('tigerbeetle_tpu_torch.' + m)\n"
        "from tigerbeetle_tpu_torch import cli\n"
        "from tigerbeetle_tpu_torch import constants as cfg\n"
        "from tigerbeetle_tpu_torch.analysis import run_lint\n"
        "from tigerbeetle_tpu_torch.runtime.follower import FollowerServer\n"
        "from tigerbeetle_tpu_torch.state_machine import CpuStateMachine\n"
        "from tigerbeetle_tpu_torch.testing.vopr import FollowerVopr\n"
        "v = FollowerVopr(2)\n"
        "v.run()\n"
        "assert v.reads_served > 0 and not v.follower.core.poisoned\n"
        f"aof = {str(tmp_path / 'r0.aof')!r}\n"
        "open(aof, 'wb').close()\n"
        "f = FollowerServer('127.0.0.1:0', aof_path=aof, upstream_address='127.0.0.1:1',\n"
        "                   cluster=3, state_machine=CpuStateMachine(cfg.TEST_MIN),\n"
        "                   clock_ns=time.monotonic_ns)\n"
        "f.poll_once(1)\n"
        "f.close()\n"
        "r = run_lint(files=[sys.modules['tigerbeetle_tpu_torch.runtime.follower'].__file__])\n"
        "assert r.findings == [] and r.checked_files == 1, r.findings\n"
        "assert 'follower   --listen=' in cli.USAGE and 'lint       [--json]' in cli.USAGE\n"
        "err = io.StringIO()\n"
        "with contextlib.redirect_stderr(err):\n"
        "    try:\n"
        "        cli.main(['follower', '--listen=127.0.0.1:0'])\n"
        "    except SystemExit as exc:\n"
        "        assert exc.code != 0\n"
        "assert '--aof' in err.getvalue(), err.getvalue()\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', 'tigerbeetle_tpu')\n"
        "             or m.startswith(('jax.', 'jaxlib.', 'tigerbeetle_tpu.')))\n"
        "assert not bad, bad\n"
        "print('CLEAN')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env["TB_FLIGHT_PATH"] = str(tmp_path / "flight.json")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=180,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "CLEAN", out.stdout


# The guard-band check and the H100 link probes.
CHECK_SLICE = ("tools.memsafe",) + tuple(
    f"experiments.{name}" for name in (
        "common", "lat_probe", "xfer_probe", "pipe_probe", "notify_probe", "steady_probe",
        "h2d_probe", "nodonate_probe", "variant_probe", "d2h_probe", "pull_probe",
        "burst_probe", "kernprof_probe", "staged_probe", "ablate_probe", "xprof_probe",
        "tpu_compile_check", "kernel_smoke"))


def test_memsafe_and_link_probes_load_nothing_of_jax():
    """A fresh interpreter imports tools/memsafe.py and every link probe,
    runs memsafe's K4 row and kernel_smoke on the CPU: neither JAX nor
    the JAX package is loaded."""
    code = (
        "import importlib, sys, torch\n"
        f"for m in {CHECK_SLICE!r}: importlib.import_module('tigerbeetle_tpu_torch.' + m)\n"
        "from tigerbeetle_tpu_torch.tools import memsafe\n"
        "from tigerbeetle_tpu_torch.experiments import kernel_smoke\n"
        "row = next(r for r in memsafe.rows() if r.name == 'apply_deltas')\n"
        "assert memsafe.check_row(row, 'cpu', repeats=1, quick=True).findings == []\n"
        "kernel_smoke.run(torch.device('cpu'))\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', 'tigerbeetle_tpu')\n"
        "             or m.startswith(('jax.', 'jaxlib.', 'tigerbeetle_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"

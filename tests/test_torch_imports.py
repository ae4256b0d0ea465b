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
    assert paths == [str(src / host_build.MAIN)], paths
    names = {p.name for p in host_build.sources()}
    assert names == {"tb_fastpath.cpp", "tb_exact.inc", "tb_linked.inc", "tb_two_phase.inc",
                     "tb_lsm.inc"}
    for path in host_build.sources():
        for inc in re.findall(r'#include\s+"([^"]+)"', path.read_text()):
            assert "/" not in inc and (src / inc).is_file(), (path.name, inc)
    text = (PORT / "kernels" / "host_build.py").read_text()
    assert "native/" not in text.replace("build/native/", "")

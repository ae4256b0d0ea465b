"""Static import graph over the package (tbcheck reachability).

The determinism rule's scope is "code the deterministic simulation can
execute", computed from the import graph rooted at testing/cluster.py
and testing/vopr.py rather than a filename exemption list (the r16
lesson: lists rot, graphs don't).  Edges follow EVERY static import —
module-level and function-level alike — because the sim does execute
lazily-imported modules (flight recorder, chaos shims, commitment);
the result is a safe over-approximation, and genuinely process-facing
modules that land in it (the real-TCP server loop, the scrape client)
carry reasoned per-line or per-file suppressions instead of silently
escaping the rule.
"""

from __future__ import annotations

import ast
import os

PACKAGE = "tigerbeetle_tpu_torch"

#: Roots of the sim-reachable set: the deterministic cluster harness
#: and the VOPR harness.  Everything they can import is code a seeded
#: simulation may execute, and must not read wall clocks or unseeded
#: entropy.
SIM_ROOTS = (
    f"{PACKAGE}.testing.cluster",
    f"{PACKAGE}.testing.vopr",
)


def module_name(path: str, pkg_root: str) -> str:
    """Dotted module name of `path` relative to the directory that
    CONTAINS the package root (so vsr/wire.py ->
    tigerbeetle_tpu_torch.vsr.wire)."""
    rel = os.path.relpath(os.path.abspath(path),
                          os.path.dirname(os.path.abspath(pkg_root)))
    rel = rel[:-3] if rel.endswith(".py") else rel
    parts = rel.split(os.sep)
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _resolve_from(node: ast.ImportFrom, importer: str,
                  is_pkg: bool) -> str | None:
    """Absolute dotted module an ImportFrom names (None when the
    import is relative past the package top).  `is_pkg`: the importer
    is an __init__.py, whose dotted name already IS its package (one
    relative level strips nothing from it)."""
    if node.level == 0:
        return node.module
    base = importer.split(".")
    # one level strips the module's own name; further levels strip
    # parents (an __init__ importer already IS its package).
    if not is_pkg:
        base = base[:-1]
    drop = node.level - 1
    if drop >= len(base):
        return None
    if drop:
        base = base[:-drop]
    return ".".join(base + ([node.module] if node.module else []))


def build_graph(files: dict[str, ast.Module], pkg_root: str,
                ) -> dict[str, set[str]]:
    """files: path -> parsed module.  Returns module -> set(imported
    modules), edges restricted to modules inside the package."""
    known = {module_name(p, pkg_root) for p in files}
    graph: dict[str, set[str]] = {m: set() for m in known}

    def add(importer: str, target: str | None) -> None:
        if not target or not target.startswith(PACKAGE):
            return
        # `from pkg.mod import Symbol`: the target is the module if it
        # exists, else the containing package (whose __init__ runs).
        while target and target not in known:
            target = target.rpartition(".")[0]
        if target and target != importer:
            graph[importer].add(target)

    for path, tree in files.items():
        importer = module_name(path, pkg_root)
        is_pkg = os.path.basename(path) == "__init__.py"
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    add(importer, alias.name)
            elif isinstance(node, ast.ImportFrom):
                base = _resolve_from(node, importer, is_pkg)
                if base is None:
                    continue
                add(importer, base)
                for alias in node.names:
                    add(importer, f"{base}.{alias.name}")
    return graph


def reachable(graph: dict[str, set[str]], roots=SIM_ROOTS) -> set[str]:
    """Transitive closure from `roots` (roots included when present)."""
    seen: set[str] = set()
    stack = [r for r in roots if r in graph]
    while stack:
        mod = stack.pop()
        if mod in seen:
            continue
        seen.add(mod)
        stack.extend(graph.get(mod, ()))
        # importing pkg.sub implies pkg.__init__ ran too
        parent = mod.rpartition(".")[0]
        if parent and parent in graph and parent not in seen:
            stack.append(parent)
    return seen

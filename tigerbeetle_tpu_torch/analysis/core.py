"""tbcheck core: AST lint framework for the repo's invariants.

The reference enforces its contracts mechanically (src/tidy.zig bans
patterns repo-wide); tbcheck is our equivalent grown past regexes: a
per-rule AST visitor pass over the whole package with import-alias
resolution (a ``from os import environ as E`` cannot walk past a rule),
reasoned per-line / per-file suppressions, and machine-readable JSON
output.  Wired as ``python -m tigerbeetle_tpu_torch lint`` and as a tier-1
test (tests/test_tbcheck.py) that asserts zero findings.

Suppression grammar (every form REQUIRES a reason string, and unused
suppressions are themselves findings so they cannot rot):

    x = time.monotonic()  # tbcheck: allow(determinism): <why>
    # tbcheck: allow(determinism): <why>        <- covers the NEXT line
    # tbcheck: allow-file(no-print): <why>      <- covers the whole file
"""
# tbcheck: allow-file(no-print): main() IS the lint CLI — findings and
# the summary line go to stdout by contract.

from __future__ import annotations

import ast
import dataclasses
import io
import json
import os
import re
import tokenize

_ALLOW_RE = re.compile(
    r"#\s*tbcheck:\s*(allow|allow-file)\(([a-z0-9_,\s-]*)\)"
    r"(?::\s*(\S.*))?"
)


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str  # repo-relative
    line: int
    message: str

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


class _Allow:
    __slots__ = ("rules", "reason", "line", "file_wide", "used_rules")

    def __init__(self, rules, reason, line, file_wide):
        self.rules = rules
        self.reason = reason
        self.line = line
        self.file_wide = file_wide
        # Used-ness is PER RULE: a multi-rule allow whose rules don't
        # all still fire has stale halves, and stale halves rot.
        self.used_rules: set = set()


class AliasResolver(ast.NodeVisitor):
    """Canonical dotted names for imported bindings, module-wide.

    ``import time as _time`` makes ``_time.monotonic`` resolve to
    ``time.monotonic``; ``from os import environ as E`` makes
    ``E.get`` resolve to ``os.environ.get``.  Function-level imports
    are included (the module executes them too); shadowing by
    assignment is not tracked — rules treat resolution as "what this
    name most plausibly denotes", which is the right polarity for a
    linter (prefer a spurious finding + reasoned allow over a silent
    escape).
    """

    def __init__(self, tree: ast.Module) -> None:
        self.aliases: dict[str, str] = {}
        self.visit(tree)

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            name = alias.asname or alias.name.split(".")[0]
            target = alias.name if alias.asname else alias.name.split(".")[0]
            self.aliases[name] = target

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.level or not node.module:
            return  # package-relative: never stdlib time/os/random
        for alias in node.names:
            name = alias.asname or alias.name
            self.aliases[name] = f"{node.module}.{alias.name}"

    def resolve(self, node: ast.AST) -> str | None:
        """Dotted canonical path of a Name/Attribute chain, or None."""
        parts: list[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        base = self.aliases.get(node.id, node.id)
        return ".".join([base] + list(reversed(parts)))


class SourceFile:
    """One parsed module: source, AST, alias map, allow-comments."""

    def __init__(self, path: str, repo_root: str, text: str | None = None):
        self.path = os.path.abspath(path)
        self.rel = os.path.relpath(self.path, repo_root)
        if text is None:
            with open(self.path, encoding="utf-8") as fh:
                text = fh.read()
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=self.rel)
        self.aliases = AliasResolver(self.tree)
        self.allows: dict[int, list[_Allow]] = {}  # line -> allows
        self.file_allows: dict[str, _Allow] = {}  # rule -> allow
        self.bad_allows: list[Finding] = []       # malformed suppressions
        self._collect_allows()

    def _collect_allows(self) -> None:
        try:
            tokens = list(tokenize.generate_tokens(
                io.StringIO(self.text).readline
            ))
        except tokenize.TokenError:
            tokens = []
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _ALLOW_RE.search(tok.string)
            if m is None:
                if "tbcheck:" in tok.string:
                    self.bad_allows.append(Finding(
                        "suppression", self.rel, tok.start[0],
                        "unparseable tbcheck directive "
                        "(expected `tbcheck: allow(<rule>): <reason>`)",
                    ))
                continue
            kind, rules_raw, reason = m.group(1), m.group(2), m.group(3)
            rules = tuple(
                r.strip() for r in rules_raw.split(",") if r.strip()
            )
            line = tok.start[0]
            if not rules or not (reason or "").strip():
                self.bad_allows.append(Finding(
                    "suppression", self.rel, line,
                    "suppression without a rule id and reason string "
                    "(`tbcheck: allow(<rule>): <reason>`)",
                ))
                continue
            allow = _Allow(rules, reason.strip(), line, kind == "allow-file")
            if allow.file_wide:
                for r in rules:
                    self.file_allows[r] = allow
            else:
                # A standalone comment covers the next non-comment,
                # non-blank line (so a multi-line reason block works,
                # and stacked allows for different rules merge); a
                # trailing comment covers its own line.
                standalone = self.lines[line - 1].lstrip().startswith("#")
                target = line
                if standalone:
                    target = line + 1
                    while target <= len(self.lines) and (
                        not self.lines[target - 1].strip()
                        or self.lines[target - 1].lstrip().startswith("#")
                    ):
                        target += 1
                self.allows.setdefault(target, []).append(allow)

    def suppressed(self, rule: str, line: int) -> bool:
        allow = self.file_allows.get(rule)
        if allow is not None:
            allow.used_rules.add(rule)
            return True
        for allow in self.allows.get(line, ()):
            if rule in allow.rules:
                allow.used_rules.add(rule)
                return True
        return False

    def unused_allow_findings(self, active_rules: set[str],
                              ) -> list[Finding]:
        """Stale suppressions — per rule id, so the dead half of an
        `allow-file(a, b)` is reported even while the live half still
        earns its keep.  Only rules that actually ran count (a
        single-rule invocation must not call another rule's allows
        stale)."""
        out = []
        seen = set()
        line_allows = [a for allows in self.allows.values()
                       for a in allows]
        for allow in line_allows + list(self.file_allows.values()):
            if id(allow) in seen:
                continue
            seen.add(id(allow))
            stale = [r for r in allow.rules
                     if r in active_rules and r not in allow.used_rules]
            if stale:
                out.append(Finding(
                    "suppression", self.rel, allow.line,
                    "unused suppression for "
                    f"{','.join(stale)} — delete it (suppressions "
                    "must not outlive the finding they justified)",
                ))
        return out


class Context:
    """Everything rules may consult: all files, the import graph, the
    sim-reachable module set, and the package root."""

    def __init__(self, files: list[SourceFile], pkg_root: str,
                 sim_modules: set[str], repo_root: str) -> None:
        self.files = files
        self.pkg_root = pkg_root
        self.repo_root = repo_root
        self.sim_modules = sim_modules

    def is_sim_reachable(self, sf: SourceFile) -> bool:
        from tigerbeetle_tpu_torch.analysis import imports as imp

        return imp.module_name(sf.path, self.pkg_root) in self.sim_modules


class Rule:
    """Base: subclasses set `id`/`doc` and implement check()."""

    id = "base"
    doc = ""

    def check(self, sf: SourceFile, ctx: Context):
        raise NotImplementedError

    def finding(self, sf: SourceFile, node_or_line, message: str,
                ) -> Finding:
        line = (node_or_line if isinstance(node_or_line, int)
                else node_or_line.lineno)
        return Finding(self.id, sf.rel, line, message)


@dataclasses.dataclass
class LintResult:
    findings: list[Finding]
    suppressed: int
    checked_files: int
    sim_modules: set[str]

    def as_json(self) -> str:
        counts: dict[str, int] = {}
        for f in self.findings:
            counts[f.rule] = counts.get(f.rule, 0) + 1
        return json.dumps({
            "version": 1,
            "tool": "tbcheck",
            "checked_files": self.checked_files,
            "suppressed": self.suppressed,
            "counts": counts,
            "findings": [f.as_dict() for f in self.findings],
        }, indent=2, sort_keys=True)


def default_rules() -> list[Rule]:
    from tigerbeetle_tpu_torch.analysis import rules as rules_mod

    return rules_mod.all_rules()


def run_lint(pkg_root: str | None = None, *,
             files: list[str] | None = None,
             rules: list[Rule] | None = None,
             assume_sim: bool = False) -> LintResult:
    """Lint the package (or an explicit file/directory list).

    With an explicit `files` subset, the import graph — and therefore
    the determinism rule's sim-reachable set — is still computed over
    the WHOLE package: linting one file must report exactly what the
    full run reports for it (a file has the same graph position either
    way).  `assume_sim=True` instead treats every linted file as
    sim-reachable — for fixture snippets outside the package, which
    have no graph position."""
    from tigerbeetle_tpu_torch.analysis import imports as imp

    if pkg_root is None:
        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pkg_root = os.path.abspath(pkg_root)
    repo_root = os.path.dirname(pkg_root)

    def walk_py(root: str) -> list[str]:
        out = []
        for dirpath, dirs, names in os.walk(root):
            dirs[:] = [d for d in dirs if d != "__pycache__"]
            out.extend(
                os.path.join(dirpath, n) for n in sorted(names)
                if n.endswith(".py")
            )
        return sorted(out)

    pkg_files = walk_py(pkg_root)
    if files is None:
        lint_files = pkg_files
    else:
        # Directory arguments expand to their .py files.
        lint_files = []
        for p in files:
            lint_files.extend(walk_py(p) if os.path.isdir(p) else [p])

    # A file the linter cannot read or parse is a FINDING, not a
    # crash: the machine-readable surface must stay machine-readable
    # when handed a broken path (rule id "parse").
    load_errors: list[Finding] = []

    def load(path: str) -> SourceFile | None:
        rel = os.path.relpath(os.path.abspath(path), repo_root)
        try:
            return SourceFile(path, repo_root)
        except SyntaxError as exc:
            load_errors.append(Finding(
                "parse", rel, exc.lineno or 1,
                f"not parseable as Python: {exc.msg}",
            ))
        except OSError as exc:
            load_errors.append(Finding(
                "parse", rel, 1,
                f"unreadable: {exc.strerror or exc}",
            ))
        return None

    by_path = {}
    for p in lint_files:
        sf = load(p)
        if sf is not None:
            by_path[os.path.abspath(p)] = sf
    sources = list(by_path.values())
    if assume_sim:
        sim = {imp.module_name(sf.path, pkg_root) for sf in sources}
    else:
        graph_sources = []
        for p in pkg_files:
            sf = by_path.get(os.path.abspath(p)) or load(p)
            if sf is not None:
                graph_sources.append(sf)
        graph = build_graph_from_sources(graph_sources, pkg_root)
        sim = imp.reachable(graph)
    ctx = Context(sources, pkg_root, sim, repo_root)

    findings: list[Finding] = []
    suppressed = 0
    active = rules if rules is not None else default_rules()
    for rule in active:
        for sf in sources:
            for f in rule.check(sf, ctx):
                if sf.suppressed(f.rule, f.line):
                    suppressed += 1
                else:
                    findings.append(f)
    active_ids = {r.id for r in active}
    for sf in sources:
        findings.extend(sf.bad_allows)
        findings.extend(sf.unused_allow_findings(active_ids))
    findings.extend(load_errors)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return LintResult(findings, suppressed, len(sources), sim)


def build_graph_from_sources(sources: list[SourceFile], pkg_root: str):
    from tigerbeetle_tpu_torch.analysis import imports as imp

    return imp.build_graph({sf.path: sf.tree for sf in sources}, pkg_root)


def main(argv: list[str]) -> int:
    """`python -m tigerbeetle_tpu_torch lint [--json] [paths...]`."""
    import sys

    as_json = False
    paths = []
    for a in argv:
        if a == "--json":
            as_json = True
        elif a.startswith("--"):
            # Same contract as flags.py: unknown flags are fatal, not
            # silently dropped (a typo'd --json must not quietly flip
            # a CI consumer to the human-readable format).
            print(f"error: unknown lint flag {a!r}", file=sys.stderr)
            return 2
        else:
            paths.append(a)
    result = run_lint(files=paths or None)
    if as_json:
        print(result.as_json())
    else:
        for f in result.findings:
            print(str(f))
        print(
            f"tbcheck: {len(result.findings)} finding(s) across "
            f"{result.checked_files} files ({result.suppressed} "
            "suppressed with reasons)"
        )
    return 1 if result.findings else 0

"""Header-layout derivation for the wire-layout rule.

vsr/wire.py packs reserved-byte carve-outs (trace context, tenant key)
into the 256-byte header as numpy dtype fields, each annotated with
its intended byte range (``# [156, 164)``).  The rule re-derives the
REAL offsets from the dtype declaration itself — width per format
string, cumulative for list-form dtypes, explicit for dict-form — and
cross-checks every annotated range against them, so the next reserved
byte claim cannot silently collide with an existing carve-out: an
overlap, a gap, a wrong total, or a comment that lies about its bytes
is a finding, derived from wire.py, never hardcoded in the rule.
"""

from __future__ import annotations

import ast
import dataclasses
import re

_FMT_RE = re.compile(r"^[<>|=]?([uif])([0-9]+)$")
_VOID_RE = re.compile(r"^V([0-9]+)$")
_RANGE_RE = re.compile(r"\[\s*(\d+)\s*,\s*(\d+)\s*\)")


@dataclasses.dataclass
class Field:
    name: str
    offset: int
    size: int
    line: int

    @property
    def end(self) -> int:
        return self.offset + self.size


@dataclasses.dataclass
class Layout:
    fields: list[Field]
    problems: list[tuple[int, str]]  # (line, message)
    line: int  # the declaration's first line

    @property
    def total(self) -> int:
        return max((f.end for f in self.fields), default=0)

    def span_of(self, *names: str) -> tuple[int, int] | None:
        """[start, end) covered by the named fields, or None when any
        is missing."""
        picked = [f for f in self.fields if f.name in names]
        if len(picked) != len(names):
            return None
        return min(f.offset for f in picked), max(f.end for f in picked)


def _fmt_size(fmt: str) -> int | None:
    m = _FMT_RE.match(fmt)
    if m:
        return int(m.group(2))
    m = _VOID_RE.match(fmt)
    if m:
        return int(m.group(1))
    return None


def _const(node: ast.AST):
    return node.value if isinstance(node, ast.Constant) else None


def parse_dtype_layout(call: ast.Call) -> Layout | None:
    """Field layout of an ``np.dtype([...])`` / ``np.dtype({...})``
    call node, or None when the argument shape is not a dtype spec."""
    if not call.args:
        return None
    arg = call.args[0]
    problems: list[tuple[int, str]] = []
    fields: list[Field] = []
    if isinstance(arg, (ast.List, ast.Tuple)):
        at = 0
        for el in arg.elts:
            if not isinstance(el, ast.Tuple) or len(el.elts) < 2:
                problems.append((el.lineno, "unparseable dtype field"))
                continue
            name = _const(el.elts[0])
            fmt = _const(el.elts[1])
            size = _fmt_size(fmt) if isinstance(fmt, str) else None
            if not isinstance(name, str) or size is None:
                problems.append((
                    el.lineno,
                    f"dtype field {name!r}: width of format {fmt!r} "
                    "is not statically derivable",
                ))
                continue
            fields.append(Field(name, at, size, el.lineno))
            at += size
    elif isinstance(arg, ast.Dict):
        spec: dict[str, list] = {}
        for k, v in zip(arg.keys, arg.values):
            key = _const(k)
            if isinstance(key, str) and isinstance(v, (ast.List, ast.Tuple)):
                spec[key] = v.elts
        names = spec.get("names")
        formats = spec.get("formats")
        offsets = spec.get("offsets")
        if names is None or formats is None or offsets is None:
            return None
        for n, f, o in zip(names, formats, offsets):
            name, fmt, off = _const(n), _const(f), _const(o)
            size = _fmt_size(fmt) if isinstance(fmt, str) else None
            if not isinstance(name, str) or size is None or not isinstance(
                off, int
            ):
                problems.append((n.lineno, "unparseable dtype field"))
                continue
            fields.append(Field(name, off, size, n.lineno))
    else:
        return None
    return Layout(fields, problems, call.lineno)


def check_layout(layout: Layout, source_lines: list[str],
                 expected_total: int | None) -> list[tuple[int, str]]:
    """Structural checks + annotation cross-check.  Returns (line,
    message) problems."""
    problems = list(layout.problems)
    # No two carve-outs may claim the same byte.
    ordered = sorted(layout.fields, key=lambda f: (f.offset, f.end))
    for a, b in zip(ordered, ordered[1:]):
        if b.offset < a.end:
            problems.append((
                b.line,
                f"field '{b.name}' [{b.offset}, {b.end}) overlaps "
                f"'{a.name}' [{a.offset}, {a.end}) — reserved-byte "
                "carve-outs must never collide",
            ))
        elif b.offset > a.end:
            problems.append((
                b.line,
                f"gap of {b.offset - a.end} byte(s) between "
                f"'{a.name}' (ends {a.end}) and '{b.name}' (starts "
                f"{b.offset}) — the header must be fully accounted",
            ))
    if expected_total is not None and layout.total != expected_total:
        problems.append((
            layout.line,
            f"layout covers {layout.total} bytes, header is "
            f"{expected_total}",
        ))
    # Every `# [a, b)` annotation near a field line must match the
    # DERIVED span of the fields declared on that line.
    by_line: dict[int, list[Field]] = {}
    for f in layout.fields:
        by_line.setdefault(f.line, []).append(f)
    for line, fs in sorted(by_line.items()):
        text = source_lines[line - 1] if line <= len(source_lines) else ""
        m = _RANGE_RE.search(text.partition("#")[2])
        if not m:
            continue
        lo, hi = int(m.group(1)), int(m.group(2))
        real_lo = min(f.offset for f in fs)
        real_hi = max(f.end for f in fs)
        if (lo, hi) != (real_lo, real_hi):
            problems.append((
                line,
                f"annotation claims [{lo}, {hi}) but the declared "
                f"fields occupy [{real_lo}, {real_hi}) — fix the "
                "comment or the layout",
            ))
    return problems


def header_size_of(constants_source: str) -> int | None:
    """HEADER_SIZE literal from constants.py (parsed, not imported)."""
    try:
        tree = ast.parse(constants_source)
    except SyntaxError:
        return None
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "HEADER_SIZE":
                    v = _const(node.value)
                    if isinstance(v, int):
                        return v
    return None

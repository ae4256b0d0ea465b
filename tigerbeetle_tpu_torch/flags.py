"""Bespoke CLI flag parser (no argparse), mirroring the reference's
src/flags.zig: `--flag=value` syntax only, typed by a spec dict,
`fatal()` on any error.

This package's own copy of ``tigerbeetle_tpu/flags.py``.
"""
# tbcheck: allow-file(no-print): flag errors go to stderr by
# contract (reference: src/flags.zig fatal()).

from __future__ import annotations

import sys


def fatal(message: str) -> "NoReturn":  # noqa: F821
    print(f"error: {message}", file=sys.stderr)
    raise SystemExit(1)


def parse(args: list[str], spec: dict[str, object]) -> tuple[dict, list[str]]:
    """`spec`: flag name -> default (type inferred; None means required
    string; bool flags accept bare `--flag`).  Returns (flags,
    positionals)."""
    out = {k: v for k, v in spec.items()}
    required = {k for k, v in spec.items() if v is None}
    positionals: list[str] = []
    for arg in args:
        if not arg.startswith("--"):
            positionals.append(arg)
            continue
        name, eq, value = arg[2:].partition("=")
        key = name.replace("-", "_")
        if key not in spec:
            fatal(f"unknown flag --{name}")
        default = spec[key]
        if isinstance(default, bool):
            out[key] = value.lower() not in ("false", "0") if eq else True
        elif isinstance(default, int):
            if not eq:
                fatal(f"--{name} requires a value")
            try:
                out[key] = int(value, 0)
            except ValueError:
                fatal(f"--{name}: invalid integer {value!r}")
        else:
            if not eq:
                fatal(f"--{name} requires a value")
            out[key] = value
        required.discard(key)
    for key in sorted(required):
        fatal(f"--{key.replace('_', '-')} is required")
    return out, positionals

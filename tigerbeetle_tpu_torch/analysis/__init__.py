"""tbcheck: AST-level invariant linter for the determinism / money /
wire / exception / lock contracts.

Entry points:
- ``python -m tigerbeetle_tpu_torch lint [--json] [paths...]`` (cli.py)
- :func:`run_lint` — the tier-1 test surface (tests/test_tbcheck.py)
"""

from tigerbeetle_tpu_torch.analysis.core import (  # noqa: F401
    Finding,
    LintResult,
    Rule,
    SourceFile,
    main,
    run_lint,
)

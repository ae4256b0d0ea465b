"""tbcheck rules: the project's contracts, encoded once.

Each rule is an AST visitor over one module; scoping (sim-reachable
set, exempt modules) comes from the Context.  Rule ids are stable —
they are the keys suppressions name.

Catalog:
  determinism   no wall clocks / unseeded entropy in sim-reachable code
  envcheck      TB_*/BENCH_* reads must go through envcheck.py
  money         u128 money math must never touch floats or `/`
  wire-layout   header carve-outs derived + overlap/annotation checked
  broad-except  broad handlers must re-raise, classify, or be reasoned
  worker-shared attrs mutated by worker closures AND methods must be
                declared in the class's _WORKER_SHARED set
  no-print      core modules talk through logging/tracer, not stdout
"""

from __future__ import annotations

import ast
import os

from tigerbeetle_tpu_torch.analysis.core import Context, Rule, SourceFile
from tigerbeetle_tpu_torch.analysis import layout as layout_mod

# ----------------------------------------------------------------------
# determinism


#: Canonical call paths that break deterministic simulation.  perf
#: counters are deliberately absent: metrics timing is observability,
#: never fed back into state-machine decisions.
NONDETERMINISTIC = {
    "time.time": "wall clock",
    "time.time_ns": "wall clock",
    "time.monotonic": "wall clock",
    "time.monotonic_ns": "wall clock",
    "os.urandom": "kernel entropy",
    "uuid.uuid1": "wall clock + MAC",
    "uuid.uuid4": "kernel entropy",
    "secrets.token_bytes": "kernel entropy",
    "secrets.token_hex": "kernel entropy",
    "secrets.randbits": "kernel entropy",
}
#: Module-level RNG functions = the unseeded global generator.  A
#: seeded `random.Random(seed)` / `np.random.default_rng(seed)`
#: instance is the sanctioned alternative.
_GLOBAL_RNG_FNS = (
    "random", "randint", "randrange", "choice", "choices", "shuffle",
    "sample", "uniform", "getrandbits", "seed", "random_sample", "rand",
    "randn", "permutation", "bytes",
    # distribution draws (stdlib random and numpy global state alike)
    "gauss", "normalvariate", "expovariate", "betavariate",
    "triangular", "lognormvariate", "vonmisesvariate", "paretovariate",
    "weibullvariate", "gammavariate",
    "normal", "standard_normal", "exponential", "poisson", "binomial",
    "gamma", "beta", "chisquare", "integers",
)
for _fn in _GLOBAL_RNG_FNS:
    NONDETERMINISTIC[f"random.{_fn}"] = "unseeded global RNG"
    NONDETERMINISTIC[f"numpy.random.{_fn}"] = "unseeded global RNG"
del _fn


class DeterminismRule(Rule):
    id = "determinism"
    doc = ("sim-reachable modules (import graph rooted at "
           "testing/cluster.py + testing/vopr.py) must not read wall "
           "clocks or unseeded entropy")

    def check(self, sf: SourceFile, ctx: Context):
        if not ctx.is_sim_reachable(sf):
            return
        # func nodes of zero-argument calls (unseeded default_rng()).
        bare_calls = {
            id(c.func) for c in ast.walk(sf.tree)
            if isinstance(c, ast.Call) and not c.args and not c.keywords
        }
        for node in ast.walk(sf.tree):
            if not isinstance(node, (ast.Attribute, ast.Name)):
                continue
            path = sf.aliases.resolve(node)
            if path is None:
                continue
            why = NONDETERMINISTIC.get(path)
            if why is not None:
                yield self.finding(
                    sf, node,
                    f"{path} ({why}) in sim-reachable code — inject a "
                    "clock / use a seeded Generator",
                )
            elif path in ("numpy.random.default_rng", "random.Random"):
                if id(node) in bare_calls:
                    yield self.finding(
                        sf, node,
                        f"{path}() without a seed in sim-reachable "
                        "code — pass an explicit seed",
                    )


# ----------------------------------------------------------------------
# envcheck discipline


class EnvcheckRule(Rule):
    id = "envcheck"
    doc = ("TB_*/BENCH_* environment reads outside envcheck.py bypass "
           "validation and hide knobs from the envcheck surface tests")

    _EXEMPT = ("envcheck.py",)
    _PREFIXES = ("TB_", "BENCH_")

    def _knob(self, node: ast.AST) -> str | None:
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            if node.value.startswith(self._PREFIXES):
                return node.value
        return None

    def check(self, sf: SourceFile, ctx: Context):
        if os.path.basename(sf.path) in self._EXEMPT:
            return
        for node in ast.walk(sf.tree):
            knob = None
            if isinstance(node, ast.Call):
                path = sf.aliases.resolve(node.func)
                if path in ("os.getenv", "os.environ.get",
                            "os.environ.pop", "os.environ.setdefault"):
                    knob = self._knob(node.args[0]) if node.args else None
            elif isinstance(node, ast.Subscript):
                path = sf.aliases.resolve(node.value)
                if path == "os.environ":
                    knob = self._knob(node.slice)
            if knob is not None:
                yield self.finding(
                    sf, node,
                    f"raw environment read of {knob} — route it "
                    "through envcheck.py (validated, named errors)",
                )


# ----------------------------------------------------------------------
# money-path integer safety


_MONEY_TOKENS = ("amount", "debit", "credit")
# Bare `float` covers both float(x) casts and astype(float) dtype use.
_FLOAT_DTYPES = {"float", "float16", "float32", "float64", "float_",
                 "double", "half", "single"}


def _simple_units(tree: ast.AST):
    """Yield the smallest statement-ish expression units: simple
    statements whole, compound statements by their header expressions
    only (so a `for` loop body's unrelated float math is not blamed on
    a money name in the iterator)."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign,
                             ast.Return, ast.Expr, ast.Assert,
                             ast.Delete, ast.Raise)):
            yield node
        elif isinstance(node, (ast.If, ast.While)):
            yield node.test
        elif isinstance(node, ast.For):
            yield node.iter
        elif isinstance(node, ast.comprehension):
            yield node.iter
            for cond in node.ifs:
                yield cond


def _identifiers(node: ast.AST):
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            yield n.id.lower()
        elif isinstance(n, ast.Attribute):
            yield n.attr.lower()
        elif isinstance(n, ast.keyword) and n.arg:
            yield n.arg.lower()


class MoneyRule(Rule):
    id = "money"
    doc = ("expressions over amounts/debits/credits are u128 limb "
           "math: no float literals, no true division, no float "
           "dtypes — go through ops/u128.py")

    def _is_money(self, unit: ast.AST) -> bool:
        return any(
            any(tok in ident for tok in _MONEY_TOKENS)
            for ident in _identifiers(unit)
        )

    def check(self, sf: SourceFile, ctx: Context):
        for unit in _simple_units(sf.tree):
            if not self._is_money(unit):
                continue
            # Type annotations are declarations, not computation —
            # `fee_rate: float` on an AnnAssign must not be blamed on
            # the money name in its value.
            scan = ([unit.target, unit.value]
                    if isinstance(unit, ast.AnnAssign)
                    else [unit])
            for root in scan:
                if root is None:
                    continue
                for n in ast.walk(root):
                    if isinstance(n, ast.BinOp) and isinstance(
                        n.op, ast.Div
                    ):
                        yield self.finding(
                            sf, n,
                            "true division in a money expression — "
                            "u128 balances use integer/limb ops only",
                        )
                    elif isinstance(n, ast.Constant) and isinstance(
                        n.value, float
                    ):
                        yield self.finding(
                            sf, n,
                            f"float literal {n.value!r} in a money "
                            "expression — amounts are u128 integers",
                        )
                    elif isinstance(n, (ast.Attribute, ast.Name)):
                        leaf = (n.attr if isinstance(n, ast.Attribute)
                                else n.id)
                        if leaf in _FLOAT_DTYPES:
                            yield self.finding(
                                sf, n,
                                f"float type `{leaf}` in a money "
                                "expression (cast, dtype, or astype) "
                                "— amounts are u128 limb pairs",
                            )


# ----------------------------------------------------------------------
# wire layout


class WireLayoutRule(Rule):
    id = "wire-layout"
    doc = ("every byte-range carve-out of the 256-byte header is "
           "derived from the dtype declaration and checked for "
           "overlap/gaps/lying annotations")

    def _expected_total(self, ctx: Context) -> int | None:
        path = os.path.join(ctx.pkg_root, "constants.py")
        try:
            with open(path, encoding="utf-8") as fh:
                return layout_mod.header_size_of(fh.read())
        except OSError:
            return None

    def check(self, sf: SourceFile, ctx: Context):
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Assign):
                continue
            names = [t.id for t in node.targets
                     if isinstance(t, ast.Name)]
            if not any(n.endswith("HEADER_DTYPE") for n in names):
                continue
            if not isinstance(node.value, ast.Call):
                continue
            if sf.aliases.resolve(node.value.func) not in (
                "numpy.dtype", "np.dtype"
            ):
                continue
            layout = layout_mod.parse_dtype_layout(node.value)
            if layout is None:
                yield self.finding(
                    sf, node,
                    "HEADER_DTYPE declaration is not statically "
                    "parseable — tbcheck cannot prove the carve-outs",
                )
                continue
            for line, msg in layout_mod.check_layout(
                layout, sf.lines, self._expected_total(ctx)
            ):
                yield self.finding(sf, line, msg)


# ----------------------------------------------------------------------
# exception discipline


class BroadExceptRule(Rule):
    id = "broad-except"
    doc = ("bare/broad `except` must re-raise, funnel into "
           "classify_link_error, or carry an allow-comment naming why")

    _BROAD = {"Exception", "BaseException"}

    def _is_broad(self, handler: ast.ExceptHandler) -> bool:
        t = handler.type
        if t is None:
            return True
        types = t.elts if isinstance(t, ast.Tuple) else [t]
        return any(
            isinstance(x, ast.Name) and x.id in self._BROAD
            for x in types
        )

    def _handler_escapes(self, handler: ast.ExceptHandler) -> bool:
        """True when the handler re-raises or classifies (a nested
        function body does not count — it runs later, if ever)."""
        stack = list(handler.body)
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                continue
            if isinstance(n, ast.Raise):
                return True
            if isinstance(n, ast.Call):
                fn = n.func
                leaf = (fn.attr if isinstance(fn, ast.Attribute)
                        else fn.id if isinstance(fn, ast.Name) else "")
                if leaf == "classify_link_error":
                    return True
            stack.extend(ast.iter_child_nodes(n))
        return False

    def check(self, sf: SourceFile, ctx: Context):
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not self._is_broad(node):
                continue
            if self._handler_escapes(node):
                continue
            what = ("bare except" if node.type is None
                    else "broad except")
            yield self.finding(
                sf, node,
                f"{what} swallows typed errors (DeviceLostError "
                "classification, EnvVarError) — re-raise, route "
                "through classify_link_error, or annotate why",
            )


# ----------------------------------------------------------------------
# worker-shared (lock discipline)


class _AttrWrites(ast.NodeVisitor):
    """Attribute names of `self` mutated in a function body: stores,
    aug-assigns, deletes, item-stores (self.x[k] = v), and calls to
    known mutating container methods (self.x.append(...))."""

    _MUTATORS = {"append", "pop", "clear", "add", "remove", "update",
                 "extend", "put", "setdefault", "discard", "insert"}

    def __init__(self):
        self.writes: set[str] = set()
        self.submits: list[ast.Call] = []
        self.self_calls: set[str] = set()

    def _self_attr(self, node: ast.AST) -> str | None:
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            return node.attr
        return None

    def visit_Attribute(self, node: ast.Attribute) -> None:
        name = self._self_attr(node)
        if name is not None and isinstance(
            node.ctx, (ast.Store, ast.Del)
        ):
            self.writes.add(name)
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        if isinstance(node.ctx, (ast.Store, ast.Del)):
            name = self._self_attr(node.value)
            if name is not None:
                self.writes.add(name)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        if isinstance(fn, ast.Attribute):
            if fn.attr == "submit":
                self.submits.append(node)
            target = self._self_attr(fn.value)
            if target is not None and fn.attr in self._MUTATORS:
                self.writes.add(target)
            name = self._self_attr(fn)
            if name is not None:
                self.self_calls.add(name)
        self.generic_visit(node)


class WorkerSharedRule(Rule):
    id = "worker-shared"
    doc = ("attributes mutated both from a SerialWorker-submitted "
           "closure and from instance methods must be declared in the "
           "class's _WORKER_SHARED set — a cheap static write-write "
           "race detector for the background-worker seams")

    def _declared(self, cls: ast.ClassDef) -> set[str] | None:
        for stmt in cls.body:
            if isinstance(stmt, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "_WORKER_SHARED"
                for t in stmt.targets
            ):
                v = stmt.value
                elts = []
                if isinstance(v, (ast.Set, ast.Tuple, ast.List)):
                    elts = v.elts
                elif isinstance(v, ast.Call) and isinstance(
                    v.func, ast.Name
                ) and v.func.id == "frozenset" and v.args:
                    inner = v.args[0]
                    if isinstance(inner, (ast.Set, ast.Tuple, ast.List)):
                        elts = inner.elts
                return {
                    e.value for e in elts
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, str)
                }
        return None

    def check(self, sf: SourceFile, ctx: Context):
        # Cheap pre-filter: a class can hit this rule by constructing
        # a SerialWorker OR by calling .submit() on an injected one —
        # an injected worker must not walk past the tripwire.
        if "SerialWorker" not in sf.text and ".submit(" not in sf.text:
            return
        for cls in ast.walk(sf.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            yield from self._check_class(sf, cls)

    def _check_class(self, sf: SourceFile, cls: ast.ClassDef):
        methods = {
            m.name: m for m in cls.body
            if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        analyses = {}
        for name, m in methods.items():
            a = _AttrWrites()
            a.visit(m)
            analyses[name] = a
        constructs_worker = any(
            isinstance(n, ast.Call) and (
                (isinstance(n.func, ast.Name)
                 and n.func.id == "SerialWorker")
                or (isinstance(n.func, ast.Attribute)
                    and n.func.attr == "SerialWorker")
            )
            for n in ast.walk(cls)
        )
        submits_anything = any(a.submits for a in analyses.values())
        if not constructs_worker and not submits_anything:
            return

        # Worker entry points: self-method references (or local defs /
        # lambdas, analyzed inline) passed as a submit() first arg.
        entry_methods: set[str] = set()
        inline_writes: set[str] = set()
        for name, a in analyses.items():
            for call in a.submits:
                if not call.args:
                    continue
                fn = call.args[0]
                if (isinstance(fn, ast.Attribute)
                        and isinstance(fn.value, ast.Name)
                        and fn.value.id == "self"
                        and fn.attr in methods):
                    entry_methods.add(fn.attr)
                elif isinstance(fn, ast.Lambda):
                    w = _AttrWrites()
                    w.visit(fn)
                    inline_writes |= w.writes
                elif isinstance(fn, ast.Name):
                    # a local `def job(): ...` in the same method
                    for d in ast.walk(methods[name]):
                        if isinstance(d, ast.FunctionDef) and (
                            d.name == fn.id
                        ):
                            w = _AttrWrites()
                            w.visit(d)
                            inline_writes |= w.writes
        if not entry_methods and not inline_writes:
            return

        # Transitive closure over self-method calls: everything a
        # submitted method can reach runs on the worker thread.
        worker_set: set[str] = set()
        stack = list(entry_methods)
        while stack:
            m = stack.pop()
            if m in worker_set or m not in analyses:
                continue
            worker_set.add(m)
            stack.extend(analyses[m].self_calls)

        worker_writes = set(inline_writes)
        for m in worker_set:
            worker_writes |= analyses[m].writes
        method_writes: set[str] = set()
        for name, a in analyses.items():
            if name in worker_set or name == "__init__":
                continue
            method_writes |= a.writes

        shared = sorted(worker_writes & method_writes)
        declared = self._declared(cls)
        for attr in shared:
            if declared is None or attr not in declared:
                yield self.finding(
                    sf, cls,
                    f"class {cls.name}: attribute '{attr}' is mutated "
                    "both from a SerialWorker closure and from "
                    "instance methods but is not declared in "
                    "_WORKER_SHARED — declare it (and say what "
                    "serializes the writes) or stop sharing it",
                )


# ----------------------------------------------------------------------
# no-print


class NoPrintRule(Rule):
    id = "no-print"
    doc = ("core modules must not print; stdout belongs to CLIs and "
           "benches (file-level allows with reasons), everything else "
           "talks through logging or the tracer")

    def check(self, sf: SourceFile, ctx: Context):
        for node in ast.walk(sf.tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "print"
                    and sf.aliases.resolve(node.func) == "print"):
                yield self.finding(
                    sf, node,
                    "print() in a core module — use logging or the "
                    "tracer (CLIs carry a file-level allow)",
                )


def all_rules() -> list[Rule]:
    return [
        DeterminismRule(),
        EnvcheckRule(),
        MoneyRule(),
        WireLayoutRule(),
        BroadExceptRule(),
        WorkerSharedRule(),
        NoPrintRule(),
    ]

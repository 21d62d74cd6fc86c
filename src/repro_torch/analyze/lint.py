"""AST linter for the repo's own written contracts.

Generic linters (ruff's pyflakes/bugbear gate) can't see repo-specific
invariants; these rules encode the ones that have actually bitten:

======  ============================================================
rule    contract
======  ============================================================
L001    ``Event.name`` is display-only (``compare=False`` in
        ``events.py``): no code may compare, test membership on, or
        branch on an event's ``.name`` — structural identity is the
        paper's unique-event dedup, and name-keyed logic silently
        breaks it
L002    cache-key completeness: a frozen spec dataclass that defines
        ``to_dict`` must serialize EVERY field — either via
        ``dataclasses.asdict`` or a dict whose keys cover all fields.
        A field that exists but never reaches the serde path is the
        exact bug class that once let two differing specs share one
        store address
L003    no iteration over unordered containers feeding ordered
        construction in ``repro/core`` and ``repro/store`` (and the
        port's ``repro_torch/core`` and ``repro_torch/store``): a bare
        ``for x in set(...)`` (or a set literal / set union) leaks
        hash order into whatever is built from it — wrap in
        ``sorted(...)``. ``dict.values()``/``.keys()`` are flagged
        only when fed straight into tuple/array constructors
L004    determinism of build/compile paths (``repro/core`` minus the
        measuring ``profiler.py``, and ``repro/store``; the same paths
        of ``repro_torch``): no wall-clock
        reads (``time.time``/``perf_counter``/``monotonic``) and no
        unseeded RNG (``np.random.<draw>``, zero-argument
        ``default_rng()``/``RandomState()``) — builds must be pure
        functions of their inputs or content addresses lie
======  ============================================================

Pure stdlib ``ast`` — no third-party parser, works on the numpy-only
CI image. Entry points: :func:`lint_paths` (files/dirs),
:func:`lint_source` (one source string — the mutation suite's hook).
"""
from __future__ import annotations

import ast
import os
from typing import List, Optional, Sequence

from repro_torch.analyze.findings import Finding

#: variable names treated as "an Event" for L001. The rule is
#: heuristic by necessity (no type inference); these cover the repo's
#: idiom for event-typed locals and comprehension targets.
EVENT_VARS = frozenset({"e", "ev", "evt", "event"})

#: np.random draws that consume global (unseeded) RNG state.
UNSEEDED_DRAWS = frozenset({
    "rand", "randn", "random", "random_sample", "randint", "choice",
    "shuffle", "permutation", "standard_normal", "normal", "uniform",
    "seed",
})

_WALLCLOCK = frozenset({"time", "perf_counter", "monotonic",
                        "perf_counter_ns", "time_ns", "monotonic_ns"})

#: constructors whose argument order is semantically load-bearing.
_ORDERED_CTORS = frozenset({"tuple", "asarray", "array", "stack",
                            "concatenate", "fromiter"})


def _norm(path: str) -> str:
    return path.replace(os.sep, "/")


#: L003/L004 scope: the core and store of the reference package and of
#: this port (``repro_torch/core/`` does not contain ``repro/core/``)
_SCOPED = ("repro/core/", "repro/store/", "repro_torch/core/",
           "repro_torch/store/")
_MEASURING = ("repro/core/profiler.py", "repro_torch/core/profiler.py")


def _in_core_or_store(path: str) -> bool:
    p = _norm(path)
    return any(s in p for s in _SCOPED)


def _is_build_path(path: str) -> bool:
    """L004 scope: build/compile paths — core + store, except the
    profiler (whose entire job is reading real clocks)."""
    p = _norm(path)
    if p.endswith(_MEASURING):
        return False
    return _in_core_or_store(p)


def _attr_chain(node: ast.AST) -> Optional[str]:
    """'a.b.c' for nested Name/Attribute nodes, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_event_name_attr(node: ast.AST) -> bool:
    """``<event>.name`` where <event> is an event-typed expression."""
    if not (isinstance(node, ast.Attribute) and node.attr == "name"):
        return False
    val = node.value
    if isinstance(val, ast.Name) and val.id.lower() in EVENT_VARS:
        return True
    if isinstance(val, ast.Call):
        fn = _attr_chain(val.func)
        return fn is not None and fn.split(".")[-1] == "Event"
    return False


def _is_set_expr(node: ast.AST) -> bool:
    """Expressions whose iteration order is hash-dependent."""
    if isinstance(node, ast.Set) or isinstance(node, ast.SetComp):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in ("set", "frozenset"):
        return True
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)):
        return _is_set_expr(node.left) or _is_set_expr(node.right)
    return False


def _is_dict_view(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call) and not node.args
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in ("values", "keys"))


class _Linter(ast.NodeVisitor):
    def __init__(self, path: str):
        self.path = path
        self.findings: List[Finding] = []
        self._core_store = _in_core_or_store(path)
        self._build_path = _is_build_path(path)

    def _add(self, rule: str, node: ast.AST, message: str) -> None:
        line = getattr(node, "lineno", 0)
        self.findings.append(Finding(
            rule=rule, message=message,
            where=f"{self.path}:{line}"))

    # ---- L001: Event.name is display-only ----

    def visit_Compare(self, node: ast.Compare) -> None:
        for operand in [node.left, *node.comparators]:
            if _is_event_name_attr(operand):
                self._add("L001", node,
                          "comparison on Event.name — name is "
                          "display-only (compare=False); key on the "
                          "structural fields (kind/op/shape/scope)")
                break
        self.generic_visit(node)

    def visit_If(self, node: ast.If) -> None:
        if _is_event_name_attr(node.test):
            self._add("L001", node,
                      "branch on Event.name — name is display-only")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        # L001: e.name.startswith(...) / endswith(...) — comparisons
        # in method form
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in ("startswith", "endswith") \
                and _is_event_name_attr(node.func.value):
            self._add("L001", node,
                      f"Event.name.{node.func.attr}() — name is "
                      f"display-only; match on structural fields")
        # L003: ordered constructor over a raw set / dict view
        if self._core_store and isinstance(node.func, (ast.Name,
                                                       ast.Attribute)):
            fn = (node.func.id if isinstance(node.func, ast.Name)
                  else node.func.attr)
            if fn in _ORDERED_CTORS and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.GeneratorExp):
                    arg = arg.generators[0].iter
                if _is_set_expr(arg):
                    self._add("L003", node,
                              f"{fn}() over an unordered set "
                              f"expression — wrap in sorted(...)")
                elif _is_dict_view(arg):
                    self._add("L003", node,
                              f"{fn}() over a dict view — iteration "
                              f"order is insertion order, not a "
                              f"stable key order; wrap in sorted(...)")
        # L004: wall-clock / unseeded RNG in build paths
        if self._build_path:
            self._check_determinism(node)
        self.generic_visit(node)

    def _check_determinism(self, node: ast.Call) -> None:
        chain = _attr_chain(node.func)
        if chain is None:
            return
        parts = chain.split(".")
        if parts[0] == "time" and len(parts) == 2 \
                and parts[1] in _WALLCLOCK:
            self._add("L004", node,
                      f"{chain}() in a build/compile path — builds "
                      f"must be pure functions of their inputs")
            return
        if len(parts) >= 2 and parts[-2] == "random" \
                and parts[0] in ("np", "numpy", "random"):
            fn = parts[-1]
            if fn in UNSEEDED_DRAWS:
                self._add("L004", node,
                          f"{chain}() draws from global RNG state in "
                          f"a build/compile path")
            elif fn in ("default_rng", "RandomState") and not node.args:
                self._add("L004", node,
                          f"{chain}() without a seed in a "
                          f"build/compile path")

    # ---- L003: bare iteration over sets ----

    def _check_iter(self, it: ast.AST) -> None:
        if self._core_store and _is_set_expr(it):
            self._add("L003", it,
                      "iteration over an unordered set expression — "
                      "wrap in sorted(...) so downstream construction "
                      "is deterministic")

    def visit_For(self, node: ast.For) -> None:
        self._check_iter(node.iter)
        self.generic_visit(node)

    def _visit_comp(self, node) -> None:
        for gen in node.generators:
            self._check_iter(gen.iter)
        self.generic_visit(node)

    visit_ListComp = _visit_comp
    visit_DictComp = _visit_comp
    visit_GeneratorExp = _visit_comp

    def visit_SetComp(self, node: ast.SetComp) -> None:
        # building a set FROM a set is order-free by construction
        self.generic_visit(node)

    # ---- L002: cache-key completeness ----

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        if _is_frozen_dataclass(node):
            self._check_spec_class(node)
        self.generic_visit(node)

    def _check_spec_class(self, node: ast.ClassDef) -> None:
        fields = []
        for stmt in node.body:
            if isinstance(stmt, ast.AnnAssign) \
                    and isinstance(stmt.target, ast.Name) \
                    and not stmt.target.id.startswith("_") \
                    and not _is_classvar(stmt.annotation):
                fields.append(stmt.target.id)
        to_dict = next(
            (s for s in node.body
             if isinstance(s, ast.FunctionDef) and s.name == "to_dict"),
            None)
        if to_dict is None or not fields:
            return
        uses_asdict = any(
            isinstance(n, ast.Call)
            and (_attr_chain(n.func) or "").split(".")[-1] == "asdict"
            for n in ast.walk(to_dict))
        if uses_asdict:
            return          # asdict covers every field by construction
        keys = set()
        literal_seen = False
        for n in ast.walk(to_dict):
            if isinstance(n, ast.Dict):
                literal_seen = True
                for k in n.keys:
                    if isinstance(k, ast.Constant) \
                            and isinstance(k.value, str):
                        keys.add(k.value)
            elif isinstance(n, ast.Subscript) \
                    and isinstance(n.slice, ast.Constant) \
                    and isinstance(n.slice.value, str):
                keys.add(n.slice.value)
        if not literal_seen:
            return          # built some other way — out of scope
        missing = sorted(set(fields) - keys)
        if missing:
            self._add("L002", to_dict,
                      f"{node.name}.to_dict() omits field(s) "
                      f"{missing} — every compared field of a frozen "
                      f"spec must reach the serde/cache-key path")


def _is_frozen_dataclass(node: ast.ClassDef) -> bool:
    for dec in node.decorator_list:
        if not isinstance(dec, ast.Call):
            continue
        fn = _attr_chain(dec.func) or ""
        if fn.split(".")[-1] != "dataclass":
            continue
        for kw in dec.keywords:
            if kw.arg == "frozen" and isinstance(kw.value, ast.Constant) \
                    and kw.value.value is True:
                return True
    return False


def _is_classvar(annotation: ast.AST) -> bool:
    if isinstance(annotation, ast.Subscript):
        annotation = annotation.value
    chain = _attr_chain(annotation) or ""
    return chain.split(".")[-1] == "ClassVar"


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------

def lint_source(source: str, path: str = "<string>") -> List[Finding]:
    """Lint one source string as if it lived at ``path`` (the path
    decides L003/L004 scoping)."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as exc:
        return [Finding(rule="L000", message=f"syntax error: {exc.msg}",
                        where=f"{path}:{exc.lineno or 0}")]
    linter = _Linter(path)
    linter.visit(tree)
    return sorted(linter.findings, key=lambda f: f.where)


def lint_file(path: str) -> List[Finding]:
    with open(path, encoding="utf-8") as fh:
        return lint_source(fh.read(), path)


def lint_paths(paths: Sequence[str]) -> List[Finding]:
    """Lint files and/or directory trees (``.py`` files, recursively,
    skipping ``__pycache__``)."""
    findings: List[Finding] = []
    for root in paths:
        if os.path.isfile(root):
            findings.extend(lint_file(root))
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = sorted(d for d in dirnames
                                 if d != "__pycache__")
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    findings.extend(lint_file(os.path.join(dirpath, fn)))
    return findings

"""Finding/severity plumbing shared by both analysis passes.

This module is deliberately import-free of :mod:`repro_torch.core` so the
engine and megabatch constructors can reach :func:`default_verify` /
:class:`GraphInvariantError` without any import cycle: the verifier
itself (:mod:`repro_torch.analyze.graph`) is imported lazily, only when a
construction actually asks to be verified.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer diagnostic.

    ``rule`` is a stable machine-checkable identifier (``Gxxx`` for
    graph-verifier rules, ``Lxxx`` for source-lint rules — the mutation
    suite asserts on these, so renames are breaking). ``where`` locates
    the finding: ``path:line`` for lint, an engine/cell label for graph
    checks.
    """
    rule: str
    message: str
    where: str = ""
    severity: str = "error"

    def __str__(self) -> str:
        loc = f" [{self.where}]" if self.where else ""
        return f"{self.rule}{loc}: {self.message}"


class GraphInvariantError(RuntimeError):
    """Raised by ``verify=``-enabled construction when the static
    verifier finds a broken invariant. Carries the full finding list —
    the message shows every finding, not just the first."""

    def __init__(self, findings: Sequence[Finding]):
        self.findings: List[Finding] = list(findings)
        lines = "\n  ".join(str(f) for f in self.findings)
        super().__init__(
            f"{len(self.findings)} graph invariant violation(s):\n"
            f"  {lines}")


#: environment switch for the construction-time verifier. Tests/CI set
#: it (``tests/conftest.py``, the CI job env); hot paths leave it unset
#: so predict/search throughput pays nothing.
VERIFY_ENV = "REPRO_VERIFY"

_TRUTHY = ("1", "true", "yes", "on")


def default_verify(flag: Optional[bool] = None) -> bool:
    """Resolve a constructor's ``verify=`` argument.

    An explicit ``True``/``False`` wins; ``None`` (the default on every
    call site) defers to the :data:`VERIFY_ENV` environment variable —
    off unless set to a truthy value.
    """
    if flag is not None:
        return flag
    return os.environ.get(VERIFY_ENV, "").strip().lower() in _TRUTHY


def raise_on_findings(findings: Sequence[Finding]) -> None:
    """Raise :class:`GraphInvariantError` iff any finding is an error."""
    errors = [f for f in findings if f.severity == "error"]
    if errors:
        raise GraphInvariantError(errors)

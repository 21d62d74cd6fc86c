"""Static analysis over DistSim's event-graph IR and sources: the port
of the reference package's ``repro.analyze`` (pure numpy and ``ast``).

Two passes (see ``python -m repro_torch.analyze --help``):

* :mod:`repro_torch.analyze.graph` — structural verifier over
  ``EngineBuild``/task graphs and compiled ``MegaBatch`` programs,
  wired into construction behind the ``verify=`` flag /
  ``REPRO_VERIFY`` env var.
* :mod:`repro_torch.analyze.lint` — AST rules for the repo's own written
  contracts (display-only ``Event.name``, cache-key completeness,
  deterministic iteration and RNG in build paths).
"""
from repro_torch.analyze.findings import (Finding, GraphInvariantError,
                                          VERIFY_ENV, default_verify,
                                          raise_on_findings)
from repro_torch.analyze.graph import (verify_build, verify_cell_memory,
                                       verify_engine, verify_megabatch,
                                       verify_perturbation)
from repro_torch.analyze.lint import lint_file, lint_paths, lint_source

__all__ = [
    "Finding", "GraphInvariantError", "VERIFY_ENV", "default_verify",
    "raise_on_findings", "verify_build", "verify_cell_memory",
    "verify_engine", "verify_megabatch", "verify_perturbation",
    "lint_file", "lint_paths", "lint_source",
]

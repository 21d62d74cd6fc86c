"""repro_torch.validate — paper-fidelity accuracy sweep (predict vs replay).

The regression backbone for DistSim's headline claim (<4% batch-time
error, <5% per-device activity error, paper §5):

    from repro_torch.validate import run_sweep, smoke_matrix
    from repro_torch.validate.report import dump, format_validation_report

    result = run_sweep(smoke_matrix(), seeds=(0, 1, 2))
    print(format_validation_report(result))
    assert result.passed

The same matrices and gates as the reference package's; ``run_sweep``
defaults to ``A40_CLUSTER``, the paper's validation cluster.
``tests/test_torch_validate.py`` holds every result field for field
against the reference's live run.
"""
from repro_torch.validate.build_cache import BuildCache, BuildCacheStats
from repro_torch.validate.degraded import (DegradedCell, DegradedCellResult,
                                           DegradedReport, degraded_matrix,
                                           format_degraded_report,
                                           run_degraded, run_degraded_cell,
                                           structural_violations)
from repro_torch.validate.metrics import (CellMetrics, aggregate,
                                          compare_batch, compare_timelines)
from repro_torch.validate.report import (dump, dumps, format_validation_report,
                                         load, load_path, save)
from repro_torch.validate.sweep import (CellResult, SweepResult, Thresholds,
                                        ValidationCell, full_matrix, run_cell,
                                        run_sweep, serving_matrix,
                                        smoke_matrix)

__all__ = [
    "BuildCache", "BuildCacheStats", "DegradedCell",
    "DegradedCellResult", "DegradedReport", "degraded_matrix",
    "format_degraded_report", "run_degraded", "run_degraded_cell",
    "structural_violations", "CellMetrics", "aggregate",
    "compare_batch", "compare_timelines", "dump", "dumps",
    "format_validation_report", "load", "load_path", "save",
    "CellResult", "SweepResult", "Thresholds", "ValidationCell",
    "full_matrix", "run_cell", "run_sweep", "serving_matrix",
    "smoke_matrix",
]

"""Per-cell conformance metrics (paper §5).

A :class:`CellMetrics` is one predict-vs-replay comparison reduced to
the paper's evaluation numbers: batch-time error (§5.2, target <4%),
per-device activity-time error (§5.3, target <5%), per-stage timestamp
error (§5.4), plus duration/utilization/bubble deltas that localize a
regression (schedule drift vs event-time drift). Multi-seed replays
aggregate field-wise (mean), with the worst seed's batch-time error
kept so a single bad draw can't hide in the average.

Two evaluation paths compute the same numbers:

* :func:`compare_timelines` — the naive oracle: materializes both
  ``Activity`` lists and matches compute events by ``(device, name)``;
* :func:`compare_batch` — array-native over a ``TimelineBatch`` pair:
  pred and replay share one engine, so matched pairs are simply the
  same ``(device, task index)`` slots and every metric reduces over
  stacked ``(S, dp, mp, tasks)`` arrays. Zero ``Activity`` objects.

``tests/test_validate_metrics.py`` holds the differential/property
harness pinning the two together.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.core.serde import dataclass_from_dict
from repro_torch.core.timeline import Timeline, TimelineBatch, error_summary


@dataclasses.dataclass(frozen=True)
class CellMetrics:
    batch_time_error: float = 0.0
    activity_error_mean: float = 0.0
    activity_error_max: float = 0.0
    stage_error_mean: float = 0.0
    stage_error_max: float = 0.0
    duration_error_mean: float = 0.0
    duration_error_max: float = 0.0
    utilization_delta_max: float = 0.0
    bubble_delta: float = 0.0
    worst_batch_time_error: float = 0.0

    def to_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, float]) -> "CellMetrics":
        return dataclass_from_dict(cls, d)


def compare_timelines(pred: Timeline, actual: Timeline) -> CellMetrics:
    """Metrics for one (prediction, replay) pair (naive oracle path:
    materializes and matches ``Activity`` lists)."""
    s = error_summary(pred, actual)
    return CellMetrics(worst_batch_time_error=s["batch_time_error"], **s)


def compare_batch(pred: TimelineBatch, actual: TimelineBatch
                  ) -> List[CellMetrics]:
    """Array-native metrics for every replay lane of ``actual`` against
    ``pred``, which must be a single zero-noise lane
    (``DistSim.simulate().batch``; enforced — a noisy or multi-lane
    prediction batch would silently be misread as replica-0 times).

    Both batches must come from the same engine (same task structure):
    the ``(device, name)`` activity matching of the naive path then
    degenerates to index alignment, and all paper §5 reductions run as
    NumPy ops over ``(S, dp, mp, tasks)`` stacks — no ``Activity`` is
    ever materialized. Equality with the naive path (to float
    tolerance; the reduction tree differs) is pinned by
    ``tests/test_validate_metrics.py``.
    """
    if len(pred) != 1 or pred.n_sim != 1:
        raise ValueError(
            f"compare_batch needs a single-lane zero-noise prediction "
            f"batch (simulate().batch), got S={len(pred)}, "
            f"n_sim={pred.n_sim}")
    S = len(actual)
    dp, mp, pp = actual.dp, actual.mp, actual.pp
    bt_p = float(pred.batch_times[0])
    bt_a = actual.batch_times                          # (S,)
    # §5.2, with timeline.batch_time_error's degenerate-oracle
    # semantics: a zero-length oracle vs a non-trivial prediction is
    # infinite error, not perfect agreement.
    norm = np.where(bt_a > 0, bt_a, 1.0)               # old `bt or 1.0`
    bte = np.where(bt_a > 0, np.abs(bt_p - bt_a) / norm,
                   0.0 if bt_p == 0.0 else np.inf)

    act_sum = np.zeros(S)
    act_max = np.zeros(S)
    stg_sum = np.zeros(S)
    stg_max = np.zeros(S)
    dur_sum = np.zeros(S)
    dur_max = np.zeros(S)
    n_dev = 0
    n_pairs = 0
    for d in range(pp):
        sp = pred.starts[d][0, 0]                      # (n_d,)
        ep = pred.ends[d][0, 0]
        n_d = sp.shape[0]
        if n_d == 0:
            continue
        sa, ea = actual.starts[d], actual.ends[d]      # (S, n_sim, n_d)
        if actual.n_sim != dp:
            sa = np.broadcast_to(sa, (S, dp, n_d))
            ea = np.broadcast_to(ea, (S, dp, n_d))
        offs = actual.offsets[:, :, d, :, None]        # (S, dp, mp, 1)
        sa_o = sa[:, :, None, :] + offs                # (S, dp, mp, n_d)
        ea_o = ea[:, :, None, :] + offs
        nrm = norm[:, None, None, None]
        # §5.3/§5.4 timestamp error per matched compute pair
        terr = 0.5 * (np.abs(sp - sa_o) + np.abs(ep - ea_o)) / nrm
        stg_sum += terr.sum(axis=(1, 2, 3))
        stg_max = np.maximum(stg_max, terr.max(axis=(1, 2, 3)))
        n_pairs += dp * mp * n_d
        dm = terr.mean(axis=3)                         # per-device means
        act_sum += dm.sum(axis=(1, 2))
        act_max = np.maximum(act_max, dm.max(axis=(1, 2)))
        n_dev += dp * mp
        # duration error uses materialized-activity semantics:
        # a.dur == (end+off) - (start+off), offsets not quite cancelling
        derr = np.abs((ep - sp) - (ea_o - sa_o)) / nrm
        ddm = derr.mean(axis=3)
        dur_sum += ddm.sum(axis=(1, 2))
        dur_max = np.maximum(dur_max, ddm.max(axis=(1, 2)))

    act_mean = act_sum / max(1, n_dev)
    stg_mean = stg_sum / max(1, n_pairs)
    dur_mean = dur_sum / max(1, n_dev)

    util_p = (pred.busy[0] / bt_p if bt_p > 0
              else np.zeros(pred.n_devices))
    util_a = actual.utilization()                      # (S, n_devices)
    util_max = np.abs(util_p - util_a).max(axis=1)
    bubble = np.abs((1.0 - util_a.mean(axis=1))
                    - (1.0 - util_p.mean()))

    return [CellMetrics(
        batch_time_error=float(bte[s]),
        activity_error_mean=float(act_mean[s]),
        activity_error_max=float(act_max[s]),
        stage_error_mean=float(stg_mean[s]),
        stage_error_max=float(stg_max[s]),
        duration_error_mean=float(dur_mean[s]),
        duration_error_max=float(dur_max[s]),
        utilization_delta_max=float(util_max[s]),
        bubble_delta=float(bubble[s]),
        worst_batch_time_error=float(bte[s]),
    ) for s in range(S)]


def aggregate(per_seed: Sequence[CellMetrics]) -> CellMetrics:
    """Field-wise mean over seeds; ``worst_batch_time_error`` takes the
    max so the aggregate still exposes the worst single replay."""
    if not per_seed:
        return CellMetrics()
    n = len(per_seed)
    fields = [f.name for f in dataclasses.fields(CellMetrics)]
    means = {f: sum(getattr(m, f) for m in per_seed) / n for f in fields}
    means["worst_batch_time_error"] = max(m.worst_batch_time_error
                                          for m in per_seed)
    return CellMetrics(**means)

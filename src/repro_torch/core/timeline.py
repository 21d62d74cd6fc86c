"""Per-device activity timeline — DistSim's output artifact (paper Fig. 6).

Activities carry (device, kind, stage, micro, start, end); utilities
compute batch time, per-device busy/idle, bubble fraction, and the
paper's evaluation metrics (batch-time error, per-device activity error,
per-stage timestamp error).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Activity:
    device: int
    name: str              # e.g. "F:s2:m5"
    kind: str              # F | B | P2P | AR | OPT
    start: float
    end: float
    stage: int = -1
    micro: int = -1

    @property
    def dur(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class Timeline:
    activities: List[Activity]
    n_devices: int

    @property
    def batch_time(self) -> float:
        return max((a.end for a in self.activities), default=0.0)

    def by_device(self) -> Dict[int, List[Activity]]:
        out: Dict[int, List[Activity]] = {d: [] for d in range(self.n_devices)}
        for a in self.activities:
            out[a.device].append(a)
        for v in out.values():
            v.sort(key=lambda a: a.start)
        return out

    def busy_time(self, device: int, kinds=("F", "B", "AR", "OPT")) -> float:
        return sum(a.dur for a in self.activities
                   if a.device == device and a.kind in kinds)

    def utilization(self) -> Dict[int, float]:
        """Per-device busy fraction in ONE pass over the activities
        (``busy_time`` per device would be O(devices x activities) — it
        dominated 4096-device timelines). Devices with no activities —
        e.g. degenerate pp stages that got no layers and hence no OPT
        events — report 0.0, including on a fully empty timeline
        (batch_time 0)."""
        bt = self.batch_time
        if bt <= 0.0:
            return {d: 0.0 for d in range(self.n_devices)}
        busy = [0.0] * self.n_devices
        for a in self.activities:
            if a.kind in ("F", "B", "AR", "OPT"):
                busy[a.device] += a.end - a.start
        return {d: busy[d] / bt for d in range(self.n_devices)}

    def bubble_fraction(self, util: Optional[Dict[int, float]] = None
                        ) -> float:
        """Idle fraction averaged over devices; pass a precomputed
        ``utilization()`` map to avoid recomputing it."""
        if not self.activities:
            return 0.0          # nothing scheduled — no bubbles either
        if util is None:
            util = self.utilization()
        return 1.0 - sum(util.values()) / max(1, len(util))

    def compute_index(self) -> Dict[Tuple[int, str], Activity]:
        """(device, name) → activity, compute events only."""
        return {(a.device, a.name): a for a in self.activities
                if a.kind in ("F", "B")}


class LazyTimeline(Timeline):
    """Timeline whose activity list is materialized on first access.

    The event-flow engine knows the aggregate stats (batch time,
    per-device busy time) directly from its per-device arrays, so the
    O(devices x tasks) Python ``Activity`` construction is deferred
    until something actually iterates the activities (per-activity
    error metrics, trace export). ``DistSim.simulate()`` on a
    4096-device strategy never pays it.

    ``LazyTimeline.materializations`` counts every deferred build that
    actually ran, process-wide — the validate sweep's zero-
    materialization acceptance test reads it before/after a sweep.
    """

    #: process-wide count of deferred Activity-list builds that ran
    materializations: int = 0

    def __init__(self, n_devices: int, materialize, batch_time: float,
                 busy: Sequence[float]):
        # deliberately does NOT call the dataclass __init__: the
        # ``activities`` field is served by the property below.
        self.n_devices = n_devices
        self._materialize = materialize
        self._acts: Optional[List[Activity]] = None
        self._batch_time = batch_time
        self._busy = busy                  # per-device busy seconds

    @property
    def activities(self) -> List[Activity]:
        if self._acts is None:
            LazyTimeline.materializations += 1
            self._acts = self._materialize()
            self._materialize = None   # release the engine state held
        return self._acts

    @property
    def batch_time(self) -> float:
        return self._batch_time

    def utilization(self) -> Dict[int, float]:
        bt = self._batch_time
        if bt <= 0.0:
            return {d: 0.0 for d in range(self.n_devices)}
        return {d: self._busy[d] / bt for d in range(self.n_devices)}

    def bubble_fraction(self, util: Optional[Dict[int, float]] = None
                        ) -> float:
        # engine timelines always carry OPT activities, so the parent's
        # empty-list early-out (which would materialize) can't apply
        if util is None:
            util = self.utilization()
        return 1.0 - sum(util.values()) / max(1, len(util))


class TimelineBatch:
    """S replay runs of one engine as stacked ``(S, ...)`` arrays.

    Produced by ``EventFlowEngine.run_batched``: all seeds share a
    single dependency-resolution pass, and everything the validate
    sweep needs — per-seed batch time, per-device busy seconds, and
    the per-task compute start/end arrays that back the array-native
    error metrics — lives here as NumPy arrays. No ``Activity`` object
    is ever built unless :meth:`timeline` is called for one lane
    (trace export / debugging), which returns an ordinary
    :class:`LazyTimeline`.

    Array layout (``pp`` pipeline devices, ``dp`` replicas, ``mp``
    model-parallel ranks; ``n_sim`` is ``dp`` for noisy replays and 1
    when all replicas are provably identical):

    * ``starts[d]`` / ``ends[d]``: ``(S, n_sim, n_tasks_d)`` compute
      (F/B) task times for pipeline device ``d``, in schedule order,
      WITHOUT clock offsets (offsets are per mp rank);
    * ``offsets``: ``(S, dp, pp, mp)`` clock-skew constants;
    * ``busy``: ``(S, n_devices)`` busy seconds per full device
      (device index ``(r*pp + d)*mp + j``);
    * ``batch_times``: ``(S,)``.
    """

    def __init__(self, seeds: Sequence[Optional[int]], n_devices: int,
                 dp: int, pp: int, mp: int, n_sim: int,
                 batch_times: np.ndarray, busy: np.ndarray,
                 starts: List[np.ndarray], ends: List[np.ndarray],
                 offsets: np.ndarray,
                 lane_factory: Callable[[int], Callable[[], List[Activity]]]):
        self.seeds = list(seeds)
        self.n_devices = n_devices
        self.dp, self.pp, self.mp = dp, pp, mp
        self.n_sim = n_sim
        self.batch_times = batch_times
        self.busy = busy
        self.starts = starts
        self.ends = ends
        self.offsets = offsets
        self._lane_factory = lane_factory

    def __len__(self) -> int:
        return len(self.seeds)

    def timeline(self, i: int) -> LazyTimeline:
        """Lane ``i`` as a LazyTimeline (activities still deferred)."""
        return LazyTimeline(n_devices=self.n_devices,
                            materialize=self._lane_factory(i),
                            batch_time=float(self.batch_times[i]),
                            busy=self.busy[i])

    def utilization(self) -> np.ndarray:
        """(S, n_devices) busy fraction; 0 where batch_time is 0
        (mirrors ``Timeline.utilization`` on empty timelines)."""
        bt = self.batch_times[:, None]
        return np.divide(self.busy, bt, out=np.zeros_like(self.busy),
                         where=bt > 0)

    def bubble_fraction(self) -> np.ndarray:
        """(S,) idle fraction averaged over devices."""
        return 1.0 - self.utilization().mean(axis=1)


# --------------------------------------------------------------------------
# evaluation metrics (paper §5)
# --------------------------------------------------------------------------

def batch_time_error(pred: Timeline, actual: Timeline) -> float:
    """§5.2 relative iteration-time error. A zero-length oracle against
    a non-trivial prediction (or vice versa) is infinite error, not
    perfect agreement — a degenerate replay must trip the fidelity
    gate, not sail through it."""
    at = actual.batch_time
    if at == 0.0:
        return 0.0 if pred.batch_time == 0.0 else float("inf")
    return abs(pred.batch_time - at) / at


def _compute_pairs(pred: Timeline, actual: Timeline
                   ) -> List[Tuple[Tuple[int, str], Activity, Activity]]:
    """Matched (key, predicted, actual) compute activities."""
    ai = actual.compute_index()
    return [(key, p, ai[key]) for key, p in pred.compute_index().items()
            if key in ai]


def _timestamp_errors(pairs, bt: float) -> Dict[Tuple[int, str], float]:
    return {key: 0.5 * (abs(p.start - a.start) + abs(p.end - a.end)) / bt
            for key, p, a in pairs}


def _duration_errors(pairs, bt: float) -> Dict[Tuple[int, str], float]:
    return {key: abs(p.dur - a.dur) / bt for key, p, a in pairs}


def _device_means(errs: Dict[Tuple[int, str], float]) -> Dict[int, float]:
    per_dev: Dict[int, List[float]] = {}
    for (d, _), v in errs.items():
        per_dev.setdefault(d, []).append(v)
    return {d: sum(v) / len(v) for d, v in per_dev.items()}


def activity_error(pred: Timeline, actual: Timeline) -> Dict[int, float]:
    """§5.3: per-device mean |timestamp bias| of compute events,
    normalized by actual batch time."""
    return _device_means(per_stage_error(pred, actual))


def per_stage_error(pred: Timeline, actual: Timeline
                    ) -> Dict[Tuple[int, str], float]:
    """§5.4: per (device, F/B:stage:micro) timestamp error."""
    bt = actual.batch_time or 1.0
    return _timestamp_errors(_compute_pairs(pred, actual), bt)


def activity_duration_error(pred: Timeline, actual: Timeline
                            ) -> Dict[int, float]:
    """Per-device mean |duration| error of compute events, normalized by
    actual batch time — isolates event-time misprediction from schedule
    placement drift (which `activity_error` mixes in via timestamps)."""
    bt = actual.batch_time or 1.0
    return _device_means(_duration_errors(_compute_pairs(pred, actual), bt))


def _util_delta(pu: Dict[int, float], au: Dict[int, float]
                ) -> Dict[int, float]:
    # sorted: the union's hash order must not leak into the result's
    # key order (repro_torch.analyze lint rule L003); downstream consumers
    # reduce with max/mean, but dict order reaches reports via .items()
    return {d: abs(pu.get(d, 0.0) - au.get(d, 0.0))
            for d in sorted(set(pu) | set(au))}


def utilization_delta(pred: Timeline, actual: Timeline) -> Dict[int, float]:
    """Per-device |predicted − actual| busy fraction."""
    return _util_delta(pred.utilization(), actual.utilization())


def _mean_max(vals) -> Tuple[float, float]:
    vals = list(vals)
    if not vals:
        return 0.0, 0.0
    return sum(vals) / len(vals), max(vals)


def error_summary(pred: Timeline, actual: Timeline) -> Dict[str, float]:
    """All paper §5 conformance metrics for one predict-vs-replay pair,
    as a flat dict — the per-cell payload of ``repro_torch.validate``. The
    compute-activity match and the utilization maps are each built once
    and shared across the derived metrics."""
    bt = actual.batch_time or 1.0
    pairs = _compute_pairs(pred, actual)
    stage = _timestamp_errors(pairs, bt)
    act_mean, act_max = _mean_max(_device_means(stage).values())
    stg_mean, stg_max = _mean_max(stage.values())
    dur_mean, dur_max = _mean_max(
        _device_means(_duration_errors(pairs, bt)).values())
    pu, au = pred.utilization(), actual.utilization()
    _, util_max = _mean_max(_util_delta(pu, au).values())
    return {
        "batch_time_error": batch_time_error(pred, actual),
        "activity_error_mean": act_mean,
        "activity_error_max": act_max,
        "stage_error_mean": stg_mean,
        "stage_error_max": stg_max,
        "duration_error_mean": dur_mean,
        "duration_error_max": dur_max,
        "utilization_delta_max": util_max,
        "bubble_delta": abs(pred.bubble_fraction(pu)
                            - actual.bubble_fraction(au)),
    }


def to_chrome_trace(tl: Timeline, path: str) -> None:
    """Export a timeline as a Chrome trace (chrome://tracing /
    Perfetto). One row per device; compute/comm events color-coded by
    phase."""
    import json
    events = []
    for a in tl.activities:
        events.append({
            "name": a.name, "ph": "X",
            "ts": a.start * 1e6, "dur": max(a.dur * 1e6, 0.01),
            "pid": 0, "tid": a.device,
            "cat": a.kind,
            "args": {"stage": a.stage, "micro": a.micro},
        })
    meta = [{"name": "thread_name", "ph": "M", "pid": 0, "tid": d,
             "args": {"name": f"device {d}"}}
            for d in range(tl.n_devices)]
    with open(path, "w") as f:
        json.dump({"traceEvents": meta + events}, f)

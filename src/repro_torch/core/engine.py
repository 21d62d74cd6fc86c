"""Event-flow timeline engine (paper §4.3, Algorithm 1).

Replaces the seed's O((dp·pp)²·tasks) polling scheduler with a
dependency-driven ready-queue: a device becomes *enabled* the moment the
head task of its schedule has all inputs known, and enabled devices are
popped from a heap keyed on ``max(device_free, input_arrival)`` — the
paper's ``first_available`` placement rule, executed exactly once per
task instead of rediscovered by rescanning every device queue.

Structure exploited (the paper's "leverage the hierarchy" claim, plus
Alpa-style replica reuse):

* **MP**    — all mp ranks of a pipeline device run the same activities;
  they are materialized by replication, never simulated.
* **DP**    — replicas only interact at the gradient sync. With zero
  noise (``jitter == straggler == clock == 0``, the predict path) every
  replica's pipeline timeline is identical, so ONE canonical replica is
  simulated and the rest are replicated analytically: scheduling work is
  O(pp·m·vpp), independent of dp.
* **Noise** — the replay oracle draws all per-instance jitter factors
  vectorized per (replica × microbatch × event) batch up front; the
  inner scheduling loop never touches the RNG.

Replay-oracle modeling fixes vs the seed polling scheduler:

* **Clock skew** is one constant offset per (replica, device, mp rank)
  per run — the seed drew an independent offset per *activity*, which
  is profiling noise, not clock skew.
* **The DP gradient all-reduce is synchronizing**: it completes when the
  slowest participant does. Durations are drawn per replica and the
  *maximum* becomes the common end time — the seed let each replica
  exit the blocking collective at its own independently-jittered time.

RNG draw order (fixed; documented so seeds stay meaningful):
straggler speeds → per-position fwd/bwd event factors → p2p factors →
(decode only: feedback-p2p factors) → DP-sync factors → optimizer
factors → clock offsets. Train runs never reach the decode draw, so
pre-scenario seeds reproduce bit-identically.

Scenario generalization: the engine is scenario-keyed. ``TrainStep``
is the historical fwd+bwd pipeline (bit-identical). Serving scenarios
(``Prefill``/``Decode``) run a forward-only schedule without gradient
sync or optimizer; ``Decode`` additionally threads each autoregressive
step's token feedback from the last stage back to stage 0 and applies
per-step arrival floors (continuous batching) through the same
dependency recurrence.
"""
from __future__ import annotations

import heapq
from collections import deque
from math import isnan
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.events import Event, Stage, Strategy
from repro_torch.core.profiler import Provider
from repro_torch.core.scenario import TRAIN, Scenario
from repro_torch.core.schedules import build_schedule, forward_only
from repro_torch.core.timeline import (Activity, LazyTimeline, Timeline,
                                 TimelineBatch)

_MIN_JITTER_FACTOR = 0.05       # clamp: an event never runs 20x faster


def _jittered(base: np.ndarray, rng, sigma: float) -> np.ndarray:
    """base * clamp(1 + sigma*N(0,1)), elementwise, vectorized."""
    f = np.maximum(_MIN_JITTER_FACTOR,
                   1.0 + sigma * rng.standard_normal(base.shape))
    return base * f


class EngineBuild:
    """Schedule-independent precomputation of an engine build.

    Everything here depends only on (stages, strategy *modulo schedule
    and microbatch count*, provider): per-position event means, p2p
    boundary means and the DP-level sync/optimizer means. The pipeline
    schedule only reorders tasks over this structure, so one build is
    shared by every same-vpp schedule of a (model, strategy) pair —
    gpipe/1f1b/pipedream always; interleaved too unless its vpp=2
    changes the position structure — the reuse
    ``repro_torch.validate.BuildCache`` exploits (verified bit-identical in
    ``tests/test_sweep_scale.py``).

    ``with_dp_sync=None`` (the cache's mode) precomputes the gradient
    sync means whenever ``dp > 1`` so a later non-pipedream engine can
    share a build first made for pipedream; passing the engine's actual
    sync flag reproduces the historical lazy behavior exactly.

    ``scenario`` keys the build (stored *stripped* — modulo decode step
    count / arrivals, which are schedule-level): serving builds skip the
    gradient-sync and optimizer means entirely; decode builds add the
    token-feedback p2p mean. Class-level defaults below double as the
    upgrade path for builds unpickled from pre-scenario stores.
    """

    # unpickle compat: pre-scenario store pickles lack these attributes
    scenario: Scenario = TRAIN
    fb_base: float = 0.0

    def __init__(self, stages: Sequence[Stage], strat: Strategy,
                 provider: Provider,
                 with_dp_sync: Optional[bool] = None,
                 scenario: Scenario = TRAIN):
        self.stages = list(stages)
        cluster = provider.cluster
        pp, vpp = strat.pp, strat.vpp
        self.n_pos = len(self.stages)
        self.cache_version = provider.cache_version
        self.scenario = scenario.stripped()

        # ---- per-position event means (profiled once, reused) ----
        # Python-float sequential sums keep the predict path bit-identical
        # with the historical scheduler (which summed draw-by-draw).
        self.fwd_event_means: List[np.ndarray] = []
        self.bwd_event_means: List[np.ndarray] = []
        self.fwd_base: List[float] = []
        self.bwd_base: List[float] = []
        for st in self.stages:
            fm = [provider.time(e) for e in st.fwd.events]
            bm = [provider.time(e) for e in st.bwd.events]
            self.fwd_event_means.append(np.asarray(fm))
            self.bwd_event_means.append(np.asarray(bm))
            self.fwd_base.append(sum(fm))
            self.bwd_base.append(sum(bm))

        # p2p mean per boundary (identical fwd/bwd: same structural event)
        span = strat.mp + 1
        scope = "intra" if span <= cluster.devices_per_island else "inter"
        self.p2p_base = [
            provider.time(Event(kind="p2p", name=f"p2p:pos{p}",
                                nbytes=self.stages[p].boundary_act_bytes,
                                scope=scope))
            for p in range(self.n_pos)]

        # ---- DP-level event means per pipeline device ----
        chip = cluster.chip
        dp = strat.dp
        train = self.scenario.is_train
        want_sync = (dp > 1 if with_dp_sync is None else with_dp_sync)
        want_sync = want_sync and train      # serving: no gradient sync
        self.ar_base: List[float] = []
        self.opt_base: List[float] = []
        if not train:
            # forward-only: no gradient sync, no optimizer step
            self.ar_base = [0.0] * pp
            self.opt_base = [0.0] * pp
            self.fb_base = 0.0
            if self.scenario.kind == "decode" and self.stages:
                fb_bytes = getattr(self.stages[-1], "feedback_bytes", 0.0)
                span = strat.mp * strat.pp   # last stage back to stage 0
                fscope = ("intra" if span <= cluster.devices_per_island
                          else "inter")
                self.fb_base = provider.time(Event(
                    kind="p2p", name="p2p:fb", nbytes=fb_bytes,
                    scope=fscope))
            return
        for d in range(pp):
            pos_list = [c * pp + d for c in range(vpp)
                        if c * pp + d < self.n_pos]
            pbytes = (sum(self.stages[p].param_bytes for p in pos_list)
                      / max(1, strat.mp))
            pbytes *= strat.grad_compress      # int8 compression what-if
            ar = 0.0
            if want_sync:
                gspan = dp * pp * strat.mp
                gscope = ("intra" if gspan <= cluster.devices_per_island
                          else "inter")
                if strat.zero1:
                    ar = (provider.time(Event(
                        kind="collective", name=f"dp_rs:d{d}",
                        coll_op="reduce_scatter", nbytes=pbytes,
                        n_dev=dp, scope=gscope))
                        + provider.time(Event(
                            kind="collective", name=f"dp_ag:d{d}",
                            coll_op="all_gather", nbytes=pbytes,
                            n_dev=dp, scope=gscope)))
                else:
                    ar = provider.time(Event(
                        kind="collective", name=f"dp_ar:d{d}",
                        coll_op="all_reduce", nbytes=pbytes,
                        n_dev=dp, scope=gscope))
            self.ar_base.append(ar)
            # AdamW: streams fp32 master params + m + v (~6 passes of 2x)
            opt_bytes = pbytes * (1.0 / dp if strat.zero1 else 1.0)
            self.opt_base.append(6.0 * opt_bytes * 2 / chip.hbm_bw)


class EventFlowEngine:
    """One (stages × strategy × provider) simulation context.

    Build once, then ``run()`` any number of predict / replay variants —
    event means, schedules, task metadata and activity names are all
    precomputed here and shared across runs. Pass a precomputed
    ``build`` (:class:`EngineBuild`) to share the schedule-independent
    event-mean precomputation across engines that differ only in
    pipeline schedule / microbatch count.
    """

    def __init__(self, stages: Sequence[Stage], strat: Strategy,
                 provider: Provider, build: Optional[EngineBuild] = None,
                 scenario: Optional[Scenario] = None):
        self.strat = strat
        self.provider = provider
        if scenario is None:
            scenario = (getattr(build, "scenario", TRAIN)
                        if build is not None else TRAIN)
        self.scenario = scenario
        self._decode = scenario.kind == "decode"
        if not scenario.is_train and strat.vpp != 1:
            raise ValueError(
                f"scenario {scenario.label()!r} supports vpp=1 only")
        pp, vpp = strat.pp, strat.vpp
        m = scenario.task_count(strat)
        self.m = m
        dp = strat.dp
        self.sync = (dp > 1 and strat.schedule != "pipedream"
                     and scenario.is_train)
        self.has_opt = scenario.is_train
        if build is None:
            build = EngineBuild(stages, strat, provider,
                                with_dp_sync=self.sync, scenario=scenario)
        elif (len(build.stages) != len(stages)
              or any(a is not b for a, b in zip(build.stages, stages))):
            # a build for other stages would silently simulate the
            # wrong model — the engine reads ONLY build.stages
            raise ValueError("build was precomputed for different "
                             "stages than the ones passed")
        elif getattr(build, "scenario", TRAIN) != scenario.stripped():
            raise ValueError(
                f"build was precomputed for scenario "
                f"{getattr(build, 'scenario', TRAIN).label()!r}, engine "
                f"wants {scenario.stripped().label()!r}")
        self.build = build
        self.stages = build.stages
        self.n_pos = build.n_pos
        self.cache_version = build.cache_version
        self.fwd_event_means = build.fwd_event_means
        self.bwd_event_means = build.bwd_event_means
        self.fwd_base = build.fwd_base
        self.bwd_base = build.bwd_base
        self.p2p_base = build.p2p_base
        # non-syncing engines read zeros even when the shared build
        # precomputed the (unused) sync means
        self.ar_base = (build.ar_base if self.sync
                        else [0.0] * pp)
        self.opt_base = build.opt_base
        self.fb_base = getattr(build, "fb_base", 0.0)
        # decode arrival floors, padded to one entry per step
        arrivals = list(getattr(scenario, "arrivals", ()))[:m]
        self.arrival: List[float] = arrivals + [0.0] * (m - len(arrivals))

        # ---- schedule task lists as flat per-device metadata ----
        sched = (build_schedule(strat.schedule, pp, m, vpp)
                 if scenario.is_train else forward_only(pp, m))
        self.task_isf: List[List[bool]] = []
        self.task_pos: List[List[int]] = []
        self.task_micro: List[List[int]] = []
        self.task_name: List[List[str]] = []
        self.task_p2p_name: List[List[Optional[str]]] = []
        for d in range(pp):
            isf = [t.phase == "F" for t in sched[d]]
            pos = [t.chunk * pp + d for t in sched[d]]
            mic = [t.micro for t in sched[d]]
            self.task_isf.append(isf)
            self.task_pos.append(pos)
            self.task_micro.append(mic)
            self.task_name.append(
                [f"{'F' if f else 'B'}:s{p}:m{i}"
                 for f, p, i in zip(isf, pos, mic)])
            # boundary sends carry the SENDING task's position in both
            # name and stage (matches the historical activity labels)
            p2p = []
            for f, p, i in zip(isf, pos, mic):
                if f and p < self.n_pos - 1:
                    p2p.append(f"P2P:f:s{p}:m{i}")
                elif f and self._decode:
                    # last stage feeds sampled tokens back to stage 0
                    p2p.append(f"P2P:fb:m{i}")
                elif not f and p > 0:
                    p2p.append(f"P2P:b:s{p}:m{i}")
                else:
                    p2p.append(None)
            self.task_p2p_name.append(p2p)
        self.total_tasks = sum(len(t) for t in self.task_isf)
        self._topo: Optional[List[Tuple[int, int]]] = None
        # bounded FIFO: sweeps alternate two keys (predict + replay);
        # the cap keeps long-lived cached engines from pinning one
        # TimelineBatch per seed set ever requested
        self._batch_memo: dict = {}

    _BATCH_MEMO_MAX = 8

    # ------------------------------------------------------------------
    # noise sampling (vectorized; fixed draw order)
    # ------------------------------------------------------------------

    def _sample(self, dp: int, rng, jitter: float, straggler: float,
                clock: float, speed_scale=None):
        """All per-run random state, drawn up front.

        Returns (speed(dp,pp), dur_f, dur_b, p2p_f, p2p_b, fb, ar, opt,
        off) where dur_* are (dp, n_pos, m), fb is (dp, m) — the decode
        token-feedback p2p, zeros otherwise — ar/opt are (dp, pp) and
        off is (dp, pp, mp). The fb draw happens only for decode
        engines, so train RNG consumption is unchanged.

        ``speed_scale`` is a deterministic (dp, pp) duration multiplier
        (a :meth:`repro_torch.core.perturb.Perturbation.speed_grid`) composed
        onto the stochastic straggler plane AFTER all draws — it never
        touches the RNG, so seeded replays stay lane-comparable with
        and without a perturbation, and ``None`` leaves every code
        path byte-identical.
        """
        pp, m, mp = self.strat.pp, self.m, self.strat.mp
        n_pos = self.n_pos

        speed = np.ones((dp, pp))
        if rng is not None and straggler > 0:
            speed = 1.0 + straggler * np.abs(rng.standard_normal((dp, pp)))
        if speed_scale is not None:
            speed = speed * speed_scale

        dur_f = np.empty((dp, n_pos, m))
        dur_b = np.empty((dp, n_pos, m))
        p2p_f = np.zeros((dp, n_pos, m))
        p2p_b = np.zeros((dp, n_pos, m))
        draw_jitter = rng is not None and jitter > 0
        for p in range(n_pos):
            dev = p % pp
            if draw_jitter:
                fm, bm = self.fwd_event_means[p], self.bwd_event_means[p]
                fdur = (_jittered(np.broadcast_to(fm, (dp, m, len(fm))),
                                  rng, jitter).sum(-1)
                        if len(fm) else np.zeros((dp, m)))
                bdur = (_jittered(np.broadcast_to(bm, (dp, m, len(bm))),
                                  rng, jitter).sum(-1)
                        if len(bm) else np.zeros((dp, m)))
            else:
                fdur = np.full((dp, m), self.fwd_base[p])
                bdur = np.full((dp, m), self.bwd_base[p])
            dur_f[:, p] = fdur * speed[:, dev, None]
            dur_b[:, p] = bdur * speed[:, dev, None]
        for p in range(n_pos - 1):
            # forward send pos -> pos+1 and backward send pos+1 -> pos both
            # move stage-p boundary bytes; each is drawn (and straggled) on
            # its SENDING device.
            base = np.full((dp, m), self.p2p_base[p])
            ptf = _jittered(base, rng, jitter) if draw_jitter else base
            ptb = _jittered(base, rng, jitter) if draw_jitter else base
            p2p_f[:, p] = ptf * speed[:, p % pp, None]
            p2p_b[:, p] = ptb * speed[:, (p + 1) % pp, None]

        fb = np.zeros((dp, m))
        if self._decode:
            fbase = np.full((dp, m), self.fb_base)
            fb = _jittered(fbase, rng, jitter) if draw_jitter else fbase
            fb = fb * speed[:, (n_pos - 1) % pp, None]

        ar = np.asarray(self.ar_base)[None, :] * np.ones((dp, 1))
        opt = np.asarray(self.opt_base)[None, :] * np.ones((dp, 1))
        if draw_jitter:
            ar = _jittered(ar, rng, jitter)
            opt = _jittered(opt, rng, jitter)
        ar *= speed
        opt *= speed

        off = np.zeros((dp, pp, mp))
        if rng is not None and clock > 0:
            off = clock * rng.standard_normal((dp, pp, mp))
        return speed, dur_f, dur_b, p2p_f, p2p_b, fb, ar, opt, off

    # ------------------------------------------------------------------
    # single-replica pipeline simulation (ready-queue over arrays)
    # ------------------------------------------------------------------

    def _simulate_replica(self, dur_f, dur_b, p2p_f, p2p_b, fb=None):
        """List-schedule one DP replica's pipeline.

        dur/p2p: (n_pos, m) duration lookups for THIS replica; fb: (m,)
        decode token-feedback p2p durations (None for train/prefill).
        Returns (starts, ends, p2p_ends, free) — per-device lists aligned
        with the task lists; p2p_ends entries are None for tasks with no
        boundary send.
        """
        pp, n_pos = self.strat.pp, self.n_pos
        decode = self._decode
        arrival = self.arrival
        nan = float("nan")
        f_end = [[nan] * self.m for _ in range(n_pos)]
        arr_f = [[nan] * self.m for _ in range(n_pos)]
        arr_b = [[nan] * self.m for _ in range(n_pos)]
        fb_arr = [nan] * self.m         # decode: step feedback arrivals
        dur_f = dur_f.tolist()
        dur_b = dur_b.tolist()
        p2p_f = p2p_f.tolist()
        p2p_b = p2p_b.tolist()
        fb = fb.tolist() if fb is not None else None

        free = [0.0] * pp
        ptr = [0] * pp
        n_tasks = [len(t) for t in self.task_isf]
        starts = [[] for _ in range(pp)]
        ends = [[] for _ in range(pp)]
        p2p_ends: List[List[Optional[float]]] = [[] for _ in range(pp)]

        heap: List[Tuple[float, int]] = []
        enabled = [False] * pp

        def try_enable(d: int) -> None:
            if enabled[d] or ptr[d] >= n_tasks[d]:
                return
            i = ptr[d]
            pos, mic = self.task_pos[d][i], self.task_micro[d][i]
            if self.task_isf[d][i]:
                if pos != 0:
                    ready = arr_f[pos][mic]
                elif not decode:
                    ready = 0.0
                elif mic == 0:
                    ready = arrival[0]
                else:
                    fa = fb_arr[mic - 1]
                    ready = fa if isnan(fa) else max(fa, arrival[mic])
            else:
                ready = f_end[pos][mic]
                if pos < n_pos - 1 and not isnan(ready):
                    ab = arr_b[pos][mic]
                    ready = ab if isnan(ab) else max(ready, ab)
            if not isnan(ready):
                enabled[d] = True
                heapq.heappush(heap, (max(free[d], ready), d))

        for d in range(pp):
            try_enable(d)

        done = 0
        while heap:
            start, d = heapq.heappop(heap)
            enabled[d] = False
            i = ptr[d]
            pos, mic = self.task_pos[d][i], self.task_micro[d][i]
            if self.task_isf[d][i]:
                end = start + dur_f[pos][mic]
                f_end[pos][mic] = end
                if pos < n_pos - 1:
                    t_arr = end + p2p_f[pos][mic]
                    arr_f[pos + 1][mic] = t_arr
                    p2p_ends[d].append(t_arr)
                    try_enable((pos + 1) % pp)
                elif decode:
                    # token feedback to stage 0's next step; when d == 0
                    # (pp == 1) the trailing try_enable(d) below sees it
                    # after ptr advances
                    t_arr = end + fb[mic]
                    fb_arr[mic] = t_arr
                    p2p_ends[d].append(t_arr)
                    if d != 0:
                        try_enable(0)
                else:
                    p2p_ends[d].append(None)
            else:
                end = start + dur_b[pos][mic]
                if pos > 0:
                    t_arr = end + p2p_b[pos - 1][mic]
                    arr_b[pos - 1][mic] = t_arr
                    p2p_ends[d].append(t_arr)
                    try_enable((pos - 1) % pp)
                else:
                    p2p_ends[d].append(None)
            starts[d].append(start)
            ends[d].append(end)
            free[d] = end
            ptr[d] += 1
            done += 1
            try_enable(d)

        if done != self.total_tasks:
            raise RuntimeError(
                f"pipeline schedule deadlock: {self.strat.label()} "
                f"{self.strat.schedule} done={done}/{self.total_tasks}")
        return starts, ends, p2p_ends, free

    # ------------------------------------------------------------------
    # activity materialization (shared by run() and run_batched lanes)
    # ------------------------------------------------------------------

    def _materialize(self, dev_times, ar_span, opt_span, off
                     ) -> List[Activity]:
        """Build one run's Activity list from its timing accessors.

        ``dev_times(r, d)`` -> (starts, ends, p2p_ends) sequences
        aligned with device ``d``'s task list (p2p entries are read
        only for tasks that have a boundary send); ``ar_span(d)`` ->
        (start, end) of the gradient sync (read only when syncing);
        ``opt_span(r, d)`` -> (t0, t1); ``off[r, d, j]`` clock
        offsets. Sequential and batched runs feed the same materializer, so
        activity labeling can never diverge between the two paths.
        """
        acts: List[Activity] = []
        add = acts.append
        pp, dp, mp = self.strat.pp, self.strat.dp, self.strat.mp
        for r in range(dp):
            for d in range(pp):
                names = self.task_name[d]
                p2p_names = self.task_p2p_name[d]
                isf = self.task_isf[d]
                pos_l = self.task_pos[d]
                mic_l = self.task_micro[d]
                st_l, en_l, pe_l = dev_times(r, d)
                base = (r * pp + d) * mp
                for j in range(mp):
                    o = off[r, d, j]
                    dev = base + j
                    for i in range(len(names)):
                        s, e = st_l[i], en_l[i]
                        add(Activity(device=dev, name=names[i],
                                     kind="F" if isf[i] else "B",
                                     start=s + o, end=e + o,
                                     stage=pos_l[i], micro=mic_l[i]))
                        if p2p_names[i] is not None:
                            add(Activity(device=dev, name=p2p_names[i],
                                         kind="P2P", start=e + o,
                                         end=pe_l[i] + o, stage=pos_l[i],
                                         micro=mic_l[i]))
                    if self.sync:
                        a0, a1 = ar_span(d)
                        add(Activity(device=dev, name=f"AR:d{d}",
                                     kind="AR", start=a0 + o, end=a1 + o,
                                     stage=d))
                    if self.has_opt:
                        t0, t1 = opt_span(r, d)
                        add(Activity(device=dev, name=f"OPT:d{d}",
                                     kind="OPT", start=t0 + o, end=t1 + o,
                                     stage=d))
        return acts

    # ------------------------------------------------------------------
    # full run
    # ------------------------------------------------------------------

    def _perturb_grid(self, perturb):
        """Resolve a :class:`repro_torch.core.perturb.Perturbation` to its
        (dp, pp) multiplier plane (duck-typed — the engine stays
        import-free of the perturb module). The engine models only the
        straggler multipliers of ONE step; fault splicing across steps
        lives in ``DistSim.simulate(perturb=...)``."""
        if perturb is None:
            return None
        if getattr(perturb, "faults", ()):
            raise ValueError(
                "the engine evaluates one step; fault recovery is "
                "spliced at the run level — use "
                "DistSim.simulate(perturb=...)")
        return perturb.speed_grid(self.strat)

    def run(self, jitter_sigma: float = 0.0, straggler_sigma: float = 0.0,
            clock_sigma: float = 0.0, seed: Optional[int] = None,
            perturb=None) -> Timeline:
        strat = self.strat
        pp, dp, mp = strat.pp, strat.dp, strat.mp
        noisy = (jitter_sigma > 0 or straggler_sigma > 0 or clock_sigma > 0)
        rng = (np.random.RandomState(seed)
               if seed is not None and noisy else None)
        grid = self._perturb_grid(perturb)
        _, dur_f, dur_b, p2p_f, p2p_b, fb, ar, opt, off = self._sample(
            dp, rng, jitter_sigma, straggler_sigma, clock_sigma,
            speed_scale=grid)

        # DP replicas are independent until the gradient sync; with zero
        # noise they are identical — simulate one, replicate analytically
        # (a perturbation grid varies per replica, so it simulates all).
        n_sim = dp if (rng is not None or grid is not None) else 1
        reps = [self._simulate_replica(dur_f[r], dur_b[r],
                                       p2p_f[r], p2p_b[r],
                                       fb[r] if self._decode else None)
                for r in range(n_sim)]

        # ---- DP level: gradient sync + optimizer ----
        # A blocking all-reduce starts when the last participant arrives
        # and ends when the slowest draw completes — common to ALL
        # replicas (the synchronizing-collective fix).
        ar_start = [0.0] * pp
        ar_end = [0.0] * pp
        if self.sync:
            for d in range(pp):
                ar_start[d] = max(reps[r % n_sim][3][d] for r in range(dp))
                ar_end[d] = ar_start[d] + max(ar[r, d] for r in range(dp))
        opt_span = [[None] * pp for _ in range(dp)]
        for r in range(dp):
            freer = reps[r % n_sim][3]
            for d in range(pp):
                t0 = ar_end[d] if self.sync else freer[d]
                opt_span[r][d] = (t0, t0 + float(opt[r, d]))

        # ---- aggregate stats from the arrays (no Activity objects) ----
        # pipeline-level busy / latest-end per simulated replica & device
        pipe_busy = [[0.0] * pp for _ in range(n_sim)]
        pipe_last = [[0.0] * pp for _ in range(n_sim)]
        for s in range(n_sim):
            starts, ends, p2p_ends, _ = reps[s]
            for d in range(pp):
                b = 0.0
                last = 0.0
                for st, en in zip(starts[d], ends[d]):
                    b += en - st
                    if en > last:
                        last = en
                for pe in p2p_ends[d]:
                    if pe is not None and pe > last:
                        last = pe
                pipe_busy[s][d] = b
                pipe_last[s][d] = last

        busy: List[float] = [0.0] * (dp * pp * mp)
        batch_time = 0.0
        for r in range(dp):
            s = r % n_sim
            for d in range(pp):
                b = pipe_busy[s][d]
                if self.sync:
                    b += ar_end[d] - ar_start[d]
                t0, t1 = opt_span[r][d]
                b += t1 - t0
                last = max(pipe_last[s][d], t1)
                base = (r * pp + d) * mp
                for j in range(mp):
                    busy[base + j] = b
                    end_j = last + off[r, d, j]
                    if end_j > batch_time:
                        batch_time = end_j

        def materialize() -> List[Activity]:
            def dev_times(r, d):
                starts, ends, p2p_ends, _ = reps[r % n_sim]
                return starts[d], ends[d], p2p_ends[d]
            return self._materialize(
                dev_times, lambda d: (ar_start[d], ar_end[d]),
                lambda r, d: opt_span[r][d], off)

        return LazyTimeline(n_devices=dp * pp * mp, materialize=materialize,
                            batch_time=batch_time, busy=busy)

    # ------------------------------------------------------------------
    # batched multi-seed replay (one dependency pass, all seeds at once)
    # ------------------------------------------------------------------

    def _topo_order(self) -> List[Tuple[int, int]]:
        """One duration-free dependency-resolution pass.

        The task dependency DAG (device serialization + boundary
        arrivals) does not depend on event durations, so a single
        topological order of ``(device, task_index)`` is valid for
        EVERY seed and replica: the ready-queue's enabling conditions
        are replayed with known/unknown flags instead of times, and the
        pop order is recorded. ``run_batched`` then evaluates the
        timing recurrences along this order with all lanes stacked.
        """
        if self._topo is not None:
            return self._topo
        pp, n_pos, m = self.strat.pp, self.n_pos, self.m
        decode = self._decode
        f_known = [[False] * m for _ in range(n_pos)]
        af_known = [[False] * m for _ in range(n_pos)]
        ab_known = [[False] * m for _ in range(n_pos)]
        fb_known = [False] * m
        ptr = [0] * pp
        n_tasks = [len(t) for t in self.task_isf]
        order: List[Tuple[int, int]] = []
        queue: deque = deque()
        enabled = [False] * pp

        def try_enable(d: int) -> None:
            if enabled[d] or ptr[d] >= n_tasks[d]:
                return
            i = ptr[d]
            pos, mic = self.task_pos[d][i], self.task_micro[d][i]
            if self.task_isf[d][i]:
                if pos == 0:
                    ok = not decode or mic == 0 or fb_known[mic - 1]
                else:
                    ok = af_known[pos][mic]
            else:
                ok = f_known[pos][mic] and (pos == n_pos - 1
                                            or ab_known[pos][mic])
            if ok:
                enabled[d] = True
                queue.append(d)

        for d in range(pp):
            try_enable(d)
        while queue:
            d = queue.popleft()
            enabled[d] = False
            i = ptr[d]
            pos, mic = self.task_pos[d][i], self.task_micro[d][i]
            if self.task_isf[d][i]:
                f_known[pos][mic] = True
                if pos < n_pos - 1:
                    af_known[pos + 1][mic] = True
                    try_enable((pos + 1) % pp)
                elif decode:
                    fb_known[mic] = True
                    if d != 0:
                        try_enable(0)
            else:
                if pos > 0:
                    ab_known[pos - 1][mic] = True
                    try_enable((pos - 1) % pp)
            order.append((d, i))
            ptr[d] += 1
            try_enable(d)

        if len(order) != self.total_tasks:
            raise RuntimeError(
                f"pipeline schedule deadlock: {self.strat.label()} "
                f"{self.strat.schedule} done={len(order)}/"
                f"{self.total_tasks}")
        self._topo = order
        return order

    def topo_order(self) -> List[Tuple[int, int]]:
        """Public accessor for the cached duration-free topological
        order — the contract :class:`repro_torch.core.megabatch.MegaBatch`
        compiles against (step j of the array program evaluates the
        j-th entry of this order for every candidate)."""
        return self._topo_order()

    def run_batched(self, seeds: Optional[Sequence[Optional[int]]] = None,
                    jitter_sigma: float = 0.0,
                    straggler_sigma: float = 0.0,
                    clock_sigma: float = 0.0,
                    perturb=None) -> TimelineBatch:
        """All S seeds' replays in one pass, bit-identical per seed to
        sequential ``run(seed=s)`` calls.

        Per-seed noise is drawn exactly as ``run`` draws it (one
        RandomState per seed, same consumption order), stacked, and the
        scheduling recurrences are evaluated ONCE along the shared
        :meth:`_topo_order` with every (seed × replica) lane as a NumPy
        vector — the Python dependency walk no longer scales with S or
        dp. ``seeds=None`` is the predict lane (S=1, zero noise).
        ``perturb`` applies a deterministic straggler multiplier plane
        to every lane (see :meth:`_perturb_grid`); ``None`` is the
        byte-identical unperturbed path. Returns a
        :class:`TimelineBatch`; no ``Activity`` objects are built.
        """
        strat = self.strat
        pp, dp, mp = strat.pp, strat.dp, strat.mp
        m, n_pos = self.m, self.n_pos
        lane_seeds: List[Optional[int]] = ([None] if seeds is None
                                           else list(seeds))
        if not lane_seeds:
            raise ValueError("run_batched needs at least one seed")
        S = len(lane_seeds)
        noisy = (jitter_sigma > 0 or straggler_sigma > 0
                 or clock_sigma > 0)
        grid = self._perturb_grid(perturb)
        # any batched run is a pure function of (build, seeds, sigmas,
        # perturb) — memoized so cached engines (validate.BuildCache
        # reuse across sweeps) skip the draw + recurrence pass entirely
        # on a repeat. One entry per distinct combination actually
        # requested; sweeps use one.
        memo_key = (tuple(lane_seeds), jitter_sigma, straggler_sigma,
                    clock_sigma, perturb)
        hit = self._batch_memo.get(memo_key)
        if hit is not None:
            return hit

        samples = []
        any_rng = False
        for s in lane_seeds:
            rng = (np.random.RandomState(s)
                   if s is not None and noisy else None)
            any_rng = any_rng or rng is not None
            samples.append(self._sample(dp, rng, jitter_sigma,
                                        straggler_sigma, clock_sigma,
                                        speed_scale=grid))
        # A zero-noise lane has identical replicas, so simulating dp of
        # them (when other lanes are noisy) reproduces run()'s analytic
        # replication bit-for-bit. A perturbation grid varies per
        # replica, so it forces the full simulation too.
        n_sim = dp if (any_rng or grid is not None) else 1
        R = S * n_sim

        def lanes(k: int) -> np.ndarray:
            """samples[:][k] stacked and flattened to (R, ...)."""
            a = np.stack([smp[k] for smp in samples])
            return (a.reshape((R,) + a.shape[2:]) if n_sim == dp
                    else a[:, 0])

        durf_l, durb_l = lanes(1), lanes(2)         # (R, n_pos, m)
        p2pf_l, p2pb_l = lanes(3), lanes(4)
        fb_l = lanes(5)                             # (R, m)
        ar = np.stack([smp[6] for smp in samples])  # (S, dp, pp)
        opt = np.stack([smp[7] for smp in samples])
        off = np.stack([smp[8] for smp in samples])  # (S, dp, pp, mp)

        # ---- vectorized recurrence evaluation along the topo order ----
        decode = self._decode
        arrival = self.arrival
        n_tasks = [len(t) for t in self.task_isf]
        f_end = np.zeros((R, n_pos, m))
        arr_f = np.zeros((R, n_pos, m))
        arr_b = np.zeros((R, n_pos, m))
        fb_end = np.zeros((R, m))
        free = np.zeros((R, pp))
        starts = [np.zeros((R, n)) for n in n_tasks]
        ends = [np.zeros((R, n)) for n in n_tasks]
        p2p_end = [np.zeros((R, n)) for n in n_tasks]
        busy_pipe = np.zeros((R, pp))
        last_pipe = np.zeros((R, pp))

        for d, i in self._topo_order():
            pos, mic = self.task_pos[d][i], self.task_micro[d][i]
            fr = free[:, d]                # view — read-only until below
            if self.task_isf[d][i]:
                if pos != 0:
                    start = np.maximum(fr, arr_f[:, pos, mic])
                elif not decode:
                    start = fr
                elif mic == 0:
                    start = np.maximum(fr, arrival[0])
                else:
                    # same max grouping as the sequential heap key:
                    # max(free, max(feedback, arrival)) — exact either way
                    start = np.maximum(
                        fr, np.maximum(fb_end[:, mic - 1], arrival[mic]))
                end = start + durf_l[:, pos, mic]
                f_end[:, pos, mic] = end
                if pos < n_pos - 1:
                    arr = end + p2pf_l[:, pos, mic]
                    arr_f[:, pos + 1, mic] = arr
                    p2p_end[d][:, i] = arr
                    last_pipe[:, d] = np.maximum(last_pipe[:, d], arr)
                elif decode:
                    arr = end + fb_l[:, mic]
                    fb_end[:, mic] = arr
                    p2p_end[d][:, i] = arr
                    last_pipe[:, d] = np.maximum(last_pipe[:, d], arr)
            else:
                ready = f_end[:, pos, mic]
                if pos < n_pos - 1:
                    ready = np.maximum(ready, arr_b[:, pos, mic])
                start = np.maximum(fr, ready)
                end = start + durb_l[:, pos, mic]
                if pos > 0:
                    arr = end + p2pb_l[:, pos - 1, mic]
                    arr_b[:, pos - 1, mic] = arr
                    p2p_end[d][:, i] = arr
                    last_pipe[:, d] = np.maximum(last_pipe[:, d], arr)
            starts[d][:, i] = start
            ends[d][:, i] = end
            busy_pipe[:, d] += end - start  # before free[:, d] aliases start
            free[:, d] = end
            last_pipe[:, d] = np.maximum(last_pipe[:, d], end)

        # ---- DP level (same fold order as run(), vectorized over S) ----
        def expand(a: np.ndarray) -> np.ndarray:
            """(S, n_sim, pp) -> (S, dp, pp) replica view (r % n_sim)."""
            a = a.reshape(S, n_sim, pp)
            return a if n_sim == dp else np.broadcast_to(a, (S, dp, pp))

        free_e = expand(free)
        busy_e = expand(busy_pipe)
        last_e = expand(last_pipe)

        ar_start = np.zeros((S, pp))
        ar_end = np.zeros((S, pp))
        if self.sync:
            ar_start = free_e.max(axis=1)
            ar_end = ar_start + ar.max(axis=1)
            opt_t0 = np.broadcast_to(ar_end[:, None, :], (S, dp, pp))
        else:
            opt_t0 = free_e
        opt_t1 = opt_t0 + opt

        busy_full = busy_e
        if self.sync:
            busy_full = busy_full + (ar_end - ar_start)[:, None, :]
        busy_full = busy_full + (opt_t1 - opt_t0)
        busy_dev = np.broadcast_to(
            busy_full[:, :, :, None], (S, dp, pp, mp)).reshape(S, -1)

        last = np.maximum(last_e, opt_t1)                # (S, dp, pp)
        end_j = last[:, :, :, None] + off                # (S, dp, pp, mp)
        batch_times = np.maximum(end_j.max(axis=(1, 2, 3)), 0.0)

        starts_r = [a.reshape(S, n_sim, -1) for a in starts]
        ends_r = [a.reshape(S, n_sim, -1) for a in ends]
        p2p_r = [a.reshape(S, n_sim, -1) for a in p2p_end]

        def lane_factory(lane: int):
            def materialize() -> List[Activity]:
                def dev_times(r, d):
                    rr = r % n_sim
                    return (starts_r[d][lane, rr], ends_r[d][lane, rr],
                            p2p_r[d][lane, rr])
                return self._materialize(
                    dev_times,
                    lambda d: (ar_start[lane, d], ar_end[lane, d]),
                    lambda r, d: (opt_t0[lane, r, d], opt_t1[lane, r, d]),
                    off[lane])
            return materialize

        batch = TimelineBatch(
            seeds=lane_seeds, n_devices=dp * pp * mp, dp=dp, pp=pp, mp=mp,
            n_sim=n_sim, batch_times=batch_times, busy=busy_dev,
            starts=starts_r, ends=ends_r, offsets=off,
            lane_factory=lane_factory)
        if len(self._batch_memo) >= self._BATCH_MEMO_MAX:
            self._batch_memo.pop(next(iter(self._batch_memo)))
        self._batch_memo[memo_key] = batch
        return batch

"""Static event-graph verifier (pure numpy — no jax).

The engine's task graph is an IR (DistIR's observation: a distributed
program you can analyze before you simulate it). This pass re-derives
the dependency structure of an :class:`~repro_torch.core.engine
.EventFlowEngine` / :class:`~repro_torch.core.megabatch.MegaBatch` from
first principles — independently of the schedulers that will consume
it — and checks the invariants everything downstream silently assumes:

======  ===========================================================
rule    invariant
======  ===========================================================
G001    dependency graph is acyclic (an independent Kahn pass drains)
G002    every dependency names a task that exists (no dangling refs)
G003    task coverage: each (phase, position, microbatch) appears
        exactly once, on the device its position maps to
G004    ``topo_order()`` is a valid linearization of the true edges —
        the MegaBatch compile contract
G005    MegaBatch array program validity: out-slots are a permutation,
        padding writes the trash slot, every dependency (≤3 planes per
        task, by construction) reads a slot already written at an
        earlier step of the same candidate or the dummy slot
        (write-before-read), delays/durations finite and non-negative
G006    device-serialization chains: per-device task metadata aligned;
        in the compiled program, dep0 follows the slot-predecessor
        chain with exactly one chain head per non-empty device
G007    scenario consistency: decode graphs carry per-step KV ``hbm``
        reads and monotone non-negative arrival floors; serving
        engines are forward-only (no B tasks, no sync/optimizer)
G008    perturbation well-formedness: straggler/fault ranks inside the
        (dp, pp, mp) mesh, fault steps inside the run, and every fault
        prefix survivable by ``replan_mesh`` (model group intact)
G009    event-mean sanity: profiled means finite and non-negative
G010    static HBM over-capacity: ``estimate_memory`` exceeds the
        ``HBM_BUDGET`` share of the chip's HBM (cell-level check)
======  ===========================================================

Everything is duck-typed over the engine/build attributes so this
module imports nothing from :mod:`repro_torch.core` at module scope — the
constructors can call into it lazily with no import cycle.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.analyze.findings import Finding

_MAX_PER_RULE = 8      # cap repeated findings of one rule per subject


class _Reporter:
    """Collects findings, capping repeats of one rule so a systematic
    breakage (every microbatch dangling) stays readable."""

    def __init__(self, where: str):
        self.where = where
        self.findings: List[Finding] = []
        self._counts: Dict[str, int] = {}

    def add(self, rule: str, message: str) -> None:
        n = self._counts.get(rule, 0)
        self._counts[rule] = n + 1
        if n < _MAX_PER_RULE:
            self.findings.append(
                Finding(rule=rule, message=message, where=self.where))
        elif n == _MAX_PER_RULE:
            self.findings.append(Finding(
                rule=rule, where=self.where,
                message="further findings of this rule suppressed"))


def _label(engine) -> str:
    strat = getattr(engine, "strat", None)
    scen = getattr(engine, "scenario", None)
    parts = []
    if strat is not None:
        parts.append(strat.label())
        parts.append(strat.schedule)
    if scen is not None and not scen.is_train:
        parts.append(scen.label())
    return "/".join(parts) or engine.__class__.__name__


# --------------------------------------------------------------------------
# engine-level graph checks
# --------------------------------------------------------------------------

def _check_metadata(engine, rep: _Reporter) -> bool:
    """G006: the five per-device task metadata lists stay aligned."""
    ok = True
    pp = engine.strat.pp
    lists = (engine.task_isf, engine.task_pos, engine.task_micro,
             engine.task_name, engine.task_p2p_name)
    if any(len(lst) != pp for lst in lists):
        rep.add("G006", f"task metadata covers "
                        f"{sorted({len(lst) for lst in lists})} devices, "
                        f"strategy has pp={pp}")
        return False
    for d in range(pp):
        lens = {len(lst[d]) for lst in lists}
        if len(lens) != 1:
            rep.add("G006", f"device {d}: task metadata lists disagree "
                            f"on length ({sorted(lens)})")
            ok = False
    return ok

def _task_edges(engine, rep: _Reporter
                ) -> Tuple[List[Tuple[int, int]], List[List[int]]]:
    """Re-derive the task nodes and dependency edges from metadata.

    Returns ``(nodes, preds)`` where ``nodes[t] = (device, index)`` and
    ``preds[t]`` lists the task ids that must complete before ``t``.
    Emits G002 (dangling producer) and G003 (coverage/placement) along
    the way. The edge rules intentionally restate — rather than call —
    the engine's ready conditions, so a bug in the scheduler and a bug
    in the checker cannot cancel out.
    """
    pp, n_pos, m = engine.strat.pp, engine.n_pos, engine.m
    decode = engine.scenario.kind == "decode"
    train = engine.scenario.is_train

    nodes: List[Tuple[int, int]] = []
    meta: List[Tuple[bool, int, int]] = []        # (isf, pos, mic)
    producer: Dict[Tuple[str, int, int], int] = {}
    for d in range(pp):
        for i, (isf, pos, mic) in enumerate(zip(
                engine.task_isf[d], engine.task_pos[d],
                engine.task_micro[d])):
            t = len(nodes)
            nodes.append((d, i))
            meta.append((bool(isf), int(pos), int(mic)))
            key = ("F" if isf else "B", int(pos), int(mic))
            if key in producer:
                rep.add("G003", f"duplicate task {key} on devices "
                                f"{nodes[producer[key]][0]} and {d}")
            else:
                producer[key] = t
            if not (0 <= pos < n_pos):
                rep.add("G003", f"task {key} on device {d}: position "
                                f"{pos} outside [0, {n_pos})")
            elif pos % pp != d:
                rep.add("G003", f"task {key} placed on device {d}, "
                                f"position maps to {pos % pp}")
            if not (0 <= mic < m):
                rep.add("G003", f"task {key} on device {d}: microbatch "
                                f"{mic} outside [0, {m})")

    # coverage: the scenario dictates exactly which tasks must exist
    phases = ("F", "B") if train else ("F",)
    for ph in phases:
        for pos in range(n_pos):
            for mic in range(m):
                if (ph, pos, mic) not in producer:
                    rep.add("G003",
                            f"missing task {(ph, pos, mic)} — "
                            f"unreachable downstream consumers")
    if not train:
        stray = sorted(k for k in producer if k[0] == "B")
        for k in stray[:3]:
            rep.add("G007", f"forward-only scenario has backward "
                            f"task {k}")

    preds: List[List[int]] = [[] for _ in nodes]

    def dep(t: int, key: Tuple[str, int, int]) -> None:
        p = producer.get(key)
        if p is None:
            isf, pos, mic = meta[t]
            rep.add("G002",
                    f"task {('F' if isf else 'B', pos, mic)} depends on "
                    f"missing producer {key} (dangling dependency)")
        else:
            preds[t].append(p)

    prev: List[Optional[int]] = [None] * pp
    for t, ((d, _i), (isf, pos, mic)) in enumerate(zip(nodes, meta)):
        if prev[d] is not None:
            preds[t].append(prev[d])          # device serialization
        prev[d] = t
        if not (0 <= pos < n_pos and 0 <= mic < m):
            continue                          # already reported (G003)
        if isf:
            if pos > 0:
                dep(t, ("F", pos - 1, mic))
            elif decode and mic > 0:
                dep(t, ("F", n_pos - 1, mic - 1))   # token feedback
        else:
            dep(t, ("F", pos, mic))
            if pos < n_pos - 1:
                dep(t, ("B", pos + 1, mic))
    return nodes, preds


def _kahn(nodes, preds, rep: _Reporter) -> bool:
    """G001: independent acyclicity check over the re-derived edges."""
    n = len(nodes)
    succ: List[List[int]] = [[] for _ in range(n)]
    indeg = [0] * n
    for t, ps in enumerate(preds):
        indeg[t] = len(ps)
        for p in ps:
            succ[p].append(t)
    queue = [t for t in range(n) if indeg[t] == 0]
    drained = 0
    while queue:
        t = queue.pop()
        drained += 1
        for s in succ[t]:
            indeg[s] -= 1
            if indeg[s] == 0:
                queue.append(s)
    if drained != n:
        stuck = [nodes[t] for t in range(n) if indeg[t] > 0]
        rep.add("G001", f"dependency cycle: {n - drained} task(s) never "
                        f"become ready, e.g. (device, index) "
                        f"{stuck[:4]}")
        return False
    return True


def _check_topo(engine, nodes, preds, rep: _Reporter) -> None:
    """G004: ``topo_order()`` linearizes the true edges — the contract
    MegaBatch compiles against.

    Side-effect-free: ``topo_order()`` memoizes into ``engine._topo``,
    and a verification pass must not leave that cache behind — tests
    mutate task lists after construction and expect the stale order to
    be recomputed, not served from the verifier's snapshot.
    """
    prior = getattr(engine, "_topo", None)
    try:
        order = engine.topo_order()
    except Exception as exc:     # malformed metadata can crash it with
        rep.add("G004",          # anything — report, never propagate
                f"topo_order() failed on an acyclic graph: "
                f"{exc.__class__.__name__}: {exc}")
        return
    finally:
        engine._topo = prior
    index = {node: t for t, node in enumerate(nodes)}
    seen: Dict[Tuple[int, int], int] = {}
    for step, di in enumerate(order):
        di = (int(di[0]), int(di[1]))
        if di not in index:
            rep.add("G004", f"topo_order() yields unknown task {di}")
            return
        if di in seen:
            rep.add("G004", f"topo_order() repeats task {di}")
            return
        seen[di] = step
    if len(order) != len(nodes):
        rep.add("G004", f"topo_order() covers {len(order)}/{len(nodes)} "
                        f"tasks")
        return
    for t, ps in enumerate(preds):
        for p in ps:
            if seen[nodes[p]] >= seen[nodes[t]]:
                rep.add("G004",
                        f"topo_order() places dependency {nodes[p]} at "
                        f"step {seen[nodes[p]]}, after its consumer "
                        f"{nodes[t]} at step {seen[nodes[t]]}")
                return


def _check_scenario(engine, rep: _Reporter) -> None:
    """G007: scenario-specific graph shape."""
    scen = engine.scenario
    if scen.is_train:
        if any(a != 0.0 for a in getattr(engine, "arrival", ())):
            rep.add("G007", "train engine carries arrival floors")
        return
    # serving: forward-only epilogue
    if getattr(engine, "sync", False):
        rep.add("G007", "serving engine has a gradient sync")
    if getattr(engine, "has_opt", False):
        rep.add("G007", "serving engine has an optimizer step")
    if scen.kind != "decode":
        return
    arrivals = tuple(getattr(scen, "arrivals", ()))
    if any(a < 0 for a in arrivals):
        rep.add("G007", f"negative decode arrival floor in {arrivals}")
    if list(arrivals) != sorted(arrivals):
        rep.add("G007", f"decode arrival floors not monotone "
                        f"non-decreasing: {arrivals}")
    if len(arrivals) > scen.steps:
        rep.add("G007", f"{len(arrivals)} arrival floors for "
                        f"{scen.steps} decode steps")
    if getattr(engine, "fb_base", 0.0) < 0:
        rep.add("G007", "negative token-feedback p2p mean")
    # per-step KV reads: every stage whose layers own KV/SSM state must
    # read it from HBM each step; at least one stage must
    stages = getattr(engine, "stages", [])
    any_hbm = False
    for st in stages:
        kinds = [e.kind for e in st.fwd.events] if st.fwd else []
        has_hbm = "hbm" in kinds
        any_hbm = any_hbm or has_hbm
        layers = getattr(st, "layers", None) or []
        if any(getattr(l, "kv_read_bytes", 0.0) for l in layers) \
                and not has_hbm:
            rep.add("G007", f"decode stage {st.index} owns KV state but "
                            f"its forward bundle has no hbm read event")
    if stages and not any_hbm:
        rep.add("G007", "decode graph has no per-step KV hbm read "
                        "events in any stage")


def _check_means(build, rep: _Reporter) -> None:
    """G009: profiled means are finite and non-negative."""

    def arr(name, a):
        a = np.asarray(a, dtype=float)
        if a.size and (not np.all(np.isfinite(a)) or np.any(a < 0)):
            rep.add("G009", f"{name} contains negative or non-finite "
                            f"event means")

    for p, (fm, bm) in enumerate(zip(build.fwd_event_means,
                                     build.bwd_event_means)):
        arr(f"fwd_event_means[{p}]", fm)
        arr(f"bwd_event_means[{p}]", bm)
    arr("fwd_base", build.fwd_base)
    arr("bwd_base", build.bwd_base)
    arr("p2p_base", build.p2p_base)
    arr("ar_base", build.ar_base)
    arr("opt_base", build.opt_base)
    fb = getattr(build, "fb_base", 0.0)
    if not (math.isfinite(fb) and fb >= 0):
        rep.add("G009", f"fb_base = {fb!r}")


# --------------------------------------------------------------------------
# public entry points
# --------------------------------------------------------------------------

def verify_engine(engine) -> List[Finding]:
    """All graph checks for one :class:`EventFlowEngine`."""
    rep = _Reporter(_label(engine))
    _check_means(engine.build, rep)
    _check_scenario(engine, rep)
    if not _check_metadata(engine, rep):
        return rep.findings           # unaligned lists: nothing below holds
    nodes, preds = _task_edges(engine, rep)
    if _kahn(nodes, preds, rep):
        # only consult topo_order() on an acyclic graph — on a cyclic
        # one it deadlocks by design and G001 already says why
        _check_topo(engine, nodes, preds, rep)
    return rep.findings


def verify_build(build) -> List[Finding]:
    """Verify an :class:`EngineBuild` or a full engine.

    A bare build has no schedule yet, so only the schedule-independent
    checks (G009 means, scenario shape of the stages) apply; passing an
    engine (anything with task metadata) runs the full graph pass.
    """
    if hasattr(build, "task_isf"):
        return verify_engine(build)
    rep = _Reporter(f"build/{_label(build)}")
    _check_means(build, rep)
    return rep.findings


def verify_megabatch(mb) -> List[Finding]:
    """G005/G006 over a compiled :class:`MegaBatch` array program."""
    rep = _Reporter(f"megabatch[K={mb.K}]")
    trash = mb.total + 1
    dummy = 0
    if mb.K == 0:
        return rep.findings
    base = 1
    for k, eng in enumerate(mb.engines):
        n = eng.total_tasks
        col_where = f"candidate {k} ({_label(eng)})"
        out = mb._out[:, k]
        # out-slots: a permutation of this candidate's slot range,
        # padding steps parked on the trash slot
        want = np.arange(base, base + n)
        if not np.array_equal(np.sort(out[:n]), want):
            rep.add("G005", f"{col_where}: out-slots are not a "
                            f"permutation of [{base}, {base + n})")
            base += n
            continue
        if not np.all(out[n:] == trash):
            rep.add("G005", f"{col_where}: padding steps write real "
                            f"slots instead of the trash slot")
        # write-before-read: every dep plane reads the dummy slot or a
        # slot this candidate wrote at an EARLIER step. A dependency on
        # a later step is exactly what an unhonorable extra dependency
        # (the >3-deps defect class) compiles into.
        step_of = np.full(mb.n_slots, mb.T, dtype=np.int64)
        step_of[out[:n]] = np.arange(n)
        steps = np.arange(mb.T)
        n_heads = 0
        for plane, name in ((mb._dep0, "dep0"), (mb._dep1, "dep1"),
                            (mb._dep2, "dep2")):
            d = plane[:n, k]
            if np.any((d < 0) | (d >= mb.n_slots)) or np.any(d == trash):
                rep.add("G005", f"{col_where}: {name} reads a slot "
                                f"outside the program")
                continue
            foreign = (d != dummy) & ((d < base) | (d >= base + n))
            if np.any(foreign):
                rep.add("G005", f"{col_where}: {name} reads another "
                                f"candidate's slots at steps "
                                f"{np.nonzero(foreign)[0][:4].tolist()}")
            late = (d != dummy) & (step_of[d] >= steps[:n])
            if np.any(late):
                js = np.nonzero(late)[0][:4].tolist()
                rep.add("G005", f"{col_where}: {name} reads slots not "
                                f"yet written at steps {js} "
                                f"(write-before-read violated)")
            if name == "dep0":
                # G006: device serialization — dep0 is the previous
                # slot on the same device (slots are assigned in
                # device-major schedule order) or a chain head
                n_heads = int(np.sum(d == dummy))
                bad = (d != dummy) & (d != out[:n] - 1)
                if np.any(bad):
                    rep.add("G006", f"{col_where}: dep0 breaks the "
                                    f"device-serialization chain at "
                                    f"steps "
                                    f"{np.nonzero(bad)[0][:4].tolist()}")
        n_dev = sum(1 for lst in eng.task_isf if lst)
        if n_heads != n_dev:
            rep.add("G006", f"{col_where}: {n_heads} serialization "
                            f"chain heads for {n_dev} non-empty "
                            f"devices")
        for name, a in (("del1", mb._del1[:n, k]),
                        ("del2", mb._del2[:n, k]),
                        ("dur", mb._dur[:n, k])):
            if not np.all(np.isfinite(a)) or np.any(a < 0):
                rep.add("G005", f"{col_where}: {name} has negative or "
                                f"non-finite entries")
        base += n
    # epilogue arrays
    if np.any((mb._seg < 0) | (mb._seg >= max(1, mb.K * mb.ppmax))):
        rep.add("G005", "segment ids outside the (K, ppmax) grid")
    if np.any((mb._free_slot < 0) | (mb._free_slot > mb.total)):
        rep.add("G005", "free-slot ids outside the task slot range")
    return rep.findings


def verify_perturbation(perturb, strat) -> List[Finding]:
    """G008 over a :class:`Perturbation` against one strategy mesh."""
    rep = _Reporter(f"{perturb.label()} on {strat.label()}")
    world = strat.dp * strat.pp * strat.mp
    for s in perturb.stragglers:
        if s.rank >= world:
            rep.add("G008", f"straggler rank {s.rank} outside the "
                            f"{world}-device mesh")
    for f in perturb.faults:
        if f.rank >= world:
            rep.add("G008", f"fault rank {f.rank} outside the "
                            f"{world}-device mesh")
        if f.at_step >= perturb.steps:
            rep.add("G008", f"fault at step {f.at_step} outside the "
                            f"{perturb.steps}-step run")
    # survivability: precompute what simulate_degraded would replan
    from repro_torch.train.fault_tolerance import replan_mesh
    mp_model = strat.mp * strat.pp
    for dead in range(1, len(perturb.faults) + 1):
        survivors = world - dead
        f = perturb.faults[dead - 1]
        try:
            plan = replan_mesh(survivors, mp_model)
        except ValueError as exc:
            rep.add("G008", f"fault at step {f.at_step}: replan "
                            f"impossible ({exc})")
            continue
        if plan.model != mp_model:
            rep.add("G008",
                    f"unrecoverable fault at step {f.at_step}: "
                    f"{survivors} survivors cannot hold the "
                    f"mp*pp={mp_model} model group")
    return rep.findings


def verify_cell_memory(cfg, strat, microbatch: int, seq: int,
                       hbm_bytes: float, scenario=None) -> List[Finding]:
    """G010: static HBM over-capacity for one (model, strategy) cell."""
    from repro_torch.core.scenario import TRAIN
    from repro_torch.search.prune import HBM_BUDGET, hbm_headroom
    scenario = TRAIN if scenario is None else scenario
    rep = _Reporter(f"{cfg.name}/{strat.label()}/{scenario.label()}")
    head = hbm_headroom(cfg, strat, microbatch, seq, hbm_bytes,
                        scenario=scenario)
    if head < 0:
        rep.add("G010",
                f"estimated memory exceeds the {HBM_BUDGET:.0%} HBM "
                f"budget by {-head / 1e9:.2f} GB "
                f"(hbm={hbm_bytes / 1e9:.0f} GB)")
    return rep.findings

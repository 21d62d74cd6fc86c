"""Workload scenarios: the axis that generalizes DistSim beyond the
training step.

The event/timeline machinery (profiled events composed by strategy
hierarchy, dependency-driven placement) is not training-specific —
DistIR applies the same IR simulation to inference distribution. A
:class:`Scenario` names the workload whose event graph is being built
and carries its scenario-specific parameters:

* :class:`TrainStep` — the paper's workload: fwd+bwd per microbatch,
  DP gradient sync, optimizer step. The default everywhere; every
  existing call path is bit-identical to the pre-scenario code.
* :class:`Prefill` — inference prompt processing: one full-sequence
  forward per pipelined request (``Strategy.microbatches`` requests),
  no backward, no gradient sync, no optimizer.
* :class:`Decode` — autoregressive serving: ``steps`` seq=1 iterations
  over a batch of concurrent slots, each attention layer reading its
  KV cache from HBM (an explicit ``hbm`` event) and each step's first
  stage waiting on the previous step's sampled-token feedback from the
  last stage (plus optional per-step ``arrivals`` floors — the
  continuous-batching model: a step cannot start before the request
  traffic that fills it has arrived).

Scenarios are frozen (hashable) dataclasses: they participate directly
in engine/build-cache/store content addresses. ``to_dict`` /
:func:`scenario_from_dict` give them the same JSON round-trip surface
as :class:`~repro_torch.core.events.Strategy`.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Dict, Tuple


@dataclasses.dataclass(frozen=True)
class Scenario:
    """Base workload scenario (see module docstring). Subclasses set
    ``kind`` and override the derivation hooks they change."""

    kind: ClassVar[str] = "train"

    @property
    def is_train(self) -> bool:
        return self.kind == "train"

    # ---- derivation hooks (duck-typed over Strategy) ----

    def microbatch_size(self, strat, global_batch: int) -> int:
        """Samples per pipelined unit of work — delegates to the ONE
        train formula; :class:`Decode` reinterprets it as slot count."""
        return strat.microbatch_size(global_batch)

    def task_count(self, strat) -> int:
        """Pipelined work units per iteration (schedule's ``m``)."""
        return strat.microbatches

    def tokens(self, global_batch: int, seq: int) -> float:
        """Tokens processed per simulated iteration (throughput
        numerator): train/prefill push the full sequence."""
        return float(global_batch * seq)

    def kv_len(self, seq: int) -> int:
        """KV-cache context length (0 = no cache term)."""
        return 0

    def stripped(self) -> "Scenario":
        """The scenario modulo task count / arrival floors — the part
        an :class:`~repro_torch.core.engine.EngineBuild` (and therefore its
        store content address) actually depends on."""
        return self

    def label(self) -> str:
        return self.kind

    # ---- JSON round-trip (reports, goldens, store keys) ----

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["kind"] = self.kind
        return d


@dataclasses.dataclass(frozen=True)
class TrainStep(Scenario):
    """The paper's training step (fwd+bwd, DP sync, optimizer)."""

    kind: ClassVar[str] = "train"


@dataclasses.dataclass(frozen=True)
class Prefill(Scenario):
    """Full-sequence forward per request; requests pipeline through
    the stages exactly like training microbatches (forward only)."""

    kind: ClassVar[str] = "prefill"


@dataclasses.dataclass(frozen=True)
class Decode(Scenario):
    """``steps`` autoregressive seq=1 iterations over a slot batch.

    ``context`` is the KV-cache length each query attends to (0 = use
    the sim's ``seq``). ``arrivals`` are optional per-step earliest
    start times: step ``t``'s first stage waits on
    ``max(arrivals[t], previous step's token feedback)`` — the
    per-slot-arrival dependency that models continuous batching.
    """

    kind: ClassVar[str] = "decode"
    steps: int = 8
    context: int = 0
    arrivals: Tuple[float, ...] = ()

    def __post_init__(self):
        # tolerate lists (JSON round-trip) while staying hashable
        if not isinstance(self.arrivals, tuple):
            object.__setattr__(self, "arrivals", tuple(self.arrivals))
        if self.steps < 1:
            raise ValueError(f"Decode.steps must be >= 1, got {self.steps}")

    def microbatch_size(self, strat, global_batch: int) -> int:
        # concurrent decode slots per pipeline replica — decode has no
        # microbatch accumulation axis
        return max(1, global_batch // strat.dp)

    def task_count(self, strat) -> int:
        return self.steps

    def tokens(self, global_batch: int, seq: int) -> float:
        # one token per slot per autoregressive step
        return float(global_batch * self.steps)

    def kv_len(self, seq: int) -> int:
        return self.context if self.context else seq

    def stripped(self) -> "Decode":
        return dataclasses.replace(self, steps=1, arrivals=())

    def label(self) -> str:
        out = f"decode{self.steps}"
        if self.context:
            out += f"@{self.context}"
        return out


#: the default scenario — every pre-scenario call path.
TRAIN = TrainStep()

_KINDS = {"train": TrainStep, "prefill": Prefill, "decode": Decode}


def scenario_from_dict(d) -> Scenario:
    """Inverse of :meth:`Scenario.to_dict`; ``None`` (a report written
    before scenarios existed) loads as :data:`TRAIN`."""
    if d is None:
        return TRAIN
    if isinstance(d, Scenario):
        return d
    d = dict(d)
    kind = d.pop("kind", "train")
    try:
        cls = _KINDS[kind]
    except KeyError:
        raise ValueError(
            f"unknown scenario kind {kind!r}; have {sorted(_KINDS)}"
        ) from None
    from repro_torch.core.serde import dataclass_from_dict
    return dataclass_from_dict(cls, d)

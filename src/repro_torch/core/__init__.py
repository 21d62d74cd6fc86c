"""DistSim: event-based performance model of hybrid distributed training.

The paper's primary contribution: events (dedup of identical work),
profiling providers, hierarchical MP→PP→DP timeline construction and
the replay oracle, with the batched mega-batch predict on the card.

Public API:
    from repro_torch.core import DistSim, SimBatch, Strategy
"""
from repro_torch.core.events import (Strategy, Event, ComposedEvent,
                                     stage_signature)
from repro_torch.core.engine import EngineBuild, EventFlowEngine
from repro_torch.core.simulator import DistSim, SimBatch, SimResult
from repro_torch.core.megabatch import (MegaBatch, MegaPredict,
                                        megabatch_predict,
                                        program_from_arrays)
from repro_torch.core.perturb import (DegradedRun, Fault, Perturbation,
                                      Straggler, perturbation_from_dict,
                                      simulate_degraded)
from repro_torch.core.costmodel import (ClusterSpec, CLUSTERS, V5E_POD,
                                        A40_CLUSTER, H100_NODE,
                                        H100_CLUSTER, collective_time,
                                        get_cluster, p2p_time, ring_hops,
                                        ring_volume_factor)
from repro_torch.core.profiler import (AnalyticalProvider,
                                       HopperAnalyticalProvider,
                                       TorchMeasuredProvider, Provider,
                                       ProviderStats, profiling_cost,
                                       provider_for)
from repro_torch.core.timeline import (Timeline, Activity, LazyTimeline,
                                       TimelineBatch, batch_time_error,
                                       activity_error, per_stage_error)

__all__ = [
    "DistSim", "SimBatch", "SimResult", "Strategy", "Event",
    "ComposedEvent", "stage_signature", "EngineBuild", "EventFlowEngine",
    "MegaBatch", "MegaPredict", "megabatch_predict", "program_from_arrays",
    "DegradedRun", "Fault", "Perturbation", "Straggler",
    "perturbation_from_dict", "simulate_degraded",
    "grid_search", "SearchEntry",
    "ClusterSpec", "CLUSTERS", "V5E_POD", "A40_CLUSTER", "H100_NODE",
    "H100_CLUSTER", "get_cluster", "AnalyticalProvider",
    "HopperAnalyticalProvider", "TorchMeasuredProvider", "provider_for",
    "Provider", "ProviderStats", "profiling_cost",
    "Timeline", "Activity", "LazyTimeline", "TimelineBatch",
    "batch_time_error", "activity_error",
    "per_stage_error", "collective_time", "p2p_time",
    "ring_hops", "ring_volume_factor",
]


def __getattr__(name):
    """``grid_search`` and ``SearchEntry`` come from
    :mod:`repro_torch.core.search`, which imports :mod:`repro_torch.search`,
    which imports this package: resolved at first use, so the two
    packages import in either order."""
    if name in ("grid_search", "SearchEntry"):
        from repro_torch.core import search
        return getattr(search, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

"""repro_torch.store — disk-backed persistent profile store + query service.

The paper's unique-event dedup pushed to fleet scale: one
content-addressed store of profiled event times and engine builds,
shared across processes (nightly reruns, search invocations, sweep
executor workers), with a thin simulator-as-a-service front-end on top:

    from repro_torch.store import ProfileStore, ServeQuery
    from repro_torch.core.simulator import DistSim

    server = DistSim.serve("profile_store/")       # on the card
    answers = server.answer_batch([ServeQuery(...), ...])
    # a second server over the same directory re-profiles nothing

Store-served queries are bit-identical to cold in-process runs, and a
store warmed by the reference package serves this one's queries
(differential tests in ``tests/test_torch_serve.py``).
"""
from repro_torch.store.persistent import PersistentBuildCache
from repro_torch.store.profile_store import (FORMAT_VERSION, ProfileStore,
                                             StoreStats, build_key_json,
                                             event_from_dict, event_key,
                                             event_to_dict, open_store,
                                             provider_namespace)
from repro_torch.store.serve import ServeAnswer, ServeQuery, StrategyServer

__all__ = [
    "FORMAT_VERSION", "ProfileStore", "StoreStats", "build_key_json",
    "event_from_dict", "event_key", "event_to_dict", "open_store",
    "provider_namespace", "PersistentBuildCache", "ServeAnswer",
    "ServeQuery", "StrategyServer",
]

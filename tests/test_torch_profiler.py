"""``TorchMeasuredProvider`` on the CPU (asked for explicitly) against
the reference's ``MeasuredProvider``. Measured times are not comparable
(another framework, another machine state), so the bar is accounting:
identical ``ProviderStats`` over the same event list, the same cache
semantics, and a store namespace of its own.
"""
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref
import repro.configs.base as ref_configs
import repro.store as ref_store
import repro_torch.core as port
import repro_torch.configs.base as port_configs
import repro_torch.store as port_store
from repro.core.events import build_stage_events as ref_stage_events
from repro.core.events import unique_events as ref_unique
from repro_torch.core.events import build_stage_events, unique_events

STRAT = dict(mp=2, pp=2, dp=2, microbatches=2)


def event_lists():
    """The unique events of one smoke model under one strategy, in both
    packages, each repeated so that hits are exercised too."""
    out = []
    for pkg, configs, stage_events, uniq in (
            (ref, ref_configs, ref_stage_events, ref_unique),
            (port, port_configs, build_stage_events, unique_events)):
        cfg = configs.smoke_config(configs.get_config("gpt2_345m"))
        strat = pkg.Strategy(**STRAT)
        island = pkg.A40_CLUSTER.devices_per_island
        stages = stage_events(cfg, strat, 2, 32, island)
        events = list(uniq(stages, strat, island))
        out.append(events + events[::2])
    return out


def cpu_provider(**kw):
    return port.TorchMeasuredProvider(port.A40_CLUSTER, reps=1,
                                      device="cpu", **kw)


def test_provider_stats_identical_to_reference():
    ref_events, port_events = event_lists()
    assert len(ref_events) == len(port_events) > 4
    r = ref.MeasuredProvider(ref.A40_CLUSTER, reps=1)
    p = cpu_provider()
    for a, b in zip(ref_events, port_events):
        ta, tb = r.time(a), p.time(b)
        assert (a.kind, a.gemms == ()) == (b.kind, b.gemms == ())
        if a.kind != "compute":
            assert ta == tb            # ring/p2p/hbm models: bit for bit
        else:
            assert tb >= 0.0
    assert (p.stats.evaluations, p.stats.hits, p.stats.lookups) == \
        (r.stats.evaluations, r.stats.hits, r.stats.lookups)
    assert p.stats.hit_rate == r.stats.hit_rate
    assert p.cache_size == r.cache_size
    assert len(p._group_cache) == len(r._group_cache) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_time_group_is_positive_and_cached(dtype):
    p = cpu_provider(dtype=dtype)
    dims = ((32, 16, 64), (32, 64, 16))
    t = p._time_group(dims)
    assert t > 0.0 and p._group_cache[dims] == t
    assert p._time_group(dims) == t                  # served from cache


def test_tf32_flag_is_set_for_the_timing_and_restored():
    seen = []
    p = cpu_provider(dtype=torch.float32, tf32=True)
    run = p._run
    p._run = lambda inputs: (seen.append(
        torch.backends.cuda.matmul.allow_tf32), run(inputs))[1]
    before = torch.backends.cuda.matmul.allow_tf32
    p._time_group(((8, 8, 8),))
    assert seen and all(seen)                        # on while timing
    assert torch.backends.cuda.matmul.allow_tf32 == before
    q = cpu_provider(dtype=torch.float32, tf32=False)
    seen.clear()
    q._run = lambda inputs: (seen.append(
        torch.backends.cuda.matmul.allow_tf32), run(inputs))[1]
    q._time_group(((8, 8, 8),))
    assert seen and not any(seen)


def test_clear_cache_drops_group_cache_and_bumps_version():
    _, events = event_lists()
    p = cpu_provider()
    for e in events:
        p.time(e)
    assert p._group_cache and p.cache_size
    v = p.cache_version
    p.clear_cache()
    assert not p._group_cache and p.cache_size == 0
    assert p.cache_version == v + 1


def test_bare_copy_has_empty_caches_and_same_config():
    _, events = event_lists()
    p = cpu_provider(dtype=torch.float32)
    for e in events:
        p.time(e)
    b = p.bare()
    assert type(b) is port.TorchMeasuredProvider
    assert b._group_cache == {} and b.cache_size == 0
    assert b.stats.lookups == 0
    assert (b.cluster, b.reps, b.device, b.dtype, b.cache_version) == \
        (p.cluster, p.reps, p.device, p.dtype, p.cache_version)
    assert p._group_cache                             # original untouched


def test_store_namespaces():
    """Measured times never cross-serve: not with the reference's
    measured provider, not between dtypes; analytical providers on a
    copied preset share the reference's namespace; the Hopper curve
    has one of its own."""
    ns = port_store.provider_namespace
    measured = ns(cpu_provider())
    assert measured != ref_store.provider_namespace(
        ref.MeasuredProvider(ref.A40_CLUSTER))
    assert measured != ns(cpu_provider(dtype=torch.float32))
    assert ns(cpu_provider(dtype=torch.float32)) != \
        ns(cpu_provider(dtype=torch.float32, tf32=True))
    assert ns(port.AnalyticalProvider(port.A40_CLUSTER)) == \
        ref_store.provider_namespace(
            ref.AnalyticalProvider(ref.A40_CLUSTER))
    assert ns(port.HopperAnalyticalProvider(port.H100_CLUSTER)) != \
        ns(port.AnalyticalProvider(port.H100_CLUSTER))


def test_store_round_trip(tmp_path):
    _, events = event_lists()
    p = cpu_provider()
    times = {e: p.time(e) for e in events}
    store = port_store.ProfileStore(str(tmp_path / "s"))
    assert store.save_events(p) == len(times)
    q = cpu_provider()
    assert store.load_events(q) == len(times)
    assert all(q.time(e) == t for e, t in times.items())
    assert q.stats.evaluations == 0                  # all from the store
    other = cpu_provider(dtype=torch.float32)
    assert store.load_events(other) == 0             # another namespace


def test_default_device_is_the_card_and_never_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.TorchMeasuredProvider()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.TorchMeasuredProvider(port.A40_CLUSTER, device="cuda:0")

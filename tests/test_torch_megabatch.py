"""The port's ``MegaBatch`` against the reference's: compiled planes,
batch times and bubble fractions over the heterogeneous strategy list,
the empty-stage case, K = 0 and K = 1, and ``program_from_arrays``
(the same compiled program pushed through both packages).

Bars: planes ``np.array_equal``; batch times bit-identical to the
reference's numpy backend and to ``engine.run().batch_time`` (the
recurrence is ``+``/``max`` in float64 on every backend); bubble
fractions within 1e-12 (segment sums in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref
import repro.configs.base as ref_configs
import repro_torch.core as port
import repro_torch.configs.base as port_configs
from repro_torch.core.megabatch import PROGRAM_ARRAYS

STRAT_KW = [
    dict(mp=1, pp=1, dp=1, microbatches=1),
    dict(mp=1, pp=2, dp=2, microbatches=4),
    dict(mp=1, pp=4, dp=1, microbatches=8, schedule="gpipe"),
    dict(mp=2, pp=2, dp=1, microbatches=4, schedule="interleaved", vpp=2),
    dict(mp=1, pp=2, dp=2, microbatches=4, schedule="pipedream"),
    dict(mp=2, pp=2, dp=2, microbatches=4, zero1=True),
    dict(mp=1, pp=4, dp=2, microbatches=16, schedule="interleaved", vpp=3),
    dict(mp=1, pp=2, dp=2, microbatches=4, grad_compress=0.25),
    dict(mp=1, pp=8, dp=1, microbatches=8),
]
EMPTY_STAGE_KW = [dict(pp=4, microbatches=4), dict(pp=2, microbatches=2),
                  dict(pp=8, microbatches=8, schedule="gpipe")]


def engines_of(pkg, configs, kws, arch="gpt2_345m", smoke=False, seq=128):
    """Engines for the same strategies in one package (``pkg`` is
    ``repro.core`` or ``repro_torch.core``), on the A40 preset both
    packages hold unchanged."""
    cfg = configs.get_config(arch)
    if smoke:
        cfg = configs.smoke_config(cfg)
    provider = pkg.AnalyticalProvider(pkg.A40_CLUSTER)
    out = []
    for kw in kws:
        s = pkg.Strategy(**kw)
        out.append(pkg.DistSim(cfg, s, s.dp * s.microbatches * 2, seq,
                               provider).engine())
    return out


def both(kws, **kw):
    return (ref.MegaBatch(engines_of(ref, ref_configs, kws, **kw)),
            port.MegaBatch(engines_of(port, port_configs, kws, **kw),
                           device="cpu"))


@pytest.mark.parametrize("name", PROGRAM_ARRAYS)
def test_compiled_planes_equal(name):
    r, p = both(STRAT_KW)
    assert (p.T, p.K, p.total, p.n_slots, p.ppmax) == \
        (r.T, r.K, r.total, r.n_slots, r.ppmax)
    a, b = getattr(r, name), getattr(p, name)
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("backend", ["numpy", "torch", "auto"])
def test_batch_times_bit_identical_to_reference(backend):
    r, p = both(STRAT_KW)
    want = r.predict("numpy")
    got = p.predict(backend)
    assert got.backend == ("torch" if backend == "auto" else backend)
    assert (got.n_candidates, got.n_steps, got.n_slots) == \
        (want.n_candidates, want.n_steps, want.n_slots)
    assert np.array_equal(got.batch_times, want.batch_times)
    np.testing.assert_allclose(got.bubble_fractions,
                               want.bubble_fractions, rtol=0, atol=1e-12)


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_batch_times_bit_identical_to_per_engine_run(backend):
    engines = engines_of(port, port_configs, STRAT_KW)
    assert len({e.total_tasks for e in engines}) > 3     # ragged
    pred = port.MegaBatch(engines, device="cpu").predict(backend)
    for i, eng in enumerate(engines):
        tl = eng.run()
        assert float(pred.batch_times[i]) == tl.batch_time, \
            eng.strat.label()
        assert float(pred.bubble_fractions[i]) == pytest.approx(
            tl.bubble_fraction(), abs=1e-12)


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_empty_stage_candidates(backend):
    """pp > layer count: trailing devices own no tasks."""
    r, p = both(EMPTY_STAGE_KW, smoke=True, seq=64)
    got = p.predict(backend).batch_times
    assert np.array_equal(got, r.predict("numpy").batch_times)
    for i, eng in enumerate(p.engines):
        assert float(got[i]) == eng.run().batch_time


@pytest.mark.parametrize("backend", ["auto", "numpy", "torch"])
def test_no_candidates(backend):
    empty = port.MegaBatch([], device="cpu").predict(backend)
    assert empty.n_candidates == 0 and len(empty.batch_times) == 0
    assert empty.n_slots == 2


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_single_candidate(backend):
    r, p = both(STRAT_KW[:1])
    got = p.predict(backend).batch_times
    assert np.array_equal(got, r.predict("numpy").batch_times)
    assert float(got[0]) == p.engines[0].run().batch_time


def test_planes_are_uploaded_once_and_kept():
    _, p = both(STRAT_KW[:4])
    assert p.device_bytes() == 0
    a = p.predict("torch").batch_times
    planes = p.device_planes()
    assert p.device_bytes() > 0
    assert planes["out"].dtype == torch.int32
    assert planes["dep"].shape == (p.T, p.K, 3)
    assert planes["lengths"].tolist() == [e.total_tasks for e in p.engines]
    b = p.predict("torch").batch_times
    assert p.device_planes() is planes                # same tensors
    assert np.array_equal(a, b)
    assert np.array_equal(a, p.predict_times("numpy"))


@pytest.mark.parametrize("kws", [STRAT_KW, STRAT_KW[:1], EMPTY_STAGE_KW],
                         ids=["ragged", "single", "empty-stage"])
@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_program_from_arrays_round_trip(kws, backend):
    """The reference's compiled program, handed over as numpy arrays,
    evaluates to the reference's numbers in the port."""
    smoke = kws is EMPTY_STAGE_KW
    r = ref.MegaBatch(engines_of(ref, ref_configs, kws, smoke=smoke))
    arrays = {n: getattr(r, n) for n in PROGRAM_ARRAYS}
    arrays.update(total=r.total, n_slots=r.n_slots)
    p = port.program_from_arrays(arrays, device="cpu")
    assert p._len.tolist() == [e.total_tasks for e in r.engines]
    want = r.predict("numpy")
    got = p.predict(backend)
    assert np.array_equal(got.batch_times, want.batch_times)
    np.testing.assert_allclose(got.bubble_fractions,
                               want.bubble_fractions, rtol=0, atol=1e-12)


def test_program_from_arrays_rejects_inconsistent_slots():
    r = ref.MegaBatch(engines_of(ref, ref_configs, STRAT_KW[:2]))
    arrays = {n: getattr(r, n) for n in PROGRAM_ARRAYS}
    arrays.update(total=r.total, n_slots=r.n_slots + 1)
    with pytest.raises(ValueError, match="n_slots"):
        port.program_from_arrays(arrays, device="cpu")


def test_backend_names():
    _, p = both(STRAT_KW[:1])
    assert p.resolve_backend("auto") == "torch"       # a CPU program
    for gone in ("jax", "pallas"):
        with pytest.raises(ValueError, match="backend"):
            p.predict(gone)
    with pytest.raises(ValueError, match="CUDA device"):
        p.predict("cuda")                             # program is on CPU


def test_default_device_is_the_card_and_never_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    engines = engines_of(port, port_configs, STRAT_KW[:1])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.MegaBatch(engines)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.megabatch_predict(engines)


def test_perturb_is_refused_not_ignored():
    engines = engines_of(port, port_configs, STRAT_KW[:1])
    with pytest.raises(NotImplementedError, match="perturb"):
        port.MegaBatch(engines, perturb=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="perturb"):
        port.megabatch_predict(engines, perturb=object(), device="cpu")
    assert port.MegaBatch(engines, perturb=None, device="cpu").K == 1

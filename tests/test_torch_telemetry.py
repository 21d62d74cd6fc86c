"""The port's spans and counters (``repro_torch.telemetry``): the off
path, nesting across threads, per-unit counter increases, the span tree
of a training step and of a prefill request, the ``host_sync`` count of
the blockwise attention, and that recording changes no number."""
import dataclasses
import threading

import pytest

torch = pytest.importorskip("torch")

from repro_torch import telemetry
from repro_torch.configs.base import get_config, smoke_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.api import build_model
from repro_torch.models.layers import ModelOptions
from repro_torch.train import optimizer as opt
from repro_torch.train.step import make_prefill_step, make_train_step


def test_the_off_path_records_nothing_and_shares_one_object():
    first, second = telemetry.span("a"), telemetry.span("b")
    assert first is second
    with first as inside:
        assert inside is first
    with telemetry.recording() as rec:
        pass
    assert rec.spans == [] and rec.counts == {}


def test_a_second_recording_at_once_is_refused():
    with telemetry.recording():
        with pytest.raises(RuntimeError, match="already"):
            with telemetry.recording():
                pass


def test_nesting_parents_and_units():
    with telemetry.recording() as rec:
        with telemetry.span("step"):
            with telemetry.span("layer"):
                with telemetry.span("attn"):
                    pass
            with telemetry.span("layer"):
                pass
        with telemetry.span("step"):
            pass
    got = [(s.name, s.parent, s.unit) for s in rec.spans]
    assert got == [("step", -1, 0), ("layer", 0, 0), ("attn", 1, 0),
                   ("layer", 0, 0), ("step", -1, 1)]
    for s in rec.spans:
        assert 0 <= s.start_ns <= s.end_ns
        assert s.thread == threading.get_native_id()
    parent = rec.spans[2]
    assert rec.spans[1].start_ns <= parent.start_ns <= parent.end_ns <= \
        rec.spans[1].end_ns


def test_a_span_on_another_thread_joins_the_open_unit():
    """A thread with no span open takes the innermost span open on the
    unit's thread as parent, as the autograd engine's thread does in a
    CUDA backward; with no unit open it starts one of its own."""
    tids = []

    def worker():
        tids.append(threading.get_native_id())
        with telemetry.span("attention.bwd"):
            with telemetry.span("inner"):
                pass

    with telemetry.recording() as rec:
        with telemetry.span("step"):
            with telemetry.span("backward"):
                t = threading.Thread(target=worker)
                t.start()
                t.join(timeout=30)
                assert not t.is_alive()
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    got = [(s.name, s.parent, s.unit) for s in rec.spans]
    assert got == [("step", -1, 0), ("backward", 0, 0),
                   ("attention.bwd", 1, 0), ("inner", 2, 0),
                   ("attention.bwd", -1, 1), ("inner", 4, 1)]
    assert [s.thread for s in rec.spans] == [threading.get_native_id()] * 2 \
        + [tids[0]] * 2 + [tids[1]] * 2


def test_counters_count_always_and_by_unit_while_recording():
    before = telemetry.COUNTS.get("test.things", 0)
    telemetry.count("test.things")
    with telemetry.recording() as rec:
        with telemetry.span("unit"):
            telemetry.count("test.things", 3)
            telemetry.count("test.other")
        with telemetry.span("unit"):
            pass
        with telemetry.span("unit"):
            telemetry.count("test.things")
    assert telemetry.COUNTS["test.things"] == before + 5
    assert rec.counts[0]["test.things"] == 3
    assert rec.counts[0]["test.other"] == 1
    assert rec.counts[1] == {}
    assert rec.counts[2] == {"test.things": 1}


def _tiny(impl="flash_torch", remat=False):
    cfg = smoke_config(get_config("h2o_danube_1_8b"))
    opts = ModelOptions(dtype=torch.float32, attn_impl=impl, remat=remat,
                        block_q=16, block_kv=32)
    params = build_model(cfg, opts).init(torch.Generator().manual_seed(0),
                                         "cpu")
    toks = torch.randint(1, cfg.vocab, (2, 64),
                         generator=torch.Generator().manual_seed(1))
    return cfg, opts, params, {"tokens": toks, "labels": toks.roll(-1, 1)}


def _tree(rec):
    """Each span as (name, its parent's name), in order."""
    spans = rec.spans
    return [(s.name, spans[s.parent].name if s.parent >= 0 else None)
            for s in spans]


@pytest.mark.parametrize("impl,remat,per_layer", [
    ("flash_torch", False, 1), ("flash_torch", True, 2), ("naive", False, 0)])
def test_host_syncs_of_a_train_step(impl, remat, per_layer):
    """The blockwise attention copies its block pairs' positions to the
    host once a call: once a layer, twice where the checkpoint reruns
    the layer in the backward; the plain attention never."""
    cfg, opts, params, batch = _tiny(impl, remat)
    step = make_train_step(cfg, opts)
    with telemetry.recording() as rec:
        step(params, opt.init(params), batch)
    assert rec.counts[0].get("host_sync", 0) == per_layer * cfg.n_layers


def test_the_span_tree_of_a_train_step():
    cfg, opts, params, batch = _tiny()
    step = make_train_step(cfg, opts)
    with telemetry.recording() as rec:
        step(params, opt.init(params), batch)
    layer = [("lm.layer", "lm.forward"), ("attention.fwd", "lm.layer"),
             ("attention.block_pairs", "attention.fwd")]
    assert _tree(rec) == (
        [("step.train", None), ("lm.forward", "step.train")]
        + layer * cfg.n_layers
        + [("lm.head", "lm.forward"), ("lm.backward", "step.train")]
        + [("attention.bwd", "lm.backward")] * cfg.n_layers
        + [("optimizer.update", "step.train")])
    assert {s.unit for s in rec.spans} == {0}
    assert len(rec.spans) == 4 * cfg.n_layers + 5


def test_the_span_tree_of_a_prefill_request():
    """On the CPU the kernel's dispatcher takes its plain version, so no
    ``k2.launch`` span opens (the card's tree has one in each
    ``attention.fwd``)."""
    cfg, opts, params, batch = _tiny("cuda")
    step = make_prefill_step(cfg, opts)
    with telemetry.recording() as rec:
        step(params, {"tokens": batch["tokens"]})
        step(params, {"tokens": batch["tokens"]})
    one = ([("step.prefill", None), ("lm.forward", "step.prefill")]
           + [("lm.layer", "lm.forward"), ("attention.fwd", "lm.layer")]
           * cfg.n_layers + [("lm.head", "lm.forward")])
    assert _tree(rec) == one * 2
    assert [s.unit for s in rec.spans] == [0] * len(one) + [1] * len(one)
    assert rec.counts == {0: {}, 1: {}}


def test_a_traced_step_records_the_same_tree_and_no_host_sync():
    """Under the dry run's fake tensors the spans open as on real ones;
    the block pairs' positions come from the trace, so nothing syncs,
    and the traced count is the same with recording on."""
    from repro_torch.core import roofline
    cfg, opts, params, batch = _tiny()
    step = make_train_step(cfg, opts)
    with telemetry.recording() as real:
        step(params, opt.init(params), batch)
    off = roofline.trace_stats(step, params, opt.init(params), batch)
    with telemetry.recording() as rec:
        on = roofline.trace_stats(step, params, opt.init(params), batch)
    assert _tree(rec) == _tree(real)
    assert rec.counts == {0: {}}
    assert on == off


def test_the_kernel_launch_span_closes_on_a_refused_call():
    q = torch.zeros(1, 4, 2, 8)
    with telemetry.recording() as rec:
        with pytest.raises(ValueError, match="CUDA"):
            fa.flash_attention_cuda(q, q, q)
    (s,) = rec.spans
    assert s.name == "k2.launch" and s.end_ns >= s.start_ns


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_recording_changes_no_bit(kind):
    cfg, opts, params, batch = _tiny("flash_torch" if kind == "train"
                                     else "cuda")

    def run():
        if kind == "prefill":
            return [make_prefill_step(cfg, opts)(params,
                                                 {"tokens": batch["tokens"]})]
        p, state, m = make_train_step(cfg, opts)(params, opt.init(params),
                                                 batch)
        out = [m["loss"], m["grad_norm"], state.step]
        out += [t for tree in (p, state.mu, state.nu)
                for t in _leaves(tree)]
        return out

    off = run()
    with telemetry.recording() as rec:
        on = run()
    assert rec.spans
    assert len(off) == len(on)
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def _leaves(tree):
    from repro_torch.train.tree import leaves
    return leaves(tree)


@pytest.mark.gpu
def test_host_syncs_are_the_syncs_cuda_reports():
    """Needs a CUDA device: a small bf16 train step's ``host_sync``
    count against the synchronizing calls that CUDA's sync debug mode
    reports for the same step; a prefill through K2 syncs nowhere."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import warnings
    cfg = dataclasses.replace(smoke_config(get_config("h2o_danube_1_8b")),
                              n_layers=3)
    opts = ModelOptions(dtype=torch.bfloat16, attn_impl="flash_torch",
                        remat=False, block_q=64, block_kv=128)
    dev = torch.device("cuda")
    params = build_model(cfg, opts).init(torch.Generator(dev).manual_seed(0),
                                         dev)
    toks = torch.randint(1, cfg.vocab, (2, 512), device=dev)
    steps = {"train": (make_train_step(cfg, opts),
                       (params, opt.init(params),
                        {"tokens": toks, "labels": toks.roll(-1, 1)})),
             "prefill": (make_prefill_step(
                 cfg, dataclasses.replace(opts, attn_impl="cuda")),
                 (params, {"tokens": toks}))}
    for kind, (step, args) in steps.items():
        step(*args)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught, \
                telemetry.recording() as rec:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                step(*args)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs = sum("called a synchronizing CUDA operation" in
                    str(w.message) for w in caught)
        want = cfg.n_layers if kind == "train" else 0
        assert rec.counts[0].get("host_sync", 0) == syncs == want, kind
        if kind == "prefill":
            assert rec.counts[0]["k2.launches"] == cfg.n_layers
            assert sum(s.name == "k2.launch" for s in rec.spans) == \
                cfg.n_layers

"""Prefill traffic: a closed loop of one client's prompts.

Set-up builds the program's prefill step (``repro_torch.train.step.
make_prefill_step``), makes the weights and the pool of prompts from the
seed, and runs the mix's ``warmup`` requests (a mix of several lengths
warms each of them). The window then issues one request after the
other, in the pool's order and each when the last has completed, until
``--seconds`` have passed. A request's latency runs from its issue to
its completion, read on the device's clock (a CUDA event recorded on
the idle stream at issue, and one after its last kernel);
``prefill_ms_p90`` is the 90th percentile over every request of the
window, ``prefill_tokens_per_s`` the prompt tokens of every request over
the window's time on the host's clock.

The logits of ``checked_requests`` requests among the window's first
``sample_within`` are kept: the first of the longest prompts, and the
rest drawn from the seed. Once the window has
closed, the plain float32 reference (``bench/reference``) computes the
logits of the same prompts from the same weights, a layer at a time, and
these numbers are read over every position of those requests, each
compared where the cell's limits file gives it a limit and printed
beside the others:

* ``logit_err_median``, ``logit_err_max``: the median and the largest
  over the positions of ``|logits - reference| / |reference|`` over the
  vocabulary (Euclidean norms);
* ``top_gap_max``: the widest gap by which the reference's logit of the
  token the program puts first lies below the reference's best.

A request whose logits have another shape than the reference's reads
as infinitely far from it.
"""
from __future__ import annotations

import random
import statistics
import time

import torch

from bench import harness, traffic, tracing, weights
from bench.reference import decoder

ROWS = 512


def sample(mix: dict, seed: int) -> list:
    """The window's requests whose logits are compared: the first of
    the longest prompts among the first ``sample_within``, and the rest
    drawn from the seed."""
    sizes = traffic.lengths(mix)
    within = range(mix["sample_within"])
    longest = max(within, key=lambda i: (
        sizes[(mix["warmup"] + i) % len(sizes)], -i))
    rest = random.Random(seed).sample([i for i in within if i != longest],
                                      mix["checked_requests"] - 1)
    return sorted([longest] + rest)


def position_errors(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """(2, positions): each position's ``|got - want| / |want|`` over the
    vocabulary, and the gap by which ``want`` of ``got``'s first token
    lies below ``want``'s best; in blocks of rows."""
    s = want.shape[1]
    err, gap = [], []
    for r in range(0, s, ROWS):
        g, w = got[:, r:r + ROWS].float(), want[:, r:r + ROWS]
        err.append(torch.linalg.vector_norm(g - w, dim=-1)
                   / torch.linalg.vector_norm(w, dim=-1))
        first = torch.gather(w, -1, g.argmax(-1, keepdim=True))[..., 0]
        gap.append(w.amax(-1) - first)
    return torch.stack([torch.cat(err, dim=1).flatten(),
                        torch.cat(gap, dim=1).flatten()])


def compare(cell, errors: torch.Tensor) -> list:
    lim = cell.limits
    err, gap = errors
    return [harness.held("logit_err_median", float(err.median()),
                         lim.get("logit_err_median")),
            harness.held("logit_err_max", float(err.max()),
                         lim.get("logit_err_max")),
            harness.held("top_gap_max", float(gap.max()),
                         lim.get("top_gap_max"))]


def reference_errors(cell, w: dict, kept: dict, batches) -> torch.Tensor:
    """:func:`position_errors` of every kept request against the
    reference's logits of its prompt."""
    decoder.no_tf32()
    errs = []
    for out, idx in kept.values():
        want = decoder.forward(cell.config, w, batches[idx]["tokens"])
        if out.shape != want.shape:
            errs.append(torch.full((2, want.shape[0] * want.shape[1]),
                                   float("inf"), device=want.device))
        else:
            errs.append(position_errors(out, want))
        del want
    return torch.cat(errs, dim=1)


def timer(device):
    """(start, stop) of one request: CUDA events on the card, the host's
    clock elsewhere; ``stop`` waits for completion and returns ms."""
    if torch.device(device).type != "cuda":
        t = [0.0]

        def start():
            t[0] = time.perf_counter()

        def stop():
            return (time.perf_counter() - t[0]) * 1e3
        return start, stop
    events = []

    def start():
        events[:] = [torch.cuda.Event(enable_timing=True),
                     torch.cuda.Event(enable_timing=True)]
        events[0].record()

    def stop():
        events[1].record()
        events[1].synchronize()
        return events[0].elapsed_time(events[1])
    return start, stop


def program_step(cell):
    from repro_torch.train.step import make_prefill_step
    cfg = cell.config
    return make_prefill_step(harness.port_config(cfg),
                             harness.model_options(cfg, "prefill"))


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        fault=None) -> dict:
    mix = cell.traffic
    step = program_step(cell)
    if fault is not None:
        step = fault(step)
    w = weights.make(cell.config, seed, device)
    batches = traffic.pool(mix, cell.config, seed, device)
    for i in range(mix["warmup"]):
        step(w, batches[i % len(batches)])
    harness.synchronize(device)
    chosen = set(sample(mix, seed))
    begin, finish = timer(device)

    prof = tracing.profiler(mix) if trace else None
    latency, shapes, kept, done = [], [], {}, 0
    start = time.perf_counter()
    while True:
        if prof is not None:
            prof.at(done)
        idx = (mix["warmup"] + done) % len(batches)
        begin()
        out = step(w, batches[idx])
        latency.append(finish())
        shapes.append(traffic.shape(batches[idx]))
        if done in chosen:
            kept[done] = (out, idx)
        del out
        done += 1
        if (time.perf_counter() - start >= seconds and done > max(chosen)
                and (prof is None or prof.done(done))):
            break
    end = time.perf_counter()
    peak = harness.memory_peak(device)
    del step
    failed = sum(not bool(torch.isfinite(out).all()) for out, _ in
                 kept.values())
    checks = compare(cell, reference_errors(cell, w, kept, batches))
    info = harness.device_info(device, peak, cell.chips)
    if prof is None:
        tokens = sum(b * t for b, t in shapes)
        p90 = statistics.quantiles(latency, n=10, method="inclusive")[8] \
            if len(latency) > 1 else latency[0]
        metrics = {"prefill_tokens_per_s": {"value": tokens / (end - start),
                                            "unit": "tokens/s"},
                   "prefill_ms_p90": {"value": p90, "unit": "ms"},
                   "setup_s": {"value": start - t0, "unit": "s"}}
        return harness.result(cell, checks, done, failed, metrics, info)
    summary = prof.summary(shapes, end - start)
    info.update(busy_s=summary.busy_s, window_s=summary.window_s)
    return harness.result(cell, checks, done, failed,
                          harness.per_layer_metrics(cell, summary), info,
                          harness.breakdown_of(summary))

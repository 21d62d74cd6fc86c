"""Training traffic: a closed loop of whole optimizer steps.

Set-up builds the program's train step (``repro_torch.train.step.
make_train_step``) with its weights and optimizer state, and drives it
from the seed through the mix's ``warmup`` steps on distinct batches of
the pool; the first ``checked_steps`` of them are what the reference
follows. The same step, weights and state then run the window: whole
steps, each ended by a ``synchronize()``, until ``--seconds`` have
passed. ``train_tokens_per_s`` is the tokens of every step of the window
over the window's time.

Once the window has closed and the program's state is freed, the plain
float32 reference (``bench/reference``) takes the same weights (made
again from the seed) and batches through the checked steps, and three
numbers are compared, each by the worst of its readings:

* ``loss_gap``: each checked step's loss against the reference's,
  relative to the reference's;
* ``grad_norm_gap``: the first gradient as the optimizer got it (from
  its first moment after one step, ``mu / (1 - b1)``), leaf by leaf (a
  stacked leaf layer by layer): the gap of the two norms over the
  larger of the reference's norm of that leaf and of the median leaf;
* ``change_gap``: the parameters' change after the checked steps, as
  the next step gets them, measured likewise, over the leaves whose
  reference gradient is at least a thousandth of the median leaf's.
"""
from __future__ import annotations

import gc
import statistics
import sys
import time

import torch

from bench import harness, traffic, tracing, weights
from bench.reference import decoder

ADAMW_KEYS = ("lr", "b1", "b2", "eps", "weight_decay", "grad_clip",
              "warmup_steps", "total_steps", "min_lr_frac")
#: leaves whose reference gradient is under this share of the median
#: leaf's move by round-off alone and are left out of the change
STILL = 1e-3


def change_norms(cfg: dict, params: dict, seed: int, device) -> dict:
    """Norms of each leaf's change from the seed's weights (made again
    leaf by leaf), by :func:`decoder.leaf_norms`."""
    out = {}
    for path, shape in weights.paths(weights.shapes(cfg)):
        node = params
        for k in path.split("."):
            node = node[k]
        p0 = weights.make_leaf(cfg, path, shape, seed, device)
        out.update(decoder.leaf_norms({path: node.float() - p0.float()}))
        del p0
    return out


def worst_gap(got: dict, want: dict, leaves=None) -> float:
    """The largest ``|got - want|`` over the leaves, each over the larger
    of ``want`` of that leaf and of the median leaf."""
    names = sorted(leaves if leaves is not None else want)
    median = statistics.median(want[n] for n in names)
    return max(harness.relative_gap(got[n], want[n], max(want[n], median))
               for n in names)


def program_step(cell, device):
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.step import TrainConfig, make_train_step
    cfg = cell.config
    adam = opt_mod.AdamWConfig(**{k: cfg["optimizer"][k]
                                  for k in ADAMW_KEYS})
    step = make_train_step(harness.port_config(cfg),
                           harness.model_options(cfg, "train"),
                           TrainConfig(adamw=adam))
    return step, opt_mod.init


def readings(cell, seed: int, device, step, init, batches) -> dict:
    """Set-up's part of the comparison and the state it leaves: runs the
    program's ``warmup`` steps. Returns the program's readings and the
    weights and state the window goes on from."""
    cfg, mix = cell.config, cell.traffic
    b1 = cfg["optimizer"]["b1"]
    params = weights.make(cfg, seed, device)
    state = init(params)
    losses, first, change = [], None, None
    for i in range(mix["warmup"]):
        params, state, m = step(params, state, batches[i % len(batches)])
        if i < mix["checked_steps"]:
            losses.append(m["loss"])
        if i == 0:
            first = {k: v / (1 - b1) for k, v in
                     decoder.leaf_norms(state.mu).items()}
        if i == mix["checked_steps"] - 1:
            change = change_norms(cfg, params, seed, device)
    return {"losses": losses, "first": first, "change": change,
            "params": params, "state": state}


def reference(cell, seed: int, device, batches,
              num: decoder.Numerics = decoder.FP32) -> dict:
    """The reference's readings over the checked steps."""
    cfg, mix = cell.config, cell.traffic
    decoder.no_tf32()
    w = weights.make(cfg, seed, device)
    losses, first, raw = decoder.train(
        cfg, cfg["optimizer"], w, batches[:mix["checked_steps"]], num)
    change = change_norms(cfg, w, seed, device)
    del w
    return {"losses": losses, "first": first, "raw": raw, "change": change}


def compare(cell, got: dict, want: dict) -> list:
    losses = [float(x) for x in got["losses"]]
    loss_gap = max(harness.relative_gap(a, b, abs(b))
                   for a, b in zip(losses, want["losses"]))
    median = statistics.median(want["raw"].values())
    moving = [n for n, g in want["raw"].items() if g >= STILL * median]
    lim = cell.limits
    return [harness.held("loss_gap", loss_gap, lim["loss_gap"]),
            harness.held("grad_norm_gap", worst_gap(got["first"],
                                                    want["first"]),
                         lim["grad_norm_gap"]),
            harness.held("change_gap", worst_gap(got["change"],
                                                 want["change"], moving),
                         lim["change_gap"])]


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def steps_held(start: float, ends: list) -> None:
    """Print the window's step times to standard error: the shortest,
    the median and the longest, and the seconds by which the steps ran
    over the median, in all and in the three slowest (where a stall of
    the host shows)."""
    times = [b - a for a, b in zip([start] + ends, ends)]
    med = statistics.median(times)
    over = sorted((t - med for t in times if t > med), reverse=True)
    slowest = [round(o, 4) for o in over[:3]]
    print(f"window steps {len(times)}: s min {min(times):.4f} median "
          f"{med:.4f} max {max(times):.4f}; over the median "
          f"{sum(over):.4f} s, slowest three {slowest}", file=sys.stderr)


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        fault=None) -> dict:
    mix = cell.traffic
    step, init = program_step(cell, device)
    if fault is not None:
        step = fault(step)
    batches = traffic.pool(mix, cell.config, seed, device)
    got = readings(cell, seed, device, step, init, batches)
    params, state = got.pop("params"), got.pop("state")
    harness.synchronize(device)

    prof = tracing.profiler(mix) if trace else None
    losses, shapes, ends, done = [], [], [], 0
    start = time.perf_counter()
    while True:
        if prof is not None:
            prof.at(done)
        batch = batches[(mix["warmup"] + done) % len(batches)]
        params, state, m = step(params, state, batch)
        harness.synchronize(device)
        ends.append(time.perf_counter())
        losses.append(m["loss"])
        shapes.append(traffic.shape(batch))
        done += 1
        if ends[-1] - start >= seconds and (
                prof is None or prof.done(done)):
            break
    end = time.perf_counter()
    steps_held(start, ends)
    peak = harness.memory_peak(device)
    failed = sum(not bool(torch.isfinite(x)) for x in losses)
    del params, state, m, step
    free(device)

    checks = compare(cell, got, reference(cell, seed, device, batches))
    info = harness.device_info(device, peak, cell.chips)
    if prof is None:
        tokens = sum(b * t for b, t in shapes)
        metrics = {"train_tokens_per_s": {"value": tokens / (end - start),
                                          "unit": "tokens/s"},
                   "setup_s": {"value": start - t0, "unit": "s"}}
        return harness.result(cell, checks, done, failed, metrics, info)
    summary = prof.summary(shapes, end - start)
    info.update(busy_s=summary.busy_s, window_s=summary.window_s)
    return harness.result(cell, checks, done, failed,
                          harness.per_layer_metrics(cell, summary), info,
                          harness.breakdown_of(summary))

"""Fault-tolerance demo: checkpoint/restart + elastic re-planning.

Trains a tiny model on ``--device``, kills a "node" mid-run, restores
from the last checkpoint, re-plans the mesh for the surviving device
count with DistSim picking the new best strategy — the paper's §6
search applied to failure recovery.

    PYTHONPATH=src python -m repro_torch.examples.elastic_recovery \\
        [--device cpu]
"""
import argparse
import tempfile

from repro_torch.configs.base import get_config, smoke_config
from repro_torch.core import A40_CLUSTER, AnalyticalProvider
from repro_torch.core.device import DEFAULT_DEVICE
from repro_torch.train.fault_tolerance import (HeartbeatMonitor,
                                               replan_mesh,
                                               run_with_recovery)
from repro_torch.train.train_loop import LoopConfig, fit


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    cfg = smoke_config(get_config("qwen2_1_5b"))

    # --- phase 1: training with an injected failure -------------------
    with tempfile.TemporaryDirectory() as d:
        print("== training with a simulated failure at step 25 ==")
        state = {"last": 0}

        def step_fn(s):
            pass                                  # stand-in compute

        def save_fn(s):
            state["last"] = s

        def restore_fn():
            return state["last"]

        steps, recov = run_with_recovery(40, step_fn, save_fn, restore_fn,
                                         save_every=10, failure_at=25)
        print(f"completed {steps} steps with {recov} recovery "
              f"(≤10 steps re-executed)\n")

        # real checkpointed training (short)
        fit(cfg, loop=LoopConfig(steps=10, seq_len=32, global_batch=2,
                                 save_every=5, ckpt_dir=d),
            verbose=False, device=args.device)
        r2 = fit(cfg, loop=LoopConfig(steps=14, seq_len=32, global_batch=2,
                                      save_every=5, ckpt_dir=d),
                 verbose=False, device=args.device)
        print(f"real run: resumed from step {r2.resumed_from}, "
              f"loss {r2.losses[-1]:.3f}\n")

    # --- phase 2: elastic re-plan after losing nodes ------------------
    print("== elastic re-plan: 256 devices, 13 fail ==")
    monitor = HeartbeatMonitor(256, dead_after_s=10)
    for w in range(256):
        monitor.heartbeat(w, 1.0, now=0.0)
    for w in range(243):                          # 13 workers go silent
        monitor.heartbeat(w, 1.0, now=20.0)
    dead = monitor.mark_dead(now=25.0)    # detect (pure query) + transition
    print(f"dead workers: {len(dead)} → {monitor.alive_count()} survive")
    plan = replan_mesh(monitor.alive_count(), model_parallel=16)
    print(f"new mesh: data={plan.data} x model={plan.model} "
          f"({plan.devices} devices used)")

    # DistSim picks the best strategy for the new world size
    from repro_torch.search import ProfileCache, SearchEngine
    provider = AnalyticalProvider(A40_CLUSTER)
    engine = SearchEngine(get_config("bert_large"),
                          cache=ProfileCache.from_provider(provider),
                          prune=False, check_memory=False,
                          device=args.device)
    best = engine.search(plan.devices, 16, 512).best()
    print(f"DistSim re-planned strategy: {best.strategy.label()} "
          f"@ {best.iters_per_s:.2f} it/s")


if __name__ == "__main__":
    main()

"""Quickstart: model a hybrid distributed training strategy with DistSim.

One API surface: ``sim.simulate()`` is the zero-noise prediction,
``sim.simulate(seeds=...)`` the replay oracle; both return a
``SimBatch`` (``.result()`` unwraps a single lane). Last, the same
question goes to the strategy server, whose mega-batch runs on
``--device`` (the scan kernel on the card), and its answer must be the
prediction's bits.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse
import tempfile

from repro_torch.configs.base import get_config
from repro_torch.core import (A40_CLUSTER, AnalyticalProvider, DistSim,
                              Strategy, batch_time_error)
from repro_torch.core.device import DEFAULT_DEVICE
from repro_torch.store import ProfileStore, ServeQuery


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)

    cfg = get_config("bert_large")
    provider = AnalyticalProvider(A40_CLUSTER)

    # "2M2P4D": tensor-parallel 2, pipeline 2, data-parallel 4 (16 GPUs),
    # 4 microbatches, Dapple (1F1B) schedule
    strat = Strategy(mp=2, pp=2, dp=4, microbatches=4, schedule="1f1b")
    sim = DistSim(cfg, strat, global_batch=16, seq=512, provider=provider)

    pred = sim.simulate().result()
    print(f"strategy          : {strat.label()} x{strat.microbatches} micro")
    print(f"predicted batch   : {pred.batch_time*1e3:.2f} ms "
          f"({pred.throughput_iters:.2f} it/s, "
          f"{pred.throughput_tokens/1e6:.2f} Mtok/s)")
    print(f"pipeline bubbles  : {pred.bubble_fraction*100:.1f}% idle")

    # per-device utilization
    util = pred.utilization
    print("device utilization:",
          " ".join(f"{d}:{u*100:.0f}%" for d, u in sorted(util.items())[:8]),
          "...")

    # the replay oracle ("actual run" stand-in) confirms the prediction
    act = sim.simulate(seeds=0).result()
    err = batch_time_error(pred.timeline, act.timeline)
    print(f"replay batch      : {act.batch_time*1e3:.2f} ms "
          f"(prediction error {err*100:.2f}%)")

    # profiling cost (paper Table 3)
    rep = sim.profiling_report()
    print(f"profiling         : {rep['unique_events']} unique events vs "
          f"{rep['total_instances']} instances "
          f"→ {rep['relative_scale']*100:.1f}% of direct-profiling cost")

    # the strategy server answers the same question on --device
    with tempfile.TemporaryDirectory() as d:
        server = DistSim.serve(ProfileStore(d), clusters=[A40_CLUSTER],
                               device=args.device)
        ans = server.answer(ServeQuery("bert_large", strat, 16, 512,
                                       cluster=A40_CLUSTER.name))
    same = ans.batch_time == pred.batch_time
    print(f"server ({args.device})  : {ans.batch_time*1e3:.2f} ms "
          f"({'bit-identical' if same else 'DIFFERS'})")
    if not same:
        raise SystemExit(1)


if __name__ == "__main__":
    main()

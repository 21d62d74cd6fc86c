"""The whole step's or request's share of the card's bf16 peak, in %,
for ``mfu.<kind>``: the model FLOPs of the timed window's units that
ran with the profiler off (from ``bench.work``: a training step's 6·N·T
over the matmul parameters plus the attention's forward and backward; a
prefill's 2·N_active·T, the head on every position, plus the attention
forward) over their time on the host's clock, over 989 TFLOP/s. The
profiled units are left out: the profiler's own cost on the host slows
them."""
from bench import work


def read(s, cell):
    if not s.outside or s.outside_s <= 0:
        return None
    count = work.train_step_flops if cell.kind == "train" \
        else work.prefill_flops
    flops = sum(count(cell.config, b, t) for b, t in s.outside)
    return 100.0 * flops / s.outside_s / work.PEAK_BF16_FLOPS

"""Attention's share of its roofline, in %, for ``attn_roofline.<kind>``:
the least time the card could take for the attention work the profiled
steps or requests need (over the pairs the causal window keeps, from
``bench.work``; a training step's forward and backward, a prefill's
forward), summed request by request, over the device time inside the
``attention.fwd`` spans and, in training, the ``attention.bwd`` spans."""
from bench import work


def read(s, cell):
    train = cell.kind == "train"
    device_s = s.span_s.get("attention.fwd", 0.0) + s.span_s.get(
        "attention.bwd", 0.0)
    if device_s <= 0 or train and not s.span_count.get("attention.bwd"):
        return None
    cfg, bound = cell.config, 0.0
    for b, t in s.profiled:
        flops = work.attention_flops(cfg, b, t)
        nbytes = work.attention_bytes(cfg, b, t)
        if train:
            flops += work.attention_flops(cfg, b, t, backward=True)
            nbytes += work.attention_bytes(cfg, b, t, backward=True)
        bound += work.roofline_seconds(flops, nbytes)[0]
    return 100.0 * bound * cfg["n_layers"] / device_s

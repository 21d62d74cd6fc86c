"""Device milliseconds a step inside the optimizer's span
(``repro_torch.train.optimizer.update``)."""


def read(s, cell):
    if not s.span_count.get("optimizer.update"):
        return None
    return 1e3 * s.span_s["optimizer.update"] / s.units

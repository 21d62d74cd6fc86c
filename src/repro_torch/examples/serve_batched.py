"""Batched serving demo: continuous decode over a request batch.

Builds a reduced model, prefills each request's prompt through the
decode path, then generates with greedy sampling while tracking
per-token latency — the ``serve_step`` of the dry run's decode cells, at
smoke scale. Attention goes through the hand-written flash-attention
kernel (``attn_impl="cuda"``: K2 on the card, its plain version on CPU
tensors); the decode step itself attends over the cache.

    PYTHONPATH=src python -m repro_torch.examples.serve_batched \\
        --requests 4 --gen 32 [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config, smoke_config
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models.api import build_model
from repro_torch.models.layers import ModelOptions


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_1_5b")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = smoke_config(get_config(args.arch))
    opts = ModelOptions(dtype=torch.float32, remat=False, attn_impl="cuda")
    api = build_model(cfg, opts)
    gen = torch.Generator(dev).manual_seed(0)
    params = api.init(gen, dev)

    b = args.requests
    max_seq = args.prompt_len + args.gen
    prompts = torch.randint(1, cfg.vocab, (b, args.prompt_len),
                            generator=gen, device=dev, dtype=torch.int32)
    cache = api.init_cache(b, max_seq, dev)

    # the prompt through the model's forward (the flash-attention kernel)
    with torch.no_grad():
        first = api.forward(params, {"tokens": prompts})[:, -1]

    # prefill the cache token by token through the decode path (a
    # production server writes the cache from the prefill)
    t0 = time.perf_counter()
    logits = None
    for t in range(args.prompt_len):
        logits, cache = api.decode_step(params, cache,
                                        {"tokens": prompts[:, t:t + 1]})
    prefill_s = time.perf_counter() - t0
    agree = torch.allclose(logits, first, atol=2e-3, rtol=2e-3)

    # greedy generation
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    out = [tok]
    lat = []
    for _ in range(args.gen - 1):
        t0 = time.perf_counter()
        logits, cache = api.decode_step(params, cache, {"tokens": tok})
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        tok.cpu()
        lat.append(time.perf_counter() - t0)
        out.append(tok)

    tokens = torch.cat(out, dim=1).cpu().numpy()
    lat = np.array(lat) * 1e3
    print(f"arch={cfg.name} requests={b} prompt={args.prompt_len} "
          f"gen={args.gen} device={dev}")
    print(f"forward vs decode on the prompt's last token: "
          f"{'agree' if agree else 'DIFFER'} (2e-3)")
    print(f"prefill: {prefill_s*1e3:.1f} ms total")
    print(f"decode : p50={np.percentile(lat,50):.1f} ms/tok  "
          f"p99={np.percentile(lat,99):.1f} ms/tok  "
          f"throughput={b / (lat.mean()/1e3):.0f} tok/s")
    print("sample tokens:", tokens[0][:16])
    if not agree:
        raise SystemExit(1)


if __name__ == "__main__":
    main()

"""Deterministic synthetic LM data pipeline.

Production shape without external deps: seeded per-shard streams,
sharded batches (each DP rank materializes only its slice), background
prefetch, and exact mid-epoch resumability via (seed, step) — a restart
resumes the stream at the same position (required for checkpoint/restart
correctness; see tests/test_torch_data.py).

The token distribution is a Zipfian unigram mix with a deterministic
"grammar" (next-token depends on previous token) so the loss actually
decreases during the example runs.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    vocab: int = 32000
    seq_len: int = 512
    global_batch: int = 8
    shard_index: int = 0       # this host's DP shard
    shard_count: int = 1
    prefetch: int = 2


def _batch_rng(cfg: DataConfig, step: int) -> np.random.Generator:
    # independent stream per (seed, step, shard) → exact resumability
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.shard_index]))


def synth_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    rng = _batch_rng(cfg, step)
    b = cfg.global_batch // cfg.shard_count
    v = cfg.vocab
    # Zipf unigram + first-order "grammar": tok[t] ~ f(tok[t-1])
    base = rng.zipf(1.3, size=(b, cfg.seq_len)).astype(np.int64)
    toks = (base + 31 * np.roll(base, 1, axis=1)) % (v - 2) + 1
    tokens = toks.astype(np.int32)
    labels = np.roll(tokens, -1, axis=1).astype(np.int32)
    labels[:, -1] = -1                       # no target for last position
    return {"tokens": tokens, "labels": labels}


class DataLoader:
    """Background-prefetching iterator over synthetic batches."""

    def __init__(self, cfg: DataConfig, start_step: int = 0,
                 arch: Optional[ArchConfig] = None):
        self.cfg = cfg
        self.arch = arch
        self.step = start_step
        self._q: "queue.Queue" = queue.Queue(maxsize=cfg.prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _make(self, step: int) -> Dict[str, np.ndarray]:
        batch = synth_batch(self.cfg, step)
        if self.arch is not None and self.arch.vision_stub:
            b = batch["tokens"].shape[0]
            rng = _batch_rng(self.cfg, step)
            n_patch = min(64, self.cfg.seq_len // 2)
            batch["patch_embeds"] = rng.standard_normal(
                (b, n_patch, self.arch.d_model)).astype(np.float32)
        if self.arch is not None and self.arch.audio_stub:
            b = batch["tokens"].shape[0]
            rng = _batch_rng(self.cfg, step)
            batch["frame_embeds"] = rng.standard_normal(
                (b, self.cfg.seq_len, self.arch.d_model)
            ).astype(np.float32)
        elif self.arch is not None and self.arch.enc_dec:
            batch["tokens_enc"] = batch["tokens"][:, ::-1].copy()
        return batch

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            batch = self._make(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        step, batch = self._q.get()
        self.step = step + 1
        return step, batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)

"""Deterministic shard-aware synthetic LM data pipeline.

Properties a production input pipeline must have, implemented + tested here:
  * determinism: batch(step) is a pure function of (seed, step) — restart at
    step k reproduces the exact stream (required for checkpoint/restart);
  * shard-awareness: host i materializes only its slice of the global batch
    (``host_batch_slice``), no host ever holds the global array;
  * learnable structure: tokens follow a stationary bigram process, so a real
    model trained on it shows a decreasing loss (used by examples/train_lm).
  * prefetch: a small background double-buffer (thread) hides host latency.

Port of ``repro/data/pipeline.py``: numpy only, so batches are the
reference's bit for bit; the trainer moves them to the model's device.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0
    bigram_alpha: float = 0.9      # strength of the learnable structure


def _bigram_next_state(cfg: DataConfig):
    """Fixed random bigram table: next(v) = perm[v] with prob alpha."""
    rng = np.random.default_rng(cfg.seed + 0xB16)
    return rng.permutation(cfg.vocab_size)


def host_batch_slice(cfg: DataConfig, host_id: int, n_hosts: int) -> Tuple[int, int]:
    per = cfg.global_batch // n_hosts
    return host_id * per, per


def make_batch(cfg: DataConfig, step: int, host_id: int = 0,
               n_hosts: int = 1) -> Dict[str, np.ndarray]:
    """Pure function of (cfg, step, host): the host-local batch slice."""
    start, per = host_batch_slice(cfg, host_id, n_hosts)
    perm = _bigram_next_state(cfg)
    out_tok = np.empty((per, cfg.seq_len + 1), np.int32)
    for i in range(per):
        row_rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 131_071 + (start + i))
        toks = np.empty(cfg.seq_len + 1, np.int32)
        toks[0] = row_rng.integers(cfg.vocab_size)
        noise = row_rng.random(cfg.seq_len)
        rand_tok = row_rng.integers(cfg.vocab_size, size=cfg.seq_len)
        for t in range(cfg.seq_len):
            toks[t + 1] = perm[toks[t]] if noise[t] < cfg.bigram_alpha \
                else rand_tok[t]
        out_tok[i] = toks
    return {"tokens": out_tok[:, :-1], "labels": out_tok[:, 1:]}


class Prefetcher:
    """Double-buffered background batch producer."""

    def __init__(self, cfg: DataConfig, start_step: int = 0,
                 host_id: int = 0, n_hosts: int = 1, depth: int = 2):
        self.cfg = cfg
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def work():
            step = start_step
            while not self._stop.is_set():
                batch = make_batch(cfg, step, host_id, n_hosts)
                while not self._stop.is_set():
                    try:
                        self._q.put((step, batch), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                step += 1

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def __next__(self):
        return self._q.get()

    def __iter__(self) -> Iterator:
        return self

    def close(self):
        self._stop.set()

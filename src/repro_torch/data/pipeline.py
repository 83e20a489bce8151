"""Deterministic synthetic LM data pipeline (sharded, elastic-friendly).

Batches are a PURE FUNCTION of (seed, step): any host can materialize
its shard of any step independently — restart/elastic resize needs no
data-state checkpoint beyond the step counter.  A background prefetch
thread keeps `prefetch` steps ahead (host-side overlap).

The token stream is a mixture of Zipf-distributed unigrams with a
Markov bigram component — enough structure that a small LM's loss
visibly decreases (quickstart/e2e driver), while remaining fully
offline and dependency-free.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np


class SyntheticLMData:
    def __init__(self, *, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, host_index: int = 0, host_count: int = 1,
                 with_vision: int = 0, d_model: int = 0,
                 with_frames: int = 0):
        assert global_batch % host_count == 0
        self.vocab = vocab_size
        self.seq = seq_len
        self.local_batch = global_batch // host_count
        self.seed = seed
        self.host_index = host_index
        self.with_vision = with_vision
        self.with_frames = with_frames
        self.d_model = d_model
        # Fixed Markov structure (seeded independent of step).
        rng = np.random.default_rng(seed)
        self._succ = rng.integers(0, vocab_size, size=(vocab_size, 4))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 131 + self.host_index)
        b, s = self.local_batch, self.seq
        # Zipf unigrams restarted through the bigram table.
        base = rng.zipf(1.3, size=(b, s)).astype(np.int64) % self.vocab
        tokens = base.copy()
        follow = rng.random((b, s)) < 0.5
        choice = rng.integers(0, 4, size=(b, s))
        tokens[:, 1:] = np.where(
            follow[:, 1:],
            self._succ[tokens[:, :-1], choice[:, 1:]],
            base[:, 1:],
        )
        tokens = tokens.astype(np.int32)
        labels = np.roll(tokens, -1, axis=1)
        out = {"tokens": tokens, "labels": labels}
        if self.with_vision:
            out["vision_embeds"] = rng.standard_normal(
                (b, self.with_vision, self.d_model)).astype(np.float32) * 0.02
        if self.with_frames:
            out["frames"] = rng.standard_normal(
                (b, self.with_frames, self.d_model)).astype(np.float32) * 0.02
        return out

    def iterate(self, start_step: int = 0, prefetch: int = 2
                ) -> Iterator[Dict[str, np.ndarray]]:
        """Prefetching iterator from `start_step` (resume-friendly)."""
        q: "queue.Queue[Optional[Dict[str, np.ndarray]]]" = queue.Queue(prefetch)
        stop = threading.Event()

        def producer():
            step = start_step
            while not stop.is_set():
                try:
                    q.put(self.batch_at(step), timeout=0.5)
                    step += 1
                except queue.Full:
                    continue

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()

"""The one token generator every training traffic mix is read by.

A frozen copy of `repro_torch.data.pipeline.SyntheticLMData.batch_at`
(the port's generator: Zipf unigrams restarted through a fixed bigram
table, so some tokens are far more frequent than others and an MoE
router does not see uniform inputs), with its constants made parameters
of the mix:

    {"batch": rows a step, "seq": tokens a row, "zipf": the exponent,
     "follow": the share of tokens drawn from the bigram table,
     "successors": successors a token has in the table}

A batch is a pure function of (seed, step): the same seed gives the same
rows, and every step's rows differ.  The generator runs on the host in
NumPy, as the port's does; the driver copies each batch to the card.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np


class TokenTraffic:
    def __init__(self, mix: Dict[str, Any], vocab: int, seed: int):
        self.batch = int(mix["batch"])
        self.seq = int(mix["seq"])
        self.zipf = float(mix["zipf"])
        self.follow = float(mix["follow"])
        self.vocab = int(vocab)
        self.seed = int(seed)
        rng = np.random.default_rng(self.seed)
        self._succ = rng.integers(0, vocab, size=(vocab, int(mix["successors"])))

    @property
    def tokens_per_step(self) -> int:
        return self.batch * self.seq

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """{"tokens", "labels"}: (batch, seq) int32; labels are the tokens
        shifted left by one, the last wrapping round (as the port's)."""
        rng = np.random.default_rng((self.seed * 1_000_003 + step) * 131)
        b, s = self.batch, self.seq
        base = rng.zipf(self.zipf, size=(b, s)).astype(np.int64) % self.vocab
        tokens = base.copy()
        follow = rng.random((b, s)) < self.follow
        choice = rng.integers(0, self._succ.shape[1], size=(b, s))
        tokens[:, 1:] = np.where(follow[:, 1:],
                                 self._succ[tokens[:, :-1], choice[:, 1:]],
                                 base[:, 1:])
        tokens = tokens.astype(np.int32)
        return {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}

"""Synthetic token pipeline: deterministic and restartable, numpy only.

The port of ``repro.data.tokens.TokenPipeline``: an order-2
additive-congruential stream with zipfian noise,
``t_{i+1} = (a·t_i + b·t_{i-1} + ξ) mod V``, content-addressed by step, so
the same ``(seed, step)`` gives the same batch in both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0

    def make_batch(self, step: int) -> dict:
        """``{"tokens", "labels"}`` (batch, seq_len) int32 for ``step``."""
        rng = np.random.default_rng((self.seed << 20) ^ step)
        v = self.vocab_size
        a = 31 + (step % 7)
        b = 17
        t = np.empty((self.batch, self.seq_len + 1), np.int32)
        t[:, 0] = rng.integers(0, v, self.batch)
        t[:, 1] = rng.integers(0, v, self.batch)
        noise = (rng.zipf(2.0, (self.batch, self.seq_len + 1)) - 1) % v
        for i in range(2, self.seq_len + 1):
            t[:, i] = (a * t[:, i - 1] + b * t[:, i - 2] + noise[:, i]) % v
        return {"tokens": t[:, :-1], "labels": t[:, 1:].astype(np.int32)}

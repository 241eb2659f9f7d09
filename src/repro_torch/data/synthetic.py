"""Synthetic prompts: the order-2 Markov LM of ``repro.data.synthetic``
(pure numpy, same seeds give the same tokens)."""
from __future__ import annotations

import numpy as np


class MarkovLM:
    """Order-2 Markov chain over ``vocab`` symbols."""

    def __init__(self, vocab: int = 64, *, seed: int = 0,
                 temperature: float = 0.3):
        rng = np.random.default_rng(seed)
        logits = rng.normal(size=(vocab, vocab, vocab)) / max(temperature, 1e-3)
        z = logits - logits.max(-1, keepdims=True)
        p = np.exp(z)
        self.trans = p / p.sum(-1, keepdims=True)
        self.vocab = vocab

    def sample(self, rng: np.random.Generator, batch: int,
               seq_len: int) -> np.ndarray:
        toks = np.zeros((batch, seq_len), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, batch)
        toks[:, 1] = rng.integers(0, self.vocab, batch)
        for t in range(2, seq_len):
            p = self.trans[toks[:, t - 2], toks[:, t - 1]]
            cum = np.cumsum(p, axis=-1)
            u = rng.random((batch, 1))
            toks[:, t] = (u < cum).argmax(-1)
        return toks

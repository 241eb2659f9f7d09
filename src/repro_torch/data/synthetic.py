"""Synthetic tasks of ``repro.data.synthetic`` (pure numpy, the same seeds
give the same arrays): the order-2 Markov LM, and the seq2seq tasks
``CipherMT`` and ``PhraseMT`` the MT model trains on."""
from __future__ import annotations

from typing import Dict, Iterator

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

    def batches(self, *, batch: int, seq_len: int, seed: int = 0
                ) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(seed)
        while True:
            yield {"tokens": self.sample(rng, batch, seq_len)}


def _pair_batches(task, batch: int, src_len: int, seed: int
                  ) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    while True:
        src, tgt = task.make_pair(rng, batch, src_len)
        yield {"src": src, "tgt": tgt}


class CipherMT:
    """Target = reversed source mapped through a fixed permutation cipher
    (token 0 is reserved for BOS / PAD)."""

    def __init__(self, vocab: int = 64, *, seed: int = 0, reverse: bool = True):
        rng = np.random.default_rng(seed)
        perm = rng.permutation(np.arange(1, vocab))
        self.cipher = np.concatenate([[0], perm]).astype(np.int32)
        self.vocab = vocab
        self.reverse = reverse

    def make_pair(self, rng: np.random.Generator, batch: int, src_len: int):
        src = rng.integers(1, self.vocab, (batch, src_len)).astype(np.int32)
        tgt = self.cipher[src]
        if self.reverse:
            tgt = tgt[:, ::-1]
        return src, np.ascontiguousarray(tgt)

    def batches(self, *, batch: int, src_len: int, seed: int = 0
                ) -> Iterator[Dict[str, np.ndarray]]:
        return _pair_batches(self, batch, src_len, seed)


class PhraseMT:
    """Each source token expands into a fixed ``expand``-token target
    phrase: continuations inside a phrase are predictable from the
    decoder's own context, phrase boundaries need the source (the
    structure that lets the paper's MT heads accept blocks)."""

    def __init__(self, vocab: int = 64, *, expand: int = 2, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.table = rng.integers(1, vocab, (vocab, expand)).astype(np.int32)
        self.vocab = vocab
        self.expand = expand
        self.reverse = False

    def make_pair(self, rng: np.random.Generator, batch: int, src_len: int):
        src = rng.integers(1, self.vocab, (batch, src_len)).astype(np.int32)
        tgt = self.table[src].reshape(batch, src_len * self.expand)
        return src, np.ascontiguousarray(tgt)

    def gold(self, src: np.ndarray) -> np.ndarray:
        return self.table[src].reshape(src.shape[0], -1)

    def batches(self, *, batch: int, src_len: int, seed: int = 0
                ) -> Iterator[Dict[str, np.ndarray]]:
        return _pair_batches(self, batch, src_len, seed)

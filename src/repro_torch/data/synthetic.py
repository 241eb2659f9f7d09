"""Synthetic tasks of ``repro.data.synthetic`` (pure numpy, the same seeds
give the same arrays): the order-2 Markov LM; the seq2seq tasks
``CipherMT`` and ``PhraseMT`` the MT model trains on; and the ordinal
("super-resolution") data of the paper's image setting: ``OrdinalCurves``
(1-D smooth curves quantized to ``levels`` tokens) and ``OrdinalField``
(2-D smooth fields, serialized row-major or in the locality-aware
progressive-lattice order of ``locality_plan`` that the ``locality`` decode
policy consumes); and ``MaskedFrames``, the frame embeddings and codebook
targets of hubert-style masked prediction."""
from __future__ import annotations

from typing import Dict, Iterator, Optional

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


# ---------------------------------------------------------------------------
# Ordinal ("super-resolution") sequences
# ---------------------------------------------------------------------------


class OrdinalCurves:
    """Token sequences quantizing smooth random curves into [0, levels)."""

    def __init__(self, levels: int = 256, *, n_waves: int = 3, seed: int = 0):
        self.levels = levels
        self.n_waves = n_waves

    def sample(self, rng: np.random.Generator, batch: int,
               seq_len: int) -> np.ndarray:
        t = np.linspace(0, 1, seq_len)[None, :]
        y = np.zeros((batch, seq_len))
        for _ in range(self.n_waves):
            freq = rng.uniform(0.5, 4.0, (batch, 1))
            phase = rng.uniform(0, 2 * np.pi, (batch, 1))
            amp = rng.uniform(0.2, 1.0, (batch, 1))
            y += amp * np.sin(2 * np.pi * freq * t + phase)
        y = y - y.min(1, keepdims=True)
        y = y / np.maximum(y.max(1, keepdims=True), 1e-9)
        return np.clip((y * (self.levels - 1)).round(), 0,
                       self.levels - 1).astype(np.int32)

    def batches(self, *, batch: int, seq_len: int, seed: int = 0
                ) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(seed)
        while True:
            yield {"tokens": self.sample(rng, batch, seq_len)}


# ---------------------------------------------------------------------------
# 2-D ordinal fields + the locality-aware generation order
# ---------------------------------------------------------------------------


def _locality_parents(y, x, off_y, off_x, half, height, width):
    """Committed-lattice neighbour pair of a refinement-class position."""
    if off_y and off_x:            # (half, half): diagonal lattice parents
        cands = [(y - half, x - half), (y - half, x + half),
                 (y + half, x - half), (y + half, x + half)]
    elif off_y:                    # (half, 0): vertical lattice parents
        cands = [(y - half, x), (y + half, x)]
    else:                          # (0, half): horizontal lattice parents
        cands = [(y, x - half), (y, x + half)]
    ok = [(a, b) for a, b in cands if 0 <= a < height and 0 <= b < width]
    if not ok:
        ok = [(y, x)]
    if len(ok) == 1:
        ok = ok * 2
    return ok[0], ok[1]


def locality_plan(height: int, width: int, stride: int):
    """Progressive-lattice generation order of an (height, width) raster
    (arXiv:2507.01957-style), plus the tables the ``locality`` policy
    drafts from.

    Phase 0 emits the coarse lattice (y % stride == 0 and x % stride == 0)
    in raster order; each refinement level ``cur = stride, stride/2, …, 2``
    then emits three offset classes, (half, half), (half, 0) and
    (0, half) with ``half = cur // 2``, each in raster order.  Within a
    class consecutive positions are >= 2 apart in both axes, so a block cut
    inside one class is spatially non-adjacent, and every class member has
    committed lattice neighbours to interpolate from.

    Returns ``(order, boundaries, n1, n2)``, int32: the raster index of
    each generation slot (H*W,); the class-end offsets into the order
    (``boundaries[0]`` is the coarse prefix length); and the GENERATION
    indices of the two committed neighbours each position interpolates
    between (H*W,) (coarse positions extrapolate from their up / left
    lattice neighbours).
    """
    if stride < 1 or (stride & (stride - 1)):
        raise ValueError(
            f"locality stride must be a power of two >= 1, got {stride}")
    gen_of = np.full((height, width), -1, np.int64)
    order, boundaries, n1, n2 = [], [], [], []

    def emit(step, off_y, off_x, half):
        for y in range(off_y, height, step):
            for x in range(off_x, width, step):
                if gen_of[y, x] >= 0:
                    continue
                g = len(order)
                gen_of[y, x] = g
                order.append(y * width + x)
                if half == 0:      # coarse lattice: extrapolate up / left
                    up = gen_of[y - step, x] if y >= step else g
                    left = gen_of[y, x - step] if x >= step else g
                    a = up if up != g else left
                    b = left if left != g else a
                    n1.append(max(int(a) if a != g else g - 1, 0))
                    n2.append(max(int(b) if b != g else g - 1, 0))
                else:
                    (ay, ax), (by, bx) = _locality_parents(
                        y, x, off_y, off_x, half, height, width)
                    n1.append(max(int(gen_of[ay, ax]), 0))
                    n2.append(max(int(gen_of[by, bx]), 0))
        boundaries.append(len(order))

    emit(stride, 0, 0, 0)                       # coarse lattice, raster
    cur = stride
    while cur > 1:
        half = cur // 2
        for off_y, off_x in ((half, half), (half, 0), (0, half)):
            emit(cur, off_y, off_x, half)
        cur = half
    return (np.asarray(order, np.int32), np.asarray(boundaries, np.int32),
            np.asarray(n1, np.int32), np.asarray(n2, np.int32))


def locality_order(height: int, width: int, stride: int):
    """(order, boundaries) of ``locality_plan``."""
    order, boundaries, _, _ = locality_plan(height, width, stride)
    return order, boundaries


class OrdinalField:
    """2-D smooth integer fields: sums of low-frequency 2-D sinusoids
    quantized to [0, levels).  ``order`` serializes the (H, W) grid as
    ``"raster"`` (row-major) or ``"locality"`` (``locality_plan``'s
    progressive lattice, the training stream of the ``locality`` policy).
    ``bilinear=True`` samples the waves on the stride lattice only and
    upsamples bilinearly before quantizing, so every refinement position
    is the midpoint of its lattice parents up to quantization.
    """

    def __init__(self, levels: int = 32, height: int = 16, width: int = 16,
                 *, n_waves: int = 3, stride: int = 4, order: str = "raster",
                 bilinear: bool = False, seed: int = 0):
        if order not in ("raster", "locality"):
            raise ValueError(
                f"OrdinalField order must be 'raster' or 'locality', "
                f"got {order!r}")
        self.levels, self.height, self.width = levels, height, width
        self.n_waves, self.stride, self.order_name = n_waves, stride, order
        self.bilinear = bilinear
        ord_idx, bounds, _, _ = locality_plan(height, width, stride)
        self.gen_index = ord_idx                # generation slot -> raster
        self.boundaries = bounds
        self.coarse_len = int(bounds[0])
        inv = np.empty(ord_idx.size, np.int64)
        inv[ord_idx] = np.arange(ord_idx.size)
        self.raster_index = inv                 # raster -> generation slot

    def _waves(self, rng: np.random.Generator, batch: int,
               ys: np.ndarray, xs: np.ndarray) -> np.ndarray:
        yy = (ys / max(self.height - 1, 1))[None, :, None]
        xx = (xs / max(self.width - 1, 1))[None, None, :]
        z = np.zeros((batch, ys.size, xs.size))
        # bilinear fields keep variation between lattice knots: the band
        # spans about one knot-to-knot period at the default stride
        lo, hi = (0.35, 1.05) if self.bilinear else (0.3, 1.2)
        for _ in range(self.n_waves):
            fy = rng.uniform(lo, hi, (batch, 1, 1))
            fx = rng.uniform(lo, hi, (batch, 1, 1))
            phase = rng.uniform(0, 2 * np.pi, (batch, 1, 1))
            amp = rng.uniform(0.3, 1.0, (batch, 1, 1))
            z += amp * np.sin(2 * np.pi * (fy * yy + fx * xx) + phase)
        return z

    def sample_grid(self, rng: np.random.Generator, batch: int) -> np.ndarray:
        if self.bilinear:
            # waves on the stride lattice -> bilinear upsample (edge clamp
            # past the last knot) -> quantize
            s = self.stride
            ly = np.arange(0, self.height, s)
            lx = np.arange(0, self.width, s)
            z = self._waves(rng, batch, ly, lx)
            fy = np.minimum(np.arange(self.height) / s, ly.size - 1)
            fx = np.minimum(np.arange(self.width) / s, lx.size - 1)
            y0 = np.floor(fy).astype(int)
            y1 = np.minimum(y0 + 1, ly.size - 1)
            x0 = np.floor(fx).astype(int)
            x1 = np.minimum(x0 + 1, lx.size - 1)
            wy = (fy - y0)[None, :, None]
            wx = (fx - x0)[None, None, :]
            z = ((1 - wy) * (1 - wx) * z[:, y0][:, :, x0]
                 + (1 - wy) * wx * z[:, y0][:, :, x1]
                 + wy * (1 - wx) * z[:, y1][:, :, x0]
                 + wy * wx * z[:, y1][:, :, x1])
        else:
            z = self._waves(rng, batch, np.arange(self.height),
                            np.arange(self.width))
        z = z - z.min((1, 2), keepdims=True)
        z = z / np.maximum(z.max((1, 2), keepdims=True), 1e-9)
        return np.clip((z * (self.levels - 1)).round(), 0,
                       self.levels - 1).astype(np.int32)

    def serialize(self, grid: np.ndarray) -> np.ndarray:
        flat = grid.reshape(grid.shape[0], -1)
        if self.order_name == "locality":
            return np.ascontiguousarray(flat[:, self.gen_index])
        return flat

    def to_grid(self, tokens: np.ndarray) -> np.ndarray:
        """Invert ``serialize``: token stream(s) back to (B, H, W)."""
        toks = np.asarray(tokens)[:, :self.height * self.width]
        if self.order_name == "locality":
            toks = toks[:, self.raster_index]
        return toks.reshape(-1, self.height, self.width)

    def sample(self, rng: np.random.Generator, batch: int,
               seq_len: Optional[int] = None) -> np.ndarray:
        toks = self.serialize(self.sample_grid(rng, batch))
        return toks if seq_len is None else toks[:, :seq_len]

    def batches(self, *, batch: int, seq_len: Optional[int] = None,
                seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(seed)
        while True:
            yield {"tokens": self.sample(rng, batch, seq_len)}


# ---------------------------------------------------------------------------
# Masked audio frames (hubert-style)
# ---------------------------------------------------------------------------


class MaskedFrames:
    """Frame embeddings whose codebook id is a function of the frame, so the
    masked-prediction task is learnable: embedding = codeword + small
    noise, target = the codeword's index; spans of ``span`` frames from
    ``mask_prob`` · S random starts per row are masked."""

    def __init__(self, d_model: int, codebook: int = 504, *, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.codebook = rng.normal(size=(codebook, d_model)).astype(np.float32)
        self.nc = codebook
        self.d = d_model

    def sample(self, rng: np.random.Generator, batch: int, seq_len: int,
               *, mask_prob: float = 0.08, span: int = 10):
        ids = rng.integers(0, self.nc, (batch, seq_len))
        emb = self.codebook[ids] + 0.1 * rng.normal(
            size=(batch, seq_len, self.d)).astype(np.float32)
        mask = np.zeros((batch, seq_len), bool)
        n_starts = max(1, int(mask_prob * seq_len))
        for b in range(batch):
            starts = rng.integers(0, max(seq_len - span, 1), n_starts)
            for s in starts:
                mask[b, s:s + span] = True
        return {"frame_embeds": emb.astype(np.float32),
                "mask": mask, "targets": ids.astype(np.int32)}

    def batches(self, *, batch: int, seq_len: int, seed: int = 0, **kw
                ) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(seed)
        while True:
            yield self.sample(rng, batch, seq_len, **kw)

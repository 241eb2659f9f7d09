#!/usr/bin/env python3
"""How far fp32-level noise in the wkv scan's output moves each gradient of
one RWKV-6 training step, on the CPU.

    PYTHONPATH=src python tools/rwkv6_grad_noise.py [--eps 1e-7 1e-6]

``chip_smoke.py`` phase 21a holds one ``make_train_step`` on the card to
the same step on the CPU.  The card's scan (the chunked closed form on
TF32 tensor cores split three ways) leaves y about 6e-7 of its max from
the sequential plain recurrence; this tool asks what such a difference does
downstream.  It runs 21a's step (rwkv6-1.6b at d 256, 4 heads of 64, 2
layers, d_ff 512, vocab 1024; B 2 x S 64 MarkovLM, head 2, fine-tuned)
twice on the CPU: once as is, once with every scan's y multiplied by
1 + eps·N(0, 1).  It prints, for each eps, the leaves whose gradients move
most against TRAIN_TOL (rtol 1e-4, atol 1e-5 of the leaf's max), each
with its largest change as a fraction of the leaf's max.  u's gradient,
sum over every position of r k (dy · v), is a sum of terms that largely
cancel, so it moves by far the most.  About 20 s.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

import repro_torch.kernels.rwkv6_scan as scan_mod
from repro_torch.config import TrainConfig, get_config
from repro_torch.data.synthetic import MarkovLM
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as M
from repro_torch.optim import optimizer_init
from repro_torch.utils.tree import flatten_with_names


def gradients(cfg, batch, swap, eps: float):
    """The gradients of one fine-tuned step, each scan's y perturbed by a
    relative ``eps`` (seeded)."""
    plain = scan_mod.rwkv6_scan_plain
    gen = torch.Generator().manual_seed(5)

    def noisy(*args, **kw):
        y, *rest = plain(*args, **kw)
        return (y * (1 + eps * torch.randn(y.shape, generator=gen)), *rest)

    scan_mod.rwkv6_scan_plain = noisy
    try:
        tc = TrainConfig(lr=1e-4, warmup_steps=1)
        params = M.init(cfg, seed=0, device="cpu")
        make_train_step(cfg, tc)(params, optimizer_init(params, tc), batch,
                                 None, head_idx=2, swap=swap)
    finally:
        scan_mod.rwkv6_scan_plain = plain
    return {n: p.grad.clone() for n, p in flatten_with_names(params)
            if p.grad is not None}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--eps", type=float, nargs="+", default=[1e-7, 1e-6])
    ap.add_argument("--top", type=int, default=6)
    args = ap.parse_args()
    torch.set_num_threads(4)
    cfg = get_config("rwkv6-1.6b").replace(
        num_layers=2, d_model=256, rwkv_head_dim=64, d_ff=512, vocab_size=1024,
        dtype="float32")
    tokens = MarkovLM(vocab=256, temperature=0.2, seed=0).sample(
        np.random.default_rng(2), 2, 64)
    batch = {"tokens": torch.as_tensor(tokens)}
    swap = torch.as_tensor(np.random.default_rng(3).random((2, 64)) < 0.5)
    base = gradients(cfg, batch, swap, 0.0)
    for eps in args.eps:
        moved = gradients(cfg, batch, swap, eps)
        rows = []
        for name, g in base.items():
            diff = (moved[name] - g).abs()
            top = float(g.abs().max())
            tol = 1e-5 * top + 1e-4 * g.abs()
            rows.append((float((diff / tol.clamp(min=1e-30)).max()), name,
                         float(diff.max()) / top))
        print(f"y x (1 + {eps:g} N(0, 1)): the {args.top} gradients that move "
              f"most (share of TRAIN_TOL; largest change / the leaf's max)")
        for share, name, rel in sorted(rows)[-args.top:][::-1]:
            print(f"    {name:24s} {share:8.3f}   {rel:.3g}")


if __name__ == "__main__":
    main()

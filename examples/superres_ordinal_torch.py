"""Ordinal-sequence ("image super-resolution") driver on the PyTorch port —
paper §7.2: distance-based approximate acceptance (§5.2) on an output space
with a natural metric.

The twin of ``examples/superres_ordinal.py`` through ``repro_torch`` alone.
The default mode trains a combined model on smooth curves quantized to
integer levels and compares exact-match with ε-distance acceptance: the
approximate criterion accepts longer blocks at a small reconstruction
error (the paper's Table 2 effect).  ``--grid`` runs the 2-D variant
(arXiv:2507.01957-style locality-aware image decoding): a model trained on
smooth ordinal fields serialized in the progressive-lattice order decodes
with the ``locality`` policy (committed-neighbour interpolation drafts,
class-boundary block schedule) against heads-drafted ``exact``: the same
tokens, fewer iterations.  It runs on the card unless ``--device cpu`` is
given.

    PYTHONPATH=src python examples/superres_ordinal_torch.py [--k 8] [--quick] [--device cpu]
    PYTHONPATH=src python examples/superres_ordinal_torch.py --grid [--quick] [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import DecodeConfig, ModelConfig, TrainConfig
from repro_torch.core import decode as D
from repro_torch.core.heads import heads_init
from repro_torch.data.synthetic import OrdinalCurves, OrdinalField
from repro_torch.launch import steps as steps_lib
from repro_torch.models import model as M
from repro_torch.optim import freeze_mask, optimizer_init

LEVELS, SEQ, PROMPT = 64, 64, 16


def train_model(cfg, tc, gen, steps, dev, *, params=None, data_seed=1,
                mask=None):
    if params is None:
        params = M.init(cfg, seed=0, device=dev)
    opt = optimizer_init(params, tc, mask)
    step = steps_lib.make_train_step(cfg, tc, mask=mask)
    draws = torch.Generator().manual_seed(data_seed)
    for i in range(steps):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in next(gen).items()}
        params, opt, metrics = step(params, opt, batch, draws)
        if (i + 1) % max(steps // 4, 1) == 0:
            print(f"    step {i + 1:4d}  loss {float(metrics['loss']):.3f}")
    return params


def run_curves(args, steps, dev):
    cfg = ModelConfig(name="superres", num_layers=2, d_model=96, num_heads=4,
                      num_kv_heads=4, d_ff=192, vocab_size=LEVELS,
                      bpd_k=args.k, max_seq_len=256, dtype="float32")
    tc = TrainConfig(global_batch=16, seq_len=SEQ, lr=3e-3,
                     warmup_steps=max(steps // 10, 10), head_loss="mean")
    task = OrdinalCurves(levels=LEVELS, seed=0)

    print(f"[1/2] training (k={args.k}, {steps} steps) on {dev} ...")
    params = train_model(cfg, tc, task.batches(batch=16, seq_len=SEQ, seed=1),
                         steps, dev)

    print(f"[2/2] decoding {SEQ - PROMPT} levels from {PROMPT}-level prompts")
    full = task.sample(np.random.default_rng(42), 8, SEQ)
    batch = {"tokens": torch.as_tensor(full[:, :PROMPT], device=dev)}
    rows = []
    for crit, eps in (("exact", 0.0), ("distance", args.epsilon)):
        dec = DecodeConfig(max_new_tokens=SEQ - PROMPT, block_k=args.k,
                           policy=crit, epsilon=eps)
        toks, stats = D.bpd_decode(params, cfg, dec, batch)
        pred = toks[:, PROMPT:SEQ].cpu().numpy().astype(int)
        mae = np.abs(pred - full[:, PROMPT:].astype(int)).mean()
        rows.append((crit, eps, stats["mean_accepted"], stats["iterations"],
                     mae))

    print(f"\n    {'criterion':12s} {'eps':>4s} {'mean k̂':>8s} "
          f"{'iters':>6s} {'MAE':>6s}")
    for crit, eps, khat, iters, mae in rows:
        print(f"    {crit:12s} {eps:4.1f} {khat:8.2f} {iters:6d} {mae:6.2f}")
    print("\n    (distance-based acceptance trades a small MAE increase for "
          "fewer decoding iterations — the paper's Table 2 effect)")


def run_grid(args, steps, dev):
    # piecewise-bilinear fields: every refinement position is the average
    # of its committed parents, so interpolation drafts pay off once the
    # base has fit the fields (the two-phase recipe of the reference's
    # example)
    H = W = 8
    stride, levels = 2, 16
    field = OrdinalField(levels=levels, height=H, width=W, stride=stride,
                         order="locality", bilinear=True, seed=0)
    cfg0 = ModelConfig(name="superres-grid", num_layers=2, d_model=96,
                       num_heads=4, num_kv_heads=4, d_ff=192,
                       vocab_size=levels, bpd_k=args.k, bpd_enabled=False,
                       max_seq_len=128, dtype="float32")
    tc = TrainConfig(global_batch=16, seq_len=H * W, lr=3e-3,
                     warmup_steps=max(steps // 10, 10), head_loss="mean")

    print(f"[1/3] pretraining the base on {H}x{W} bilinear ordinal fields, "
          f"locality order ({steps} steps) on {dev} ...")
    params = train_model(cfg0, tc, field.batches(batch=16, seed=1), steps, dev)

    head_steps = max(steps // 3, 50)
    print(f"[2/3] attaching k={args.k} heads, frozen-base fine-tune "
          f"({head_steps} steps) ...")
    cfg = cfg0.replace(bpd_enabled=True, bpd_k=args.k)
    gen = torch.Generator(device=dev).manual_seed(7)
    params.add_module("bpd_heads", M.ParamTree(heads_init(
        gen, cfg, dtype=cfg.params_dtype, device=dev)))
    tc1 = tc.replace(warmup_steps=max(head_steps // 10, 10), freeze_base=True)
    params = train_model(cfg, tc1, field.batches(batch=16, seed=2),
                         head_steps, dev, params=params, data_seed=3,
                         mask=freeze_mask(params, train_only_heads=True))

    grids = field.sample_grid(np.random.default_rng(42), 8)
    stream = field.serialize(grids)
    batch = {"tokens": torch.as_tensor(stream[:, :field.coarse_len],
                                       device=dev)}
    n = H * W
    dec = DecodeConfig(max_new_tokens=n - field.coarse_len, block_k=args.k,
                       image_height=H, image_width=W, locality_stride=stride)
    print(f"[3/3] decoding {n - field.coarse_len} pixels from the "
          f"{field.coarse_len}-pixel coarse lattice")
    rows, toks_by = [], {}
    for name in ("exact", "locality"):
        toks, stats = D.bpd_decode(params, cfg, dec, batch, policy=name)
        toks_by[name] = toks[:, :n].cpu().numpy()
        mae = np.abs(field.to_grid(toks_by[name]).astype(int)
                     - grids.astype(int)).mean()
        rows.append((name, stats["mean_accepted"], stats["iterations"], mae))

    assert np.array_equal(toks_by["exact"], toks_by["locality"]), \
        "locality must be token-identical to exact (lossless drafting)"
    print(f"\n    {'policy':12s} {'mean k̂':>8s} {'iters':>6s} {'MAE':>6s}")
    for name, khat, iters, mae in rows:
        print(f"    {name:12s} {khat:8.2f} {iters:6d} {mae:6.2f}")
    print("\n    (same tokens — exact acceptance is lossless — but "
          "committed-neighbour interpolation drafts verify in fewer "
          "iterations than the heads' raster extrapolation)")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--epsilon", type=float, default=2.0)
    ap.add_argument("--grid", action="store_true",
                    help="2-D locality-aware image decoding instead of the "
                         "1-D curve comparison")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    if args.grid:
        run_grid(args, 800 if args.quick else 1500, dev)
    else:
        run_curves(args, 200 if args.quick else 800, dev)


if __name__ == "__main__":
    main()

"""Training launcher (``repro.launch.train`` on one card).

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \
        --device cpu --steps 20 --batch 8 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train --arch paper-mt-base \
        --full-config --steps 200 --ckpt-dir /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \
        --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \
        --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \
        --device cpu --steps 20 --ckpt-dir /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --arch llava-next-34b \
        --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch hubert-xlarge \
        --device cpu --steps 20

Without ``--full-config`` the registered smoke config trains, as the
reference's launcher trains it; with it the full config.  Both train in
fp32.  ``--device`` defaults to ``cuda``.  The data is the synthetic task
of the arch (``data_for``), made on a background thread
(``data.pipeline.prefetch``).  With ``--ckpt-dir`` the run resumes from the
directory's latest step and saves every ``--ckpt-every`` steps and at the
end; the optimizer state starts afresh on a resume, as the reference's
does.  Metrics are read on the host every ``--log-every`` steps only; an
MoE arch (olmoe-1b-7b, qwen2-moe-a2.7b) also logs its router terms and the
share of assignments dropped past capacity.  hymba-1.5b trains through
autograd over its Mamba scan, on ``--seq`` text tokens after its meta
tokens.  rwkv6-1.6b trains on MarkovLM through its prefill scan's
autograd.Function (``kernels.rwkv6_scan.RWKV6Scan``: on the card the CUDA
scan with checkpoints every 16 steps and the CUDA reverse scan).
llava-next-34b trains on ``--seq`` text tokens behind 4 zero patch
embeddings, as the reference's launcher feeds it; hubert-xlarge on
``MaskedFrames`` (masked prediction over a codebook of min(vocab, 504)).
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import latest_step, restore, save
from repro_torch.config import TrainConfig, get_config
from repro_torch.data.pipeline import prefetch
from repro_torch.data.synthetic import MarkovLM, MaskedFrames, PhraseMT
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as M
from repro_torch.optim import optimizer_init


def data_for(cfg, batch: int, seq: int, seed: int):
    """The arch's synthetic batches: PhraseMT pairs (source seq // 2, target
    twice that) for an encoder-decoder, MaskedFrames for an audio encoder,
    MarkovLM streams for an LM, a vision_text one's behind 4 zero patch
    embeddings."""
    if cfg.is_encoder_decoder:
        task = PhraseMT(vocab=cfg.vocab_size, expand=2, seed=seed)
        return task.batches(batch=batch, src_len=max(seq // 2, 4), seed=seed)
    if cfg.modality == "audio":
        task = MaskedFrames(d_model=cfg.d_model,
                            codebook=min(cfg.vocab_size, 504), seed=seed)
        return task.batches(batch=batch, seq_len=seq, seed=seed)
    task = MarkovLM(vocab=min(cfg.vocab_size, 256), temperature=0.2, seed=seed)
    gen = task.batches(batch=batch, seq_len=seq, seed=seed)
    if cfg.modality == "vision_text":
        def with_patches():
            for b in gen:
                b["patch_embeds"] = np.zeros((batch, 4, cfg.d_model),
                                             np.float32)
                yield b
        return with_patches()
    return gen


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--full-config", action="store_true",
                    help="train the full config instead of the smoke config")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=20)
    return ap


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Parse ``argv``, train, checkpoint.  Returns the params, optimizer
    state, last step's metrics, config and the step the run started at."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=not args.full_config).replace(dtype="float32")
    tc = TrainConfig(global_batch=args.batch, seq_len=args.seq, lr=args.lr,
                     steps=args.steps, warmup_steps=max(args.steps // 10, 10),
                     head_loss="random" if cfg.bpd_enabled else "mean")
    step_fn = make_train_step(cfg, tc)
    params = M.init(cfg, seed=args.seed, device=dev)
    start = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        start = latest_step(args.ckpt_dir)
        params, _ = restore(args.ckpt_dir, params)
        print(f"[train] restored step {start} from {args.ckpt_dir}")
    opt = optimizer_init(params, tc)

    gen = torch.Generator().manual_seed(args.seed + 2)
    batches = prefetch(data_for(cfg, args.batch, args.seq, args.seed + 1),
                       device=dev)
    metrics: Dict = {}
    t0 = time.perf_counter()
    try:
        for i in range(start, args.steps):
            params, opt, metrics = step_fn(params, opt, next(batches), gen)
            if (i + 1) % args.log_every == 0:
                loss = float(metrics["loss"])          # waits for the step
                acc = float(metrics.get("accuracy", 0))
                rate = (i + 1 - start) * args.batch * args.seq / (
                    time.perf_counter() - t0)
                moe = "".join(f"  {k[4:]} {float(metrics[k]):.4f}" for k in
                              ("moe_aux_loss", "moe_z_loss",
                               "moe_dropped_frac") if k in metrics)
                print(f"[train] step {i + 1:5d}  loss {loss:.4f}  acc "
                      f"{acc:.3f}{moe}  {rate:,.0f} tok/s", flush=True)
            if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
                save(args.ckpt_dir, i + 1, params, extra={"arch": args.arch})
    finally:
        batches.close()
    if args.ckpt_dir:
        save(args.ckpt_dir, args.steps, params, extra={"arch": args.arch})
        print(f"[train] final checkpoint -> {args.ckpt_dir}")
    return {"params": params, "opt_state": opt, "metrics": metrics,
            "cfg": cfg, "start": start}


if __name__ == "__main__":
    main()

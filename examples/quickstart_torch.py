"""Quickstart on the PyTorch port: train a small combined scoring/proposal
LM and watch blockwise parallel decoding accept multi-token blocks.

    PYTHONPATH=src python examples/quickstart_torch.py [--steps 300] [--k 4] [--device cpu]

The twin of ``examples/quickstart.py`` through ``repro_torch`` alone: the
same model (2 layers, d 96 over 4 heads of 24, vocab 32), the same
predictable Markov corpus and recipe, then greedy and BPD of the same
prompts, and the paper's headline numbers: identical outputs, fewer model
invocations.  It runs on the card unless ``--device cpu`` is given; on the
card attention runs the split-KV kernels at head_dim 24.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import DecodeConfig, ModelConfig, TrainConfig
from repro_torch.core import decode as D
from repro_torch.data.synthetic import MarkovLM
from repro_torch.launch import steps as steps_lib
from repro_torch.models import model as M
from repro_torch.optim import optimizer_init


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=48)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cfg = ModelConfig(name="quickstart", num_layers=2, d_model=96,
                      num_heads=4, num_kv_heads=2, d_ff=192, vocab_size=32,
                      bpd_k=args.k, max_seq_len=256, dtype="float32")
    tc = TrainConfig(global_batch=16, seq_len=48, lr=3e-3, warmup_steps=30,
                     head_loss="mean")
    task = MarkovLM(vocab=cfg.vocab_size, temperature=0.12, seed=3)

    print(f"[1/3] training {cfg.name} (k={args.k}) for {args.steps} steps "
          f"on {dev} ...")
    params = M.init(cfg, seed=0, device=dev)
    opt = optimizer_init(params, tc)
    step = steps_lib.make_train_step(cfg, tc)
    gen = task.batches(batch=tc.global_batch, seq_len=tc.seq_len, seed=1)
    draws = torch.Generator().manual_seed(1)
    for i in range(args.steps):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in next(gen).items()}
        params, opt, metrics = step(params, opt, batch, draws)
        if (i + 1) % max(args.steps // 5, 1) == 0:
            print(f"    step {i + 1:4d}  loss {float(metrics['loss']):.3f}")

    print("[2/3] decoding: greedy vs blockwise-parallel ...")
    prompts = torch.as_tensor(task.sample(np.random.default_rng(9), 8, 12),
                              device=dev)
    dec = DecodeConfig(max_new_tokens=args.max_new, block_k=args.k,
                       criterion="exact")
    batch = {"tokens": prompts}

    def timed(fn):
        fn(params, cfg, dec, batch)                   # warm-up
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn(params, cfg, dec, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t0

    (bt, bs), t_bpd = timed(D.bpd_decode)
    (gt, gs), t_greedy = timed(D.greedy_decode)

    n = prompts.shape[1] + args.max_new
    same = torch.equal(bt[:, :n], gt[:, :n])
    print("[3/3] results")
    print(f"    outputs identical to greedy : {same}")
    print(f"    mean accepted block size k̂  : {bs['mean_accepted']:.2f}")
    print(f"    model invocations           : BPD {bs['invocations']} "
          f"vs greedy {gs['invocations']}")
    print(f"    wall-clock                  : BPD {t_bpd * 1e3:.0f}ms "
          f"vs greedy {t_greedy * 1e3:.0f}ms ({t_greedy / t_bpd:.2f}x) "
          f"on {dev}")
    assert same


if __name__ == "__main__":
    main()

"""End-to-end MT example on the PyTorch port (the paper's §7.1 pipeline at a
small scale):

  1. pre-train a baseline encoder-decoder transformer on cipher-translation,
  2. distil the training data with the teacher's greedy decodes,
  3. attach the combined scoring/proposal heads (paper Fig. 3) and
     fine-tune on the distilled data (§6.1 + §6.2, the paper's best
     setting),
  4. decode with blockwise parallel decoding and print a per-step trace in
     the style of the paper's §7.4 example ("Step 1: 4 tokens [...]"),
     then the batch's mean accepted block size k̂.

The twin of ``examples/translate_bpd.py`` through ``repro_torch`` alone.
It runs on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/translate_bpd_torch.py [--k 6] [--quick] [--device cpu]
"""
import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import DecodeConfig, ModelConfig, TrainConfig
from repro_torch.core import decode as D
from repro_torch.core.heads import heads_init
from repro_torch.data.synthetic import PhraseMT
from repro_torch.launch import steps as steps_lib
from repro_torch.models import model as M
from repro_torch.models import seq2seq as S
from repro_torch.optim import freeze_mask, optimizer_init

VOCAB, SRC_LEN, EXPAND, BATCH = 64, 8, 2, 16
TGT_LEN = SRC_LEN * EXPAND
# (pre-training steps, fine-tuning steps, distilled batches) per mode
SCHEDULE = {"quick": (150, 120, 16), "full": (800, 500, 48)}


def mt_config(k, enabled=True):
    return ModelConfig(
        name="translate-bpd", family="seq2seq", is_encoder_decoder=True,
        num_encoder_layers=2, num_layers=2, d_model=96, num_heads=4,
        num_kv_heads=4, d_ff=192, vocab_size=VOCAB, bpd_k=k,
        bpd_enabled=enabled, max_seq_len=256, dtype="float32")


def train(cfg, params, gen, steps, dev, *, lr, freeze=False, seed=0):
    tc = TrainConfig(global_batch=BATCH, seq_len=TGT_LEN, lr=lr,
                     warmup_steps=max(steps // 10, 10),
                     head_loss="random" if cfg.bpd_enabled else "mean",
                     freeze_base=freeze,
                     detach_head_residual=cfg.bpd_enabled and not freeze)
    mask = freeze_mask(params, train_only_heads=freeze)
    opt = optimizer_init(params, tc, mask)
    step = steps_lib.make_train_step(cfg, tc, mask=mask)
    draws = torch.Generator().manual_seed(seed)
    for i in range(steps):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in next(gen).items()}
        params, opt, metrics = step(params, opt, batch, draws)
        if (i + 1) % max(steps // 4, 1) == 0:
            print(f"    step {i + 1:4d}  loss {float(metrics['loss']):.3f}")
    return params


def noisy_batches(task, *, noise=0.15, seed=1):
    rng = np.random.default_rng(seed)
    while True:
        src, tgt = task.make_pair(rng, BATCH, SRC_LEN)
        flip = rng.random(tgt.shape) < noise
        tgt = np.where(flip, rng.integers(1, VOCAB, tgt.shape), tgt)
        yield {"src": src, "tgt": tgt.astype(np.int32)}


@torch.no_grad()
def trace_decode(params, cfg, dec, src_row, dev):
    """BPD of one sentence, one ``bpd_iteration`` at a time, printing the
    paper-style per-step acceptance trace.  Returns (the output tokens,
    the iterations)."""
    batch = {"src": torch.as_tensor(src_row[None], device=dev)}
    state, be = D.bpd_prefill_seq2seq(params, cfg, dec, batch)
    step = 0
    while not bool(state.finished[0]) and step < dec.max_new_tokens:
        prev_len = int(state.text_len[0])
        state = D.bpd_iteration(params, cfg, dec, be, state, prefix_offset=0,
                                max_new=dec.max_new_tokens)
        khat = int(state.text_len[0]) - prev_len
        toks = state.tokens[0, prev_len:prev_len + khat].tolist()
        step += 1
        print(f"    Step {step}: {khat} token{'s' if khat > 1 else ''}  {toks}")
    return state.tokens[0, 1:int(state.text_len[0])].cpu().numpy(), step


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=6)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    pre, ft, n_distil = SCHEDULE["quick" if args.quick else "full"]

    task = PhraseMT(vocab=VOCAB, expand=EXPAND, seed=0)

    print(f"[1/4] pre-training baseline seq2seq ({pre} steps) on {dev} ...")
    cfg0 = mt_config(args.k, enabled=False)
    params = S.init(cfg0, seed=0, device=dev)
    params = train(cfg0, params, noisy_batches(task), pre, dev, lr=3e-3)

    print("[2/4] distilling training data with teacher greedy decodes ...")
    dec1 = DecodeConfig(max_new_tokens=TGT_LEN, block_k=1, eos_id=-1)
    rng = np.random.default_rng(11)
    distilled = []
    for _ in range(n_distil):
        src, _ = task.make_pair(rng, BATCH, SRC_LEN)
        toks, _ = D.greedy_decode_seq2seq(
            params, cfg0, dec1, {"src": torch.as_tensor(src, device=dev)})
        distilled.append({"src": src, "tgt": toks[:, :TGT_LEN].cpu().numpy()})

    print(f"[3/4] attaching k={args.k} heads + fine-tuning on distilled data "
          f"({ft} steps) ...")
    cfg = mt_config(args.k)
    gen = torch.Generator(device=dev).manual_seed(7)
    params.add_module("bpd_heads", M.ParamTree(heads_init(
        gen, cfg, dtype=cfg.params_dtype, device=dev)))

    def distilled_gen():
        i = 0
        while True:
            yield distilled[i % len(distilled)]
            i += 1

    params = train(cfg, params, distilled_gen(), ft, dev, lr=1e-3, seed=3)

    print("[4/4] blockwise parallel decoding trace (paper §7.4 style):")
    src, _ = task.make_pair(np.random.default_rng(99), 1, SRC_LEN)
    gold = task.gold(src[:1])[0]
    dec = DecodeConfig(max_new_tokens=TGT_LEN, block_k=args.k)
    print(f"    Input : {[int(x) for x in src[0]]}")
    out, trace_steps = trace_decode(params, cfg, dec, src[0], dev)
    print(f"    Output: {[int(x) for x in out[:TGT_LEN]]}")
    print(f"    Gold  : {[int(x) for x in gold]}")
    acc = (out[:TGT_LEN] == gold).mean()
    print(f"    token accuracy vs gold: {acc:.2%}")

    # batch stats
    src, _ = task.make_pair(np.random.default_rng(5), BATCH, SRC_LEN)
    batch = {"src": torch.as_tensor(src, device=dev)}
    toks, stats = D.bpd_decode_seq2seq(params, cfg, dec, batch)
    print(f"    batch mean accepted block size k̂ = "
          f"{stats['mean_accepted']:.2f} (max {args.k})")
    return {"params": params, "cfg": cfg, "dec": dec, "batch": batch,
            "tokens": toks, "stats": stats, "trace_tokens": out,
            "trace_steps": trace_steps, "accuracy": float(acc)}


if __name__ == "__main__":
    main()

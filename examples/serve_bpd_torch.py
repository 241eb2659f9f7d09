"""Serving-shaped example on the PyTorch port: batched requests through the
prefill + serve_step API.

The twin of ``examples/serve_bpd.py`` through ``repro_torch`` alone.  It
trains the arch's reduced smoke config briefly on a Markov task (through
``make_train_step``, RWKV-6 included), then simulates a request queue:
each request is a prompt; the server prefills a batch
(``make_prefill_step``), then repeatedly applies ``serve_step``
(``make_serve_step``) — ONE blockwise-parallel iteration per call, exactly
the unit of work a production serving loop schedules — until every row
finishes.

    PYTHONPATH=src python examples/serve_bpd_torch.py [--arch granite-3-8b]
        [--batch 4] [--steps 150] [--max-new 24] [--continuous] [--device cpu]

Any registered arch with a decode path works; an encoder-only one exits.
``--continuous`` serves the same trained model through the slot-based
continuous-batching engine instead: twice as many requests as slots, with
finished slots evicted and queued requests admitted mid-flight (attention
families only, as in the reference).  It runs on the card unless
``--device cpu`` is given.
"""
import argparse
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import DecodeConfig, TrainConfig, get_config
from repro_torch.data.synthetic import MarkovLM
from repro_torch.launch import steps as steps_lib
from repro_torch.models import model as M
from repro_torch.optim import optimizer_init

PROMPT_LEN = 16
PATCHES = 4          # the zero patch embeddings before a vision_text prompt


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=150,
                    help="training steps to make proposals non-trivial")
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--continuous", action="store_true",
                    help="serve via the continuous-batching engine "
                         "(slots + mid-flight admission)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def train(cfg, steps: int, dev):
    """A quick task-tune so the heads propose something acceptable.
    Returns (params, task)."""
    task = MarkovLM(vocab=min(cfg.vocab_size, 64), temperature=0.15, seed=2)
    tc = TrainConfig(global_batch=8, seq_len=32, lr=3e-3, warmup_steps=20,
                     head_loss="mean")
    params = M.init(cfg, seed=0, device=dev)
    opt = optimizer_init(params, tc)
    step = steps_lib.make_train_step(cfg, tc)
    data = task.batches(batch=8, seq_len=32, seed=1)
    draws = torch.Generator().manual_seed(1)
    for _ in range(steps):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in next(data).items()}
        if cfg.modality == "vision_text":
            batch["patch_embeds"] = torch.zeros((8, PATCHES, cfg.d_model),
                                                device=dev)
        params, opt, _ = step(params, opt, batch, draws)
    return params, task


def serve_static(params, cfg, task, rng, *, batch: int, max_new: int,
                 dev) -> Dict:
    """Prefill a batch of prompts, then one serve step per iteration until
    every row finishes.  Returns the batch, the decode config, the final
    state and the loop's iterations and wall time."""
    prompts = torch.as_tensor(task.sample(rng, batch, PROMPT_LEN), device=dev)
    req = {"tokens": prompts}
    if cfg.modality == "vision_text":
        req["patch_embeds"] = torch.zeros((batch, PATCHES, cfg.d_model),
                                          device=dev)
    dec = DecodeConfig(max_new_tokens=max_new, block_k=cfg.bpd_k)
    print(f"[serve] prefilling batch of {batch} "
          f"(prompt len {prompts.shape[1]}) ...")
    state = steps_lib.make_prefill_step(cfg, dec)(params, req)
    prefix = M.prefix_len(cfg, req)
    serve_step = steps_lib.make_serve_step(
        cfg, dec, seq_len=prompts.shape[1] + prefix, max_new=max_new)

    it = 0
    t0 = time.perf_counter()
    while not bool(state.finished.all()) and it < max_new:
        state = serve_step(params, state)
        it += 1
        print(f"    iter {it:3d}: generated/row = "
              f"{state.generated.tolist()}  finished "
              f"{int(state.finished.sum())}/{batch}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0

    total = int(state.generated.sum())
    print(f"[serve] {total} tokens in {it} iterations "
          f"({total / max(it, 1):.2f} tokens/iteration, "
          f"{dt * 1e3:.0f}ms wall on {dev})")
    print("[serve] per-row outputs:")
    for r in range(batch):
        n = int(state.text_len[r])
        print(f"    row {r}: {state.tokens[r, PROMPT_LEN:n].tolist()}")
    return {"batch": req, "dec": dec, "state": state, "iterations": it,
            "wall_s": dt}


def serve_continuous(params, cfg, task, rng, *, batch: int, max_new: int,
                     dev) -> Dict:
    """Request traffic through the continuous-batching engine: 2× as many
    requests as slots, admitted as earlier requests finish.  Returns the
    engine, the decode config, the requests and their finish records."""
    from repro_torch.serving import (ContinuousBatchingEngine, EngineConfig,
                                     Request, Scheduler, aggregate_stats)

    dec = DecodeConfig(max_new_tokens=max_new, block_k=cfg.bpd_k)
    engine = ContinuousBatchingEngine(
        params, cfg, dec, EngineConfig(num_slots=batch,
                                       max_prompt_len=PROMPT_LEN,
                                       max_new_cap=max_new))
    sched = Scheduler(engine)
    n = 2 * batch
    reqs = []
    for rid in range(n):
        reqs.append(Request(
            rid=rid,
            prompt=task.sample(rng, 1, int(rng.integers(8, PROMPT_LEN + 1)))[0],
            max_new=int(rng.integers(4, max_new + 1))))
        sched.submit(reqs[-1])
    print(f"[serve] continuous: {n} requests through {batch} slots ...")

    t0 = time.perf_counter()
    it = 0
    while not sched.drained():
        done = sched.step()
        it += 1
        for f in done:
            print(f"    iter {it:3d}: req {f.rid} done — k̂={f.mean_accepted:.2f} "
                  f"gen={f.generated} inv={f.invocations} "
                  f"out={[int(x) for x in f.tokens]}")
    stats = aggregate_stats(sched.finished, time.perf_counter() - t0)
    print(f"[serve] {stats['total_tokens']} tokens / "
          f"{stats['total_invocations']} invocations in {it} engine steps "
          f"({stats['tokens_per_sec']:.0f} tok/s on {dev}, mean k̂ "
          f"{stats['mean_accepted']:.2f}, compile {engine.compile_counts()})")
    return {"engine": engine, "dec": dec, "requests": reqs,
            "finished": list(sched.finished), "steps": it}


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=True).replace(dtype="float32")
    if cfg.is_encoder_only:
        raise SystemExit(f"{args.arch} is encoder-only: no decode path "
                         "(see DESIGN.md §Arch-applicability)")
    print(f"[serve] arch={args.arch} (reduced: {cfg.num_layers}L "
          f"d={cfg.d_model} k={cfg.bpd_k}) on {dev}")
    params, task = train(cfg, args.steps, dev)

    # ---- the serving loop --------------------------------------------------
    rng = np.random.default_rng(7)
    serve = serve_continuous if args.continuous else serve_static
    out = serve(params, cfg, task, rng, batch=args.batch,
                max_new=args.max_new, dev=dev)
    out.update(params=params, cfg=cfg)
    return out


if __name__ == "__main__":
    main()

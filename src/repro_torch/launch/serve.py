"""Serving launcher, static-batch path: decode one batch of synthetic
requests with blockwise parallel decoding (``repro.launch.serve``'s static
path, on the card).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \
        --full-config --batch 8 --prompt-len 64 --max-new 64

Without ``--full-config`` the registered smoke config runs in fp32, as the
reference serves it; with it the full config runs in its own compute dtype.
``--device`` defaults to ``cuda`` (``--device cpu`` runs the plain versions
of the kernels on the CPU).  Every registered decode policy runs
(``--policy exact|topk|distance|adaptive|topk_tree``, with ``--top-k`` and
``--epsilon``), on the dense or the paged KV cache (``--cache-backend
paged --page-size 16``).  ``--arch rwkv6-1.6b`` serves the RWKV-6 family:
its recurrent caches have no KV layout, so ``--cache-backend paged`` leaves
them as they are, and ``topk_tree`` raises (tree verification needs
attention blocks).  An encoder-decoder ``--arch`` (paper-mt-base) is
refused, as the reference's serve has no seq2seq path: its entry point is
``repro_torch.core.decode.bpd_decode_seq2seq``.  The continuous-batching
engine, HTTP serving and meshes are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import bridge, resolve_device
from repro_torch.config import DecodeConfig, get_config
from repro_torch.core.decode import bpd_decode
from repro_torch.core.policy import list_policies
from repro_torch.data.synthetic import MarkovLM
from repro_torch.models import model as M


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--ckpt-dir", default=None,
                    help="reference checkpoint dir (step_N/arrays.npz)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--block-k", type=int, default=0)
    ap.add_argument("--criterion", default="exact",
                    choices=["exact", "topk", "distance"],
                    help="legacy alias for --policy")
    ap.add_argument("--policy", default="",
                    help=f"decode policy name, one of {list_policies()}; "
                         f"empty = the --criterion alias")
    ap.add_argument("--fused-verify", action="store_true",
                    help="CPU: accept through the fused-verify plain version "
                         "(on the card the fused kernel always runs)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--full-config", action="store_true",
                    help="serve the registered full config instead of the "
                         "smoke config")
    ap.add_argument("--cache-backend", default="dense",
                    choices=["dense", "paged"],
                    help="KV cache layout: dense per-row buffers, or a page "
                         "pool with identity block tables")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page (multiple of 8; paged only)")
    ap.add_argument("--top-k", type=int, default=2,
                    help="topk acceptance set size; topk_tree fanout "
                         "(at least 2)")
    ap.add_argument("--epsilon", type=float, default=2.0,
                    help="distance acceptance radius in token ids")
    for flag in ("--engine", "--http"):
        ap.add_argument(flag, action="store_true")
    for flag in ("--mesh-data", "--mesh-model", "--mesh-pod"):
        ap.add_argument(flag, type=int, default=0)
    return ap


def _not_ported(args) -> Optional[str]:
    if args.engine or args.http:
        return "--engine / --http (the serving stack: ROADMAP.md item 5)"
    if args.mesh_data or args.mesh_model > 1 or args.mesh_pod > 1:
        return "--mesh-* (multi-GPU: ROADMAP.md item 8)"
    return None


def main(argv: Optional[Sequence[str]] = None, params=None) -> Dict:
    """Parse ``argv``, decode one static batch and print the summary.

    ``params`` (a ``ParamTree`` for the chosen config) skips the random
    init / checkpoint load; it is cast for the compute dtype in place
    (``model.cast_for_compute``).
    Returns the tokens, stats, wall time and the batch.
    """
    args = build_parser().parse_args(argv)
    missing = _not_ported(args)
    if missing:
        raise NotImplementedError(f"{missing} is not ported yet")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=not args.full_config)
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name} is an encoder-decoder: this launcher serves "
            f"decoder-only prompts, as the reference's does; decode a source "
            f"with repro_torch.core.decode.bpd_decode_seq2seq")
    if not args.full_config:
        cfg = cfg.replace(dtype="float32")
    if params is None:
        if args.ckpt_dir:
            params = bridge.load_checkpoint(args.ckpt_dir, cfg, device=dev)
            print(f"[serve] restored {args.ckpt_dir}")
        else:
            params = M.init(cfg, seed=args.seed, device=dev)
    params = M.cast_for_compute(params, cfg)

    dec = DecodeConfig(max_new_tokens=args.max_new,
                       block_k=args.block_k or cfg.bpd_k,
                       policy=args.policy or args.criterion,
                       top_k=args.top_k, epsilon=args.epsilon,
                       cache_backend=args.cache_backend,
                       page_size=args.page_size,
                       fused_verify=args.fused_verify)
    task = MarkovLM(vocab=min(cfg.vocab_size, 256), temperature=0.2,
                    seed=args.seed)
    prompts = task.sample(np.random.default_rng(args.seed + 1), args.batch,
                          args.prompt_len)
    batch = {"tokens": torch.as_tensor(prompts, device=dev)}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    bpd_decode(params, cfg, dec, batch)       # warm-up (the reference compiles here)
    sync()
    t0 = time.perf_counter()
    toks, stats = bpd_decode(params, cfg, dec, batch)
    sync()
    dt = time.perf_counter() - t0

    generated = int(stats["generated"].sum())
    print(f"[serve] {args.batch} requests, {args.max_new} tokens each, "
          f"policy={dec.policy}, {dec.cache_backend} cache, {cfg.name} "
          f"({cfg.dtype}) on {dev}")
    print(f"[serve] mean accepted block size k̂ = "
          f"{stats['mean_accepted']:.2f}  invocations = "
          f"{stats['invocations']} (greedy would need {args.max_new + 1})  "
          f"wall = {dt * 1e3:.0f}ms  {generated / dt:.1f} tokens/s")
    text_len = stats["text_len"].tolist()
    rows = toks.tolist()
    for r in range(args.batch):
        print(f"    row {r}: {rows[r][args.prompt_len:text_len[r]]}")
    return {"tokens": toks, "stats": stats, "wall_s": dt, "batch": batch,
            "cfg": cfg, "dec": dec, "params": params}


if __name__ == "__main__":
    main()

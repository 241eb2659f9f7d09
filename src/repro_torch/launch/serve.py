"""Serving launcher: decode synthetic requests with blockwise parallel
decoding, as one static batch, through the continuous-batching engine, or
over HTTP (``repro.launch.serve`` on one card).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \
        --full-config --batch 8 --prompt-len 64 --max-new 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \
        --full-config --engine --policies exact=4,topk_tree=4 \
        --cache-backend paged [--prefill-slots 4] [--steps-per-sync 4]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \
        --full-config --http [--port 8000 --max-queue 16] [--http-demo]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \
        --policy draft_model [--draft-arch granite-3-8b --draft-ckpt DIR]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-12b \
        --full-config --batch 8 --prompt-len 64 --max-new 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
        --full-config --batch 8 --prompt-len 64 --max-new 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
        --full-config --batch 8 --prompt-len 64 --max-new 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llava-next-34b \
        --full-config --batch 4 --prompt-len 64 --max-new 64

``--arch`` takes the registered archs: the dense text decoders
granite-3-8b, stablelm-12b (head_dim 160, per-head QK norm), starcoder2-7b
(36 heads over 4 KV heads, a 4096-token window on every layer) and
nemotron-4-15b (vocab 256000, LayerNorm, squared ReLU); the MoE decoders
olmoe-1b-7b (64 experts, top-8) and qwen2-moe-a2.7b (60 experts, top-4,
and a gated shared MLP), whose every forward here routes at full capacity;
rwkv6-1.6b; the hybrid hymba-1.5b (attention and Mamba heads in every
layer, 128 meta tokens before each prompt, windowed attention outside
layers 0, 15 and 31); the vision-language backbone llava-next-34b, whose
static batch carries 4 zero patch embeddings before each prompt, as the
reference's does; and the encoder-decoder paper-mt-base and the
encoder-only hubert-xlarge (refused here, see below).

Without ``--full-config`` the registered smoke config runs in fp32, as the
reference serves it; with it the full config runs in its own compute dtype,
its random weights drawn in that dtype (an fp32 draw of llava-next-34b's
36.7 B parameters would not fit on the card).
``--device`` defaults to ``cuda`` (``--device cpu`` runs the plain versions
of the kernels on the CPU).  Every registered decode policy runs
(``--policy exact|topk|distance|adaptive|topk_tree|locality|draft_model``,
with ``--top-k`` and ``--epsilon``; ``locality`` reads the token stream as an
``--image-height`` × ``--image-width`` raster in the progressive-lattice
order of stride ``--locality-stride``), on the dense or the paged KV cache
(``--cache-backend paged --page-size 16``).  ``--kv-chunk N`` runs the
prefill's attention in chunks of N keys (the long-prefill memory bound).
``--policy draft_model`` (or a ``draft_model`` group of ``--policies``)
drafts each block with a second, small model: the smoke config of
``--draft-arch`` (default ``--arch``) in fp32 without heads, random from
``--seed`` + 7 or restored from ``--draft-ckpt``, carried as the session's
``draft`` bundle in every mode.  Its vocabulary must be the primary's, so
``--full-config`` with a smoke draft is refused, as the reference refuses
it.  ``--arch rwkv6-1.6b`` serves the RWKV-6 family: its recurrent caches have
no KV layout, so ``--cache-backend paged`` leaves them as they are, and
``topk_tree`` raises (tree verification needs attention blocks).
``--arch hymba-1.5b`` pages its three global layers under ``--cache-backend
paged`` (the windowed layers keep their dense rings, the Mamba states stay
as they are); ``topk_tree`` raises as for rwkv6, and so does
``--policy draft_model``: the meta tokens put the primary's positions ahead
of a draft's.  The encoder-decoder ``--arch paper-mt-base`` serves its
static batch as sources: ``--batch`` MarkovLM sequences of ``--prompt-len``
tokens are encoded and decoded (``DecodeSession.decode_seq2seq``, the
reference's session entry point; the reference's launcher has no seq2seq
path), each row printing its ``generated`` output tokens; ``input_copy``
drafts from the source there, and ``--engine`` / ``--http`` raise (the
engine is decoder-only).  An encoder-only ``--arch`` (hubert-xlarge) exits
with the reference's words: it has no decode path.

``--engine`` schedules 2 × ``--batch`` mixed-length requests through
``--batch`` slots of ``repro_torch.serving.ContinuousBatchingEngine`` with
mid-flight admission (``--sched fcfs|sjf``), and prints per-request stats
and the aggregate tokens/s and latency.  ``--policies name=slots,...``
partitions the slots into per-policy groups, each request carrying a
policy drawn from them; ``--cache-backend paged`` serves from a managed
page pool with copy-on-write prefix sharing; ``--prefill-slots W``
disaggregates prefill into batches of W behind a handoff queue of
``--handoff-cap``; ``--steps-per-sync N`` runs N iterations per host read.
``--http`` serves the engine over HTTP/SSE (``repro_torch.serving.server``:
POST /v1/generate, /drain; GET /healthz /readyz /metrics) on ``--host`` /
``--port`` with a wait queue of ``--max-queue``; ``--http-demo`` streams one
request through it and exits.  The engine serves text attention models
only, as the reference's does (rwkv6-1.6b, hymba-1.5b and llava-next-34b
raise).

``--mesh-data D --mesh-model M [--mesh-pod P]`` serves sharded over a
("data", "model") process mesh, or a ("pod", "data", "model") one when P >
1: one command spawns the P·D·M ranks (``launch.mesh.spawn``), each draws
its block of the weights (``model.init(mesh=)``) and runs
``DecodeSession(mesh=)``, and rank 0 prints the lines above.  The static
batch shards over the batch axes; ``--engine`` and ``--http`` keep each
rank's slots of every group (``--batch`` must divide over pod×data, or
data), rank 0 runs the scheduler (and the HTTP server) and the other ranks
replay its plans (``ContinuousBatchingEngine.follow``); ``--prefill-slots
W`` on a pod mesh prefills each pod's rows of a batch and hands them to
every rank over ``pod``.  Ranks sharing one card use gloo, ranks with a
card each NCCL (printed).  The mesh serves what one device serves, under
every policy (a ``draft_model`` draft is cut by the primary's rules on
each rank): the dense trunk (granite-3-8b, stablelm-12b, starcoder2-7b,
nemotron-4-15b) and the MoE models (olmoe-1b-7b, qwen2-moe-a2.7b: experts
over ``model``) static and through ``--engine`` / ``--http``; rwkv6-1.6b
(wkv heads over ``model``), hymba-1.5b (Mamba channels over ``model``,
attention replicated), llava-next-34b (a rank's rows of the patch prefix)
and paper-mt-base (a rank's rows of the sources, both stacks' heads over
``model``) static only, as on one device, where the engine refuses them
too:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
        --device cpu --mesh-model 2 [--engine]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
        --device cpu --mesh-data 2 --mesh-model 2
    PYTHONPATH=src python -m repro_torch.launch.serve --arch paper-mt-base \
        --device cpu --policy input_copy --mesh-model 2

A head split that straddles KV heads raises before any rank starts
(ROADMAP.md §1 item 8c(iii)).
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import signal
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import bridge, resolve_device
from repro_torch.config import DecodeConfig, get_config
from repro_torch.core.bundle import ModelBundle
from repro_torch.core.policy import list_policies, resolve_policy
from repro_torch.data.synthetic import MarkovLM
from repro_torch.launch.mesh import Mesh, choose_backend, spawn
from repro_torch.models import model as M
from repro_torch.serving import (ContinuousBatchingEngine, DecodeSession,
                                 EngineConfig, Frontend, HTTPServer, Request,
                                 Scheduler, aggregate_stats)
from repro_torch.serving.engine import check_engine_supported


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="granite-3-8b, stablelm-12b, starcoder2-7b, "
                         "nemotron-4-15b, olmoe-1b-7b, qwen2-moe-a2.7b, "
                         "rwkv6-1.6b or hymba-1.5b (paper-mt-base: "
                         "bpd_decode_seq2seq)")
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
    ap.add_argument("--image-height", type=int, default=0,
                    help="2-D raster rows for the locality policy "
                         "(--policy locality / --policies locality=N): the "
                         "token stream is an image serialized in the "
                         "progressive-lattice order")
    ap.add_argument("--image-width", type=int, default=0,
                    help="2-D raster cols for the locality policy")
    ap.add_argument("--locality-stride", type=int, default=4,
                    help="coarse-lattice stride of the locality order "
                         "(power of two)")
    ap.add_argument("--kv-chunk", type=int, default=0,
                    help="prefill attention in chunks of this many keys "
                         "(0 = one score matrix)")
    ap.add_argument("--draft-arch", default="",
                    help="draft_model: the draft's arch (its smoke config; "
                         "default --arch)")
    ap.add_argument("--draft-ckpt", default=None,
                    help="draft_model: reference checkpoint dir of the draft "
                         "(default: random weights from --seed + 7)")
    ap.add_argument("--engine", action="store_true",
                    help="serve through the continuous-batching engine "
                         "(slots + admission) instead of one static batch")
    ap.add_argument("--policies", default="",
                    help="engine per-policy slot groups, e.g. "
                         "'exact=4,topk_tree=4' (must partition --batch)")
    ap.add_argument("--sched", default="fcfs", choices=["fcfs", "sjf"],
                    help="engine admission order")
    ap.add_argument("--prefill-slots", type=int, default=0,
                    help="disaggregated prefill: prompts per prefill "
                         "forward (0 = unified engine)")
    ap.add_argument("--handoff-cap", type=int, default=0,
                    help="bound on requests staged for / parked in the "
                         "KV-handoff queue (0 = auto)")
    ap.add_argument("--steps-per-sync", type=int, default=1,
                    help="decode iterations per engine step (one host read "
                         "each)")
    ap.add_argument("--http", action="store_true",
                    help="serve the engine over HTTP/SSE")
    ap.add_argument("--host", default="127.0.0.1", help="--http bind address")
    ap.add_argument("--port", type=int, default=8000,
                    help="--http bind port (0 = ephemeral, printed)")
    ap.add_argument("--max-queue", type=int, default=16,
                    help="--http wait-queue bound (beyond it: 429)")
    ap.add_argument("--http-demo", action="store_true",
                    help="with --http: stream one request end to end, check "
                         "/healthz and /readyz, then exit")
    for flag in ("--mesh-data", "--mesh-model", "--mesh-pod"):
        ap.add_argument(flag, type=int, default=0)
    return ap


def _mesh_shape(args) -> Optional[tuple]:
    """(P, D, M) when ``--mesh-data``, ``--mesh-model`` or ``--mesh-pod``
    asks for a mesh."""
    if max(args.mesh_data, args.mesh_model, args.mesh_pod) <= 0:
        return None
    return (max(args.mesh_pod, 1), max(args.mesh_data, 1),
            max(args.mesh_model, 1))


def parse_policy_groups(spec: str):
    """'exact=2,topk_tree=2' -> {"exact": 2, "topk_tree": 2} (None when
    empty), every error naming its fix at the flag."""
    if not spec:
        return None
    known = list_policies()
    groups = {}
    for part in spec.split(","):
        name, sep, n = part.strip().partition("=")
        if not sep or not name or not n.lstrip("+-").isdigit():
            raise SystemExit(f"--policies entry {part!r}: expected "
                             f"name=slots, e.g. exact=2")
        if name not in known:
            raise SystemExit(f"--policies names unknown policy {name!r}: "
                             f"registered policies are "
                             f"{', '.join(sorted(known))}")
        if name in groups:
            raise SystemExit(f"--policies names {name!r} twice: one slot "
                             f"group per policy")
        if int(n) <= 0:
            raise SystemExit(f"--policies entry {part.strip()!r}: slot "
                             f"count must be a positive integer")
        groups[name] = int(n)
    return groups


def main(argv: Optional[Sequence[str]] = None, params=None) -> Dict:
    """Parse ``argv``, serve (a static batch, ``--engine`` or ``--http``)
    and print the summary.

    ``params`` (a ``ParamTree`` for the chosen config) skips the random
    init / checkpoint load; it is cast for the compute dtype in place
    (``model.cast_for_compute``).  The static path returns the tokens,
    stats, wall time and the batch; ``--engine`` the finished requests,
    aggregate stats and the engine; ``--http`` the engine (and the demo's
    done payload).
    """
    args = build_parser().parse_args(argv)
    groups = parse_policy_groups(args.policies)
    if groups and not (args.engine or args.http):
        raise SystemExit("--policies configures slot groups of the "
                         "continuous-batching engine: add --engine (or "
                         "--http)")
    mesh_shape = _mesh_shape(args)
    if mesh_shape:
        if params is not None:
            raise ValueError("params= is single-device: under --mesh-* each "
                             "rank draws or restores its own block")
        return serve_mesh(sys.argv[1:] if argv is None else list(argv),
                          args, *mesh_shape)
    dev = resolve_device(args.device)
    cfg, dec = _configs(args)
    if params is None:
        params = _params(cfg, args, dev)
    params = M.cast_for_compute(params, cfg)
    bundles = draft_bundle(cfg, args, groups)
    task = MarkovLM(vocab=min(cfg.vocab_size, 256), temperature=0.2,
                    seed=args.seed)
    if args.http:
        return serve_http(params, cfg, dec, args, groups, bundles)
    if args.engine:
        return serve_engine(params, cfg, dec, args, task, groups, bundles)
    sess = DecodeSession(params, cfg, dec, kv_chunk=args.kv_chunk,
                         bundles=bundles)
    return serve_static(sess, args, task, dev)


def _configs(args):
    """The served (ModelConfig, DecodeConfig) of ``args``."""
    cfg = get_config(args.arch, smoke=not args.full_config)
    if cfg.is_encoder_only:
        raise SystemExit(f"{args.arch} is encoder-only — no decode path")
    if not args.full_config:
        cfg = cfg.replace(dtype="float32")
    dec = DecodeConfig(max_new_tokens=args.max_new,
                       block_k=args.block_k or cfg.bpd_k,
                       policy=args.policy or args.criterion,
                       top_k=args.top_k, epsilon=args.epsilon,
                       cache_backend=args.cache_backend,
                       page_size=args.page_size,
                       fused_verify=args.fused_verify,
                       image_height=args.image_height,
                       image_width=args.image_width,
                       locality_stride=args.locality_stride)
    return cfg, dec


def _params(cfg, args, dev, mesh=None):
    """The served weights, or this rank's blocks of them: restored from
    ``--ckpt-dir``, else random from ``--seed``, drawn in the dtype the
    serve reads them in."""
    if args.ckpt_dir:
        params = bridge.load_checkpoint(args.ckpt_dir, cfg, device=dev,
                                        mesh=mesh)
        if mesh is None or mesh.index == 0:
            print(f"[serve] restored {args.ckpt_dir}")
        return params
    return M.init(cfg.replace(param_dtype=cfg.dtype), seed=args.seed,
                  device=dev, mesh=mesh)


def serve_static(sess, args, task, dev) -> Dict:
    """Decode ``--batch`` MarkovLM prompts as one static batch through
    ``sess`` (a warm-up, then the timed run) and print the summary (on
    rank 0 of a mesh)."""
    cfg, dec = sess.cfg, sess.dec
    prompts = task.sample(np.random.default_rng(args.seed + 1), args.batch,
                          args.prompt_len)
    seq2seq = cfg.is_encoder_decoder       # the prompts are the sources
    batch = {"src" if seq2seq else "tokens": torch.as_tensor(prompts,
                                                             device=dev)}
    if cfg.modality == "vision_text":
        batch["patch_embeds"] = torch.zeros((args.batch, 4, cfg.d_model),
                                            dtype=torch.float32, device=dev)
    decode = sess.decode_seq2seq if seq2seq else sess.decode

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    decode(batch)                                               # warm-up
    sync()
    t0 = time.perf_counter()
    toks, stats = decode(batch)
    sync()
    dt = time.perf_counter() - t0

    if sess.mesh is None or sess.mesh.index == 0:
        where = (f"{dev}" if sess.mesh is None else
                 f"mesh {sess.mesh.shape} of {sess.mesh.size} ranks "
                 f"({sess.mesh.backend}), rank 0 on {dev}")
        generated = int(stats["generated"].sum())
        print(f"[serve] {args.batch} requests, {args.max_new} tokens each, "
              f"policy={dec.policy}, {dec.cache_backend} cache, {cfg.name} "
              f"({cfg.dtype}) on {where}")
        print(f"[serve] mean accepted block size k̂ = "
              f"{stats['mean_accepted']:.2f}  invocations = "
              f"{stats['invocations']} (greedy would need {args.max_new + 1})"
              f"  wall = {dt * 1e3:.0f}ms  {generated / dt:.1f} tokens/s")
        # a row's output: past its prompt, or (seq2seq, no BOS) from 0
        start = 0 if seq2seq else args.prompt_len
        ends = (stats["generated"] if seq2seq else stats["text_len"]).tolist()
        rows = toks.tolist()
        for r in range(args.batch):
            print(f"    row {r}: {rows[r][start:ends[r]]}", flush=True)
    return {"tokens": toks, "stats": stats, "wall_s": dt, "batch": batch,
            "cfg": cfg, "dec": dec, "params": sess.params, "session": sess}


def serve_mesh(argv: Sequence[str], args, pod: int, data: int,
               model: int) -> Dict:
    """Serve on a ``pod`` × ``data`` × ``model`` mesh: spawn the ranks
    (``_serve_rank``) and return rank 0's results (the static batch's
    tokens and stats, or the engine's finished requests and stats), with
    every rank's under ``ranks``."""
    cfg, dec = _configs(args)                  # refusals before any spawn
    layout = Mesh(data, model, pod=pod)
    M.check_mesh_supported(cfg, layout)
    if args.engine or args.http:
        check_engine_supported(cfg)
    groups = parse_policy_groups(args.policies)
    for name in groups or [None]:
        resolve_policy(dec, name)
    if args.policy == "draft_model" or "draft_model" in (groups or {}):
        M.check_mesh_supported(draft_config(args), layout)
    if args.engine or args.http:
        ecfg = _engine_config(args)
        for n in (groups or {"": args.batch}).values():
            dataclasses.replace(ecfg, num_slots=n).validate(dec=dec,
                                                            mesh=layout)
    backend, why = choose_backend(layout.size, args.device)
    print(f"[serve] mesh {layout.shape}: {layout.size} ranks, backend "
          f"{backend} ({why})", flush=True)
    # an --http server runs until drained: only its collectives time out
    # (an idle server's rank 0 sends heartbeats, engine.keep_alive)
    ranks = spawn(_serve_rank, data, model, pod=pod, args=(list(argv),),
                  device=args.device,
                  limit_run=not args.http or args.http_demo)
    out = dict(ranks[0])
    if "tokens" in out:
        out["tokens"] = torch.as_tensor(out["tokens"])
        out["stats"] = dict(out["stats"], **{
            k: torch.as_tensor(out["stats"][k])
            for k in ("generated", "text_len")})
    return dict(out, ranks=ranks)


def _serve_rank(mesh, argv: Sequence[str]) -> Dict:
    """One rank of ``serve_mesh``: its blocks of the weights, the sharded
    session, then ``serve_static``, ``serve_engine`` or ``serve_http``
    (rank 0 scheduling and printing, the others replaying its plans)."""
    args = build_parser().parse_args(argv)
    cfg, dec = _configs(args)
    params = M.cast_for_compute(_params(cfg, args, mesh.device, mesh), cfg)
    groups = parse_policy_groups(args.policies)
    bundles = draft_bundle(cfg, args, groups, mesh=mesh)
    where = {"device": str(mesh.device), "backend": mesh.backend}
    if args.http:
        out = serve_http(params, cfg, dec, args, groups, bundles, mesh=mesh)
        return dict(where, demo=out.get("demo"), finished=out["finished"])
    if args.engine:
        task = MarkovLM(vocab=min(cfg.vocab_size, 256), temperature=0.2,
                        seed=args.seed)
        out = serve_engine(params, cfg, dec, args, task, groups, bundles,
                           mesh=mesh)
        return dict(where, finished=out["finished"], stats=out["stats"],
                    plans=out["engine"].num_plans)
    sess = DecodeSession(params, cfg, dec, mesh=mesh, kv_chunk=args.kv_chunk,
                         bundles=bundles)
    task = MarkovLM(vocab=min(cfg.vocab_size, 256), temperature=0.2,
                    seed=args.seed)
    out = serve_static(sess, args, task, mesh.device)
    return dict(where, tokens=out["tokens"], stats=out["stats"],
                wall_s=out["wall_s"])


def draft_config(args):
    """The draft's config: the smoke config of ``--draft-arch`` (default
    ``--arch``) in fp32 without heads."""
    return get_config(args.draft_arch or args.arch, smoke=True).replace(
        dtype="float32", bpd_enabled=False)


def draft_bundle(cfg, args, groups=None, mesh=None):
    """The ``draft`` bundle when a served policy is ``draft_model`` (None
    otherwise): ``draft_config``'s weights restored from ``--draft-ckpt`` or
    random from ``--seed`` + 7, on ``--device``, or on a mesh rank this
    rank's blocks of them (the session cuts a restored draft)."""
    if args.policy != "draft_model" and "draft_model" not in (groups or {}):
        return None
    dcfg = draft_config(args)
    dev = resolve_device(args.device if mesh is None else mesh.device)
    say = mesh is None or mesh.index == 0
    if args.draft_ckpt:
        dparams = bridge.load_checkpoint(args.draft_ckpt, dcfg, device=dev)
        what = f"restored from {args.draft_ckpt}"
    else:
        dparams = M.init(dcfg, seed=args.seed + 7, device=dev, mesh=mesh)
        what = ("(random weights: lossless, but expect k̂ ≈ 1; pass "
                "--draft-ckpt for a real draft)")
    if say:
        print(f"[serve] draft model: {dcfg.name} {what}")
    return {"draft": ModelBundle(dparams, dcfg)}


def _engine_config(args) -> EngineConfig:
    return EngineConfig(num_slots=args.batch, max_prompt_len=args.prompt_len,
                        max_new_cap=args.max_new,
                        prefill_slots=args.prefill_slots,
                        handoff_cap=args.handoff_cap,
                        steps_per_sync=args.steps_per_sync)


def _engine(params, cfg, dec, args, groups, bundles=None,
            mesh=None) -> ContinuousBatchingEngine:
    session = DecodeSession(params, cfg, dec, kv_chunk=args.kv_chunk,
                            bundles=bundles, mesh=mesh)
    return ContinuousBatchingEngine(params, cfg, dec, _engine_config(args),
                                    session=session, policies=groups)


def serve_engine(params, cfg, dec, args, task, groups, bundles=None,
                 mesh=None) -> Dict:
    """Mixed-length (and, with ``groups``, mixed-policy) traffic through the
    continuous-batching engine: 2 × ``--batch`` requests, all arrived at
    the start.  On a mesh rank 0 schedules and prints, the other ranks
    replay its plans."""
    engine = _engine(params, cfg, dec, args, groups, bundles, mesh)
    if mesh is not None and mesh.index:
        finished = engine.follow()
        return {"finished": finished, "stats": None, "engine": engine,
                "cfg": cfg, "dec": dec, "params": params}
    sched = Scheduler(engine, policy=args.sched)
    rng = np.random.default_rng(args.seed + 2)
    names = engine.policy_names()
    n = 2 * args.batch
    for rid in range(n):
        plen = int(rng.integers(max(args.prompt_len // 2, 1),
                                args.prompt_len + 1))
        sched.submit(Request(
            rid=rid, prompt=task.sample(rng, 1, plen)[0],
            max_new=int(rng.integers(max(args.max_new // 4, 1),
                                     args.max_new + 1)),
            policy=str(rng.choice(names)) if groups else None))
    t0 = time.perf_counter()
    finished = sched.run()
    wall = time.perf_counter() - t0
    engine.release_followers()
    stats = aggregate_stats(finished, wall)
    print(f"[serve] engine: {n} requests over {args.batch} slots "
          f"(sched={args.sched}, "
          f"{'groups=' + str(groups) if groups else 'policy=' + engine.policy.name}"
          f", {dec.cache_backend} cache, prefill_slots={args.prefill_slots}, "
          f"steps_per_sync={args.steps_per_sync}) on {_where(engine)}")
    print(f"[serve] {stats['total_tokens']} tokens in "
          f"{stats['total_invocations']} invocations, "
          f"{stats['tokens_per_sec']:.1f} tok/s, "
          f"p50 {stats['latency_p50_s'] * 1e3:.0f}ms / "
          f"p95 {stats['latency_p95_s'] * 1e3:.0f}ms, "
          f"builds {engine.compile_counts()}")
    for f in sorted(finished, key=lambda f: f.rid):
        print(f"    req {f.rid} [{f.policy}]: k̂={f.mean_accepted:.2f} "
              f"gen={f.generated} inv={f.invocations} "
              f"out={[int(x) for x in f.tokens]}")
    return {"finished": finished, "stats": stats, "engine": engine,
            "cfg": cfg, "dec": dec, "params": params}


def _where(engine) -> str:
    mesh = engine.mesh
    if mesh is None:
        return f"{engine.session.device}"
    return (f"mesh {mesh.shape} of {mesh.size} ranks ({mesh.backend}), rank "
            f"0 on {engine.session.device}")


def serve_http(params, cfg, dec, args, groups, bundles=None,
               mesh=None) -> Dict:
    """Serve the engine over HTTP/SSE until drained (SIGTERM, SIGINT or
    POST /drain); ``--http-demo`` streams one request and exits.  On a
    mesh the server and the scheduler run on rank 0, whose shutdown
    releases the other ranks (``release_followers``); they replay its
    plans meanwhile and return their finish records."""
    engine = _engine(params, cfg, dec, args, groups, bundles, mesh)
    if mesh is not None and mesh.index:
        return {"engine": engine, "finished": engine.follow()}
    frontend = Frontend(Scheduler(engine, policy=args.sched),
                        max_queue=args.max_queue)
    srv = HTTPServer(frontend, host=args.host, port=args.port)
    out: Dict = {"engine": engine}

    async def run():
        await srv.start()
        loop = asyncio.get_running_loop()
        try:
            loop.add_signal_handler(signal.SIGTERM, srv.begin_drain)
            loop.add_signal_handler(signal.SIGINT, srv.begin_drain)
        except (NotImplementedError, RuntimeError):   # not the main thread
            pass
        mode = (f"disaggregated prefill_slots={args.prefill_slots}"
                if args.prefill_slots else "unified")
        print(f"[serve] http on {srv.host}:{srv.port} — POST /v1/generate "
              f"/drain, GET /healthz /readyz /metrics (slots={args.batch}, "
              f"sched={args.sched}, max_queue={args.max_queue}, {mode}) on "
              f"{_where(engine)}", flush=True)
        if args.http_demo:
            out["demo"] = await _http_demo(srv)
            await srv.stop()
        else:
            await srv.serve_forever()
            print("[serve] drained — exiting", flush=True)

    asyncio.run(run())
    engine.release_followers()
    out["finished"] = frontend.scheduler.finished
    return out


async def _http_demo(srv) -> Dict:
    """One streamed request against the live server over a real socket;
    raises SystemExit unless /healthz and /readyz answer 200 and the SSE
    token events equal the done payload."""
    async def fetch(raw: bytes) -> str:
        r, w = await asyncio.open_connection(srv.host, srv.port)
        w.write(raw)
        await w.drain()
        data = await r.read()
        w.close()
        return data.decode()

    for path in ("/healthz", "/readyz"):
        status = (await fetch(f"GET {path} HTTP/1.1\r\nHost: {srv.host}"
                              f"\r\n\r\n".encode())).splitlines()[0]
        print(f"[serve] {path} -> {status}")
        if "200" not in status:
            raise SystemExit(f"--http-demo: {path} returned {status!r}")
    body = json.dumps({"prompt": [5, 6, 7, 8], "max_new": 12,
                       "stream": True}).encode()
    raw = await fetch(b"POST /v1/generate HTTP/1.1\r\n"
                      + f"Host: {srv.host}\r\n".encode()
                      + f"Content-Length: {len(body)}\r\n\r\n".encode()
                      + body)
    print("[serve] SSE stream:")
    print("    " + "\n    ".join(ln for ln in raw.splitlines() if ln))
    events, cur = [], None
    for ln in raw.splitlines():
        if ln.startswith("event: "):
            cur = ln[7:]
        elif ln.startswith("data: ") and cur is not None:
            events.append((cur, json.loads(ln[6:])))
    tokens = [t for kind, d in events if kind == "token" for t in d["tokens"]]
    dones = [d for kind, d in events if kind == "done"]
    if not tokens or not dones:
        raise SystemExit("--http-demo: stream missing token/done SSE events")
    if tokens != dones[0]["tokens"]:
        raise SystemExit("--http-demo: streamed tokens disagree with the "
                         "done payload")
    print(f"[serve] demo ok: {dones[0]['generated']} tokens streamed, "
          f"k̂={dones[0]['mean_accepted']:.2f}")
    return dones[0]


if __name__ == "__main__":
    main()

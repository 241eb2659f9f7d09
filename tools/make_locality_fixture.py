#!/usr/bin/env python3
"""Write the trained locality fixture: the reference's two image-decoding
models of ``benchmarks/policy_sweep.run_locality`` and its own decode of
them, which the PyTorch port is held to.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/make_locality_fixture.py

This is the JAX reference's side of the fixture (about 80 s on a CPU).  It
trains both arms exactly as ``run_locality`` does at its defaults
(``policy_sweep._train_field_model``: piecewise-bilinear ordinal fields on
an 8 × 8 grid, stride 2, 16 levels; a 2-layer causal LM, 1200 steps, then
k 4 heads attached and fine-tuned on the frozen base for 400 steps; seed
0), one arm on the progressive-lattice order and one on the raster order,
and writes under ``tests/data/locality``:

- ``locality/`` and ``raster/``: each arm's ``checkpoint/step_<N>/`` (read
  by ``repro_torch.bridge.load_checkpoint``) and ``config.json``;
- ``grids.npy``: the 8 evaluation fields (8, 8, 8), drawn as
  ``run_locality`` draws them (seed 42);
- ``reference.json``: for ``locality`` (the lattice model under the
  ``locality`` policy), ``locality_exact`` (the same model and prompts,
  heads-drafted ``exact``) and ``locality_raster`` (the raster model,
  ``exact``), each row decoded alone from its coarse prompt through a
  jitted ``DecodeSession`` as ``_decode_field`` decodes it: its tokens,
  iterations and generated count, and the rows' iterations per token, k̂
  and reconstruction MAE as ``_decode_field`` computes them.

Training on a CPU does not give the same weights in every environment, so
the weights are committed rather than retrained.  The script prints its
numbers beside ``BENCH_decode.json``'s locality rows and does not write
that file.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (ROOT, os.path.join(ROOT, "src")):
    if path not in sys.path:
        sys.path.insert(0, path)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from benchmarks import policy_sweep as ps  # noqa: E402
from repro import checkpoint  # noqa: E402
from repro.config import DecodeConfig  # noqa: E402

SEED, PRETRAIN_STEPS, HEAD_STEPS, EVAL_ROWS = 0, 1200, 400, 8
ROWS = {"locality": ("locality", "locality"),          # row -> (arm, policy)
        "locality_exact": ("locality", "exact"),
        "locality_raster": ("raster", "exact")}
OUT = os.path.join(ROOT, "tests", "data", "locality")


def eval_grids(field) -> np.ndarray:
    """The (8, 8, 8) int32 fields ``run_locality`` decodes."""
    return field.sample_grid(np.random.default_rng(SEED + 42), EVAL_ROWS)


def decode_config(policy: str, start: int) -> DecodeConfig:
    """``_decode_field``'s config: the rest of the grid after ``start``
    coarse pixels."""
    return DecodeConfig(max_new_tokens=ps.LOC_H * ps.LOC_W - start,
                        block_k=ps.LOC_K, policy=policy, image_height=ps.LOC_H,
                        image_width=ps.LOC_W, locality_stride=ps.LOC_STRIDE)


def reference_decode(field, cfg, params, policy: str, grids: np.ndarray) -> dict:
    """Each row decoded alone from its coarse prompt, as ``_decode_field``."""
    from repro.serving import DecodeSession

    n = ps.LOC_H * ps.LOC_W
    stream = field.serialize(grids)
    start = field.coarse_len
    sess = DecodeSession(params, cfg, decode_config(policy, start), jit=True)
    rows, toks = [], []
    for r in range(grids.shape[0]):
        t, stats = sess.decode({"tokens": jnp.asarray(stream[r:r + 1, :start])})
        toks.append(np.asarray(t)[:, :n])
        rows.append({"tokens": toks[-1][0].tolist(),
                     "iterations": int(stats["iterations"]),
                     "generated": int(np.asarray(stats["generated"]).sum())})
    iters = sum(r["iterations"] for r in rows)
    gen = sum(r["generated"] for r in rows)
    mae = float(np.abs(field.to_grid(np.concatenate(toks)).astype(int)
                       - grids.astype(int)).mean())
    return {"iters_per_token": iters / max(gen, 1),
            "mean_khat": gen / max(iters, 1), "mae": mae, "rows": rows}


def main() -> int:
    t0 = time.perf_counter()
    arms = {}
    for order in ("locality", "raster"):
        arms[order] = ps._train_field_model(
            order, pretrain_steps=PRETRAIN_STEPS, head_steps=HEAD_STEPS,
            seed=SEED)
        print(f"trained the {order} arm in {time.perf_counter() - t0:.1f}s")
    os.makedirs(OUT, exist_ok=True)
    for order, (_, cfg, params) in arms.items():
        params = jax.tree_util.tree_map(np.asarray, params)
        arms[order] = (arms[order][0], cfg, params)
        checkpoint.save(os.path.join(OUT, order, "checkpoint"),
                        PRETRAIN_STEPS + HEAD_STEPS, params, keep=1)
        with open(os.path.join(OUT, order, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(cfg), f, indent=1, sort_keys=True)
            f.write("\n")
    grids = eval_grids(arms["locality"][0])
    np.save(os.path.join(OUT, "grids.npy"), grids)

    ref = {name: reference_decode(*arms[arm], policy, grids)
           for name, (arm, policy) in ROWS.items()}
    with open(os.path.join(OUT, "reference.json"), "w") as f:
        json.dump(ref, f, separators=(",", ":"))
        f.write("\n")

    lossless = ([r["tokens"] for r in ref["locality"]["rows"]]
                == [r["tokens"] for r in ref["locality_exact"]["rows"]])
    with open(os.path.join(ROOT, "BENCH_decode.json")) as f:
        bench = json.load(f)["rows"]
    for name in ROWS:
        committed = {key: bench.get(f"policies/{name}/{key}")
                     for key in ("iters_per_token", "mean_khat", "mae")}
        print(f"{name:>16}: iterations/token "
              f"{ref[name]['iters_per_token']:.4f}, k̂ "
              f"{ref[name]['mean_khat']:.4f}, MAE {ref[name]['mae']:.4f} "
              f"(BENCH_decode.json: {committed})")
    print(f"locality emits locality_exact's tokens: {lossless}")
    print(f"wrote {OUT} in {time.perf_counter() - t0:.1f}s")
    return 0 if lossless else 1


if __name__ == "__main__":
    sys.exit(main())

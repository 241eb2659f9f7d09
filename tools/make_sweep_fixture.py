#!/usr/bin/env python3
"""Write the trained policy-sweep fixture: the reference's checkpoint and its
own decode of it, which the PyTorch port is held to.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/make_sweep_fixture.py

This is the JAX reference's side of the fixture (about 45 s on a CPU).  It
trains the seq2seq copy-task model exactly as ``benchmarks/policy_sweep.run``
does (``pretrain_base(8, pretrain_steps=900, seed=0)``, then
``finetune_heads(..., head_steps=300, seed=0)``), and writes under
``tests/data/policy_sweep``:

- ``checkpoint/step_<N>/arrays.npz`` (and ``meta.msgpack``): the weights,
  saved by ``repro.checkpoint.save``; ``repro_torch.bridge.load_checkpoint``
  reads them with numpy alone;
- ``config.json``: the reference ``ModelConfig``'s fields;
- ``src.npy``: the 16 x 24 evaluation rows, drawn as ``run`` draws them;
- ``reference.json``: for each policy of ``POLICIES`` under
  ``DecodeConfig(max_new_tokens=24, block_k=8, top_k=2, epsilon=2.0)``,
  each row decoded alone at B 1 through a jitted ``DecodeSession`` as
  ``run`` decodes it: its tokens, iterations and generated count, and the
  mean k̂ over the rows as ``run`` computes it.

Training on a CPU does not give the same weights in every environment, so
the weights are committed rather than retrained, and ``reference.json`` is
the reference's decode of these weights.  The script prints its k̂ beside
``BENCH_decode.json``'s and does not write that file.
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

from benchmarks import policy_sweep  # noqa: E402
from repro import checkpoint  # noqa: E402
from repro.config import DecodeConfig  # noqa: E402

K, SEED, PRETRAIN_STEPS, HEAD_STEPS, EVAL_ROWS = 8, 0, 900, 300, 16
POLICIES = ("exact", "topk", "distance", "adaptive", "input_copy", "topk_tree")
OUT = os.path.join(ROOT, "tests", "data", "policy_sweep")


def eval_sources() -> np.ndarray:
    """The (16, 24) int32 rows ``policy_sweep.run`` decodes."""
    rng = np.random.default_rng(SEED + 11)
    return (policy_sweep._copy_task().sample(rng, EVAL_ROWS,
                                             policy_sweep.SRC_LEN)
            + 1).astype(np.int32)


def decode_config(policy: str) -> DecodeConfig:
    return DecodeConfig(max_new_tokens=policy_sweep.SRC_LEN, block_k=K,
                        policy=policy, top_k=2, epsilon=2.0)


def reference_decode(params, cfg, src: np.ndarray) -> dict:
    """Each policy's per-row decode at B 1, as ``policy_sweep.run`` does."""
    from repro.serving import DecodeSession

    out = {}
    for name in POLICIES:
        sess = DecodeSession(params, cfg, decode_config(name), jit=True)
        rows = []
        for r in range(src.shape[0]):
            t, stats = sess.decode_seq2seq({"src": jnp.asarray(src[r:r + 1])})
            rows.append({"tokens": np.asarray(t[0, :src.shape[1]]).tolist(),
                         "iterations": int(stats["iterations"]),
                         "generated": int(stats["generated"][0])})
        khat = float(np.mean([r["generated"] / max(r["iterations"], 1)
                              for r in rows]))
        out[name] = {"mean_khat": khat, "rows": rows}
    return out


def main() -> int:
    t0 = time.perf_counter()
    cfg0, base = policy_sweep.pretrain_base(K, pretrain_steps=PRETRAIN_STEPS,
                                            seed=SEED)
    cfg, params = policy_sweep.finetune_heads(cfg0, base, K,
                                              head_steps=HEAD_STEPS, seed=SEED)
    params = jax.tree_util.tree_map(np.asarray, params)
    n_params = sum(np.size(x) for x in jax.tree_util.tree_leaves(params))
    print(f"trained {n_params} parameters in {time.perf_counter() - t0:.1f}s")

    os.makedirs(OUT, exist_ok=True)
    checkpoint.save(os.path.join(OUT, "checkpoint"),
                    PRETRAIN_STEPS + HEAD_STEPS, params, keep=1)
    with open(os.path.join(OUT, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=1, sort_keys=True)
        f.write("\n")
    src = eval_sources()
    np.save(os.path.join(OUT, "src.npy"), src)

    ref = reference_decode(params, cfg, src)
    with open(os.path.join(OUT, "reference.json"), "w") as f:
        json.dump(ref, f, separators=(",", ":"))
        f.write("\n")

    with open(os.path.join(ROOT, "BENCH_decode.json")) as f:
        bench = json.load(f)["rows"]
    for name in POLICIES:
        committed = bench.get(f"policies/{name}/mean_khat")
        print(f"{name:>10}: k̂ {ref[name]['mean_khat']:.4f} "
              f"(BENCH_decode.json: {committed})")
    print(f"wrote {OUT} in {time.perf_counter() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Write the trained quickstart fixture: the reference's checkpoint of
``examples/quickstart.py``'s model and its own decode of it, which the
PyTorch port is held to.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/make_quickstart_fixture.py

This is the JAX reference's side of the fixture (about 20 s on a CPU).  It
trains exactly as ``examples/quickstart.py`` does at its defaults (the
``quickstart`` config: 2 layers, d 96 over 4 heads of 24 and 2 KV heads,
vocab 32, k 4; MarkovLM at temperature 0.12, seed 3; 300 steps at lr 3e-3,
warm-up 30, ``head_loss="mean"``, batches from seed 1, keys from
``PRNGKey(1)``), and writes under ``tests/data/quickstart``:

- ``checkpoint/step_<N>/arrays.npz`` (and ``meta.msgpack``), saved by
  ``repro.checkpoint.save``; ``repro_torch.bridge.load_checkpoint`` reads
  them with numpy alone;
- ``config.json``: the reference ``ModelConfig``'s fields;
- ``prompts.npy``: quickstart's 8 prompts of 12 tokens (seed 9);
- ``reference.json``: greedy and BPD exact of the 8 prompts as one batch,
  48 new tokens at block_k 4, as quickstart decodes them: the tokens (the
  prompt and 48 new ones, per row), iterations, invocations, generated
  counts and mean k̂.

Training on a CPU does not give the same weights in every environment, so
the weights are committed rather than retrained, and ``reference.json`` is
the reference's decode of these weights.
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

from repro import checkpoint  # noqa: E402
from repro.config import DecodeConfig, ModelConfig, TrainConfig  # noqa: E402
from repro.core import decode as D  # noqa: E402
from repro.data.synthetic import MarkovLM  # noqa: E402
from repro.launch import steps as steps_lib  # noqa: E402
from repro.models import model as M  # noqa: E402
from repro.optim import optimizer_init  # noqa: E402

STEPS, K, MAX_NEW, ROWS, PROMPT_LEN = 300, 4, 48, 8, 12
OUT = os.path.join(ROOT, "tests", "data", "quickstart")


def quickstart_config() -> ModelConfig:
    return ModelConfig(name="quickstart", num_layers=2, d_model=96,
                       num_heads=4, num_kv_heads=2, d_ff=192, vocab_size=32,
                       bpd_k=K, max_seq_len=256, dtype="float32")


def task() -> MarkovLM:
    return MarkovLM(vocab=32, temperature=0.12, seed=3)


def prompts() -> np.ndarray:
    """The (8, 12) int32 prompts quickstart decodes."""
    return task().sample(np.random.default_rng(9), ROWS, PROMPT_LEN)


def decode_config() -> DecodeConfig:
    return DecodeConfig(max_new_tokens=MAX_NEW, block_k=K, criterion="exact")


def train(cfg: ModelConfig):
    """quickstart's training loop, step for step."""
    tc = TrainConfig(global_batch=16, seq_len=48, lr=3e-3, warmup_steps=30,
                     head_loss="mean")
    params = M.init(jax.random.PRNGKey(0), cfg)
    opt = optimizer_init(params, tc)
    step = jax.jit(steps_lib.make_train_step(cfg, tc))
    gen = task().batches(batch=tc.global_batch, seq_len=tc.seq_len, seed=1)
    key = jax.random.PRNGKey(1)
    loss = float("nan")
    for _ in range(STEPS):
        key, sub = jax.random.split(key)
        batch = {k: jnp.asarray(v) for k, v in next(gen).items()}
        params, opt, metrics = step(params, opt, batch, sub)
        loss = float(metrics["loss"])
    return params, loss


def reference_decode(params, cfg, prompt: np.ndarray) -> dict:
    """BPD exact and greedy of the prompts as one batch, as quickstart."""
    dec = decode_config()
    batch = {"tokens": jnp.asarray(prompt)}
    n = prompt.shape[1] + MAX_NEW
    out = {}
    for name, fn in (("bpd", D.bpd_decode), ("greedy", D.greedy_decode)):
        toks, stats = jax.jit(lambda b, fn=fn: fn(params, cfg, dec, b))(batch)
        out[name] = {"tokens": np.asarray(toks[:, :n]).tolist(),
                     "iterations": int(stats["iterations"]),
                     "invocations": int(stats["invocations"]),
                     "generated": np.asarray(stats["generated"]).tolist(),
                     "mean_accepted": float(stats["mean_accepted"])}
    return out


def main() -> int:
    t0 = time.perf_counter()
    cfg = quickstart_config()
    params, loss = train(cfg)
    params = jax.tree_util.tree_map(np.asarray, params)
    print(f"trained {cfg.name} for {STEPS} steps in "
          f"{time.perf_counter() - t0:.1f}s, last loss {loss:.4f}")

    os.makedirs(OUT, exist_ok=True)
    checkpoint.save(os.path.join(OUT, "checkpoint"), STEPS, params, keep=1)
    with open(os.path.join(OUT, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=1, sort_keys=True)
        f.write("\n")
    prompt = prompts()
    np.save(os.path.join(OUT, "prompts.npy"), prompt)
    ref = reference_decode(params, cfg, prompt)
    with open(os.path.join(OUT, "reference.json"), "w") as f:
        json.dump(ref, f, separators=(",", ":"))
        f.write("\n")
    same = ref["bpd"]["tokens"] == ref["greedy"]["tokens"]
    print(f"BPD == greedy: {same}; k̂ {ref['bpd']['mean_accepted']:.4f}; "
          f"invocations BPD {ref['bpd']['invocations']} vs greedy "
          f"{ref['greedy']['invocations']}")
    print(f"wrote {OUT} in {time.perf_counter() - t0:.1f}s")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())

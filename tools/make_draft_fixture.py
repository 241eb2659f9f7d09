#!/usr/bin/env python3
"""Write the pinned draft-model fixture: two distilled students of the
committed policy-sweep teacher and the reference's own decode with each,
which the PyTorch port is held to.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/make_draft_fixture.py

This is the JAX reference's side of the fixture.  It restores the teacher
from ``tests/data/policy_sweep/checkpoint`` (``repro.checkpoint``; it never
retrains it), distills it as ``benchmarks/policy_sweep.run`` does
(``distill_student_data(cfg, params, seed=0)``: greedy teacher decodes of
64 source batches, BOS-prefixed), trains the gold-prefix and the
scheduled-sampling student with ``policy_sweep.train_student`` (900 steps
each, seed 0), and writes under ``tests/data/draft_model``:

- ``gold/step_<N>/`` and ``ss/step_<N>/``: the two students' weights,
  saved by ``repro.checkpoint.save``; ``repro_torch.bridge.load_checkpoint``
  reads them with numpy alone;
- ``config.json``: the student's ``ModelConfig`` fields (both share it);
- ``reference.json``: for ``draft_model`` (gold student) and
  ``ss_draft_model`` (scheduled-sampling student), each of the sweep
  fixture's 16 source rows (``tests/data/policy_sweep/src.npy``) decoded
  alone at B 1 through a jitted ``DecodeSession`` under
  ``DecodeConfig(max_new_tokens=24, block_k=8, policy="draft_model")``, as
  ``tools/make_sweep_fixture.py`` decodes its rows: tokens, iterations and
  generated count, the mean k̂ over the rows, and ``draft_steps_per_iter``
  / ``draft_steps_saved`` as ``policy_sweep.run`` reports them.

Training on a CPU does not give the same weights in every environment, so
the weights are committed rather than retrained.  The script prints its k̂
beside ``BENCH_decode.json``'s ``draft_model`` / ``ss_draft_model`` rows and
writes neither that file nor the sweep fixture.
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
from repro.config import DecodeConfig, ModelConfig  # noqa: E402
from repro.core.bundle import ModelBundle  # noqa: E402
from repro.models import seq2seq as S  # noqa: E402

K, SEED, STUDENT_STEPS = 8, 0, 900
TEACHER = os.path.join(ROOT, "tests", "data", "policy_sweep")
OUT = os.path.join(ROOT, "tests", "data", "draft_model")
ROWS = {"draft_model": "gold", "ss_draft_model": "ss"}   # row -> student


def load_teacher():
    """The committed sweep teacher: its config and restored weights."""
    with open(os.path.join(TEACHER, "config.json")) as f:
        fields = json.load(f)
    fields["global_attn_layers"] = tuple(fields["global_attn_layers"])
    cfg = ModelConfig(**fields)
    template = S.init(jax.random.PRNGKey(0), cfg)
    params, _ = checkpoint.restore(os.path.join(TEACHER, "checkpoint"),
                                   template)
    return cfg, params


def reference_decode(params, cfg, dcfg, dparams, src: np.ndarray) -> dict:
    """Each row decoded alone at B 1 with the student as the draft bundle."""
    from repro.serving import DecodeSession

    dec = DecodeConfig(max_new_tokens=src.shape[1], block_k=K,
                       policy="draft_model")
    sess = DecodeSession(params, cfg, dec, jit=True,
                         bundles={"draft": ModelBundle(dparams, dcfg)})
    rows = []
    for r in range(src.shape[0]):
        t, stats = sess.decode_seq2seq({"src": jnp.asarray(src[r:r + 1])})
        rows.append({"tokens": np.asarray(t[0, :src.shape[1]]).tolist(),
                     "iterations": int(stats["iterations"]),
                     "generated": int(stats["generated"][0])})
    khat = float(np.mean([r["generated"] / max(r["iterations"], 1)
                          for r in rows]))
    steps = sess.policy.drafter.draft_steps_per_iter(K)
    return {"mean_khat": khat, "draft_steps_per_iter": float(steps),
            "draft_steps_saved": float(K - steps), "rows": rows}


def main() -> int:
    t0 = time.perf_counter()
    cfg, params = load_teacher()
    distilled = policy_sweep.distill_student_data(cfg, params, seed=SEED)
    print(f"distilled {len(distilled)} batches in "
          f"{time.perf_counter() - t0:.1f}s")
    students = {}
    for name, ss in (("gold", False), ("ss", True)):
        dcfg, dparams = policy_sweep.train_student(
            distilled, student_steps=STUDENT_STEPS, seed=SEED,
            scheduled_sampling=ss)
        students[name] = jax.tree_util.tree_map(np.asarray, dparams)
        print(f"trained the {name} student in {time.perf_counter() - t0:.1f}s")

    os.makedirs(OUT, exist_ok=True)
    for name, dparams in students.items():
        checkpoint.save(os.path.join(OUT, name), STUDENT_STEPS, dparams,
                        keep=1)
    with open(os.path.join(OUT, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(dcfg), f, indent=1, sort_keys=True)
        f.write("\n")

    src = np.load(os.path.join(TEACHER, "src.npy"))
    ref = {row: reference_decode(params, cfg, dcfg, students[name], src)
           for row, name in ROWS.items()}
    with open(os.path.join(OUT, "reference.json"), "w") as f:
        json.dump(ref, f, separators=(",", ":"))
        f.write("\n")

    with open(os.path.join(ROOT, "BENCH_decode.json")) as f:
        bench = json.load(f)["rows"]
    for row in ROWS:
        committed = bench.get(f"policies/{row}/mean_khat")
        print(f"{row:>15}: k̂ {ref[row]['mean_khat']:.4f} "
              f"(BENCH_decode.json: {committed}), draft steps per iteration "
              f"{ref[row]['draft_steps_per_iter']}, saved "
              f"{ref[row]['draft_steps_saved']}")
    print(f"wrote {OUT} in {time.perf_counter() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())

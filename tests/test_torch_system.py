"""The port's twin of tests/test_system.py: train a small combined
scoring/proposal model through the port's own training step on the CPU,
then show the paper's effect with the port's decode — BPD needs fewer model
invocations than greedy while producing the identical output.

The recipe is the reference's (``tiny_dense(vocab_size=32, bpd_k=4,
d_model=96, d_ff=192)``, MarkovLM at temperature 0.12 with seed 3, 250
steps at lr 3e-3 with warm-up 20 and ``head_loss="mean"``); the weights
are the port's own from seed 0, the head draws from a host generator
seeded 1.  So the numbers are not the reference's, the bounds are."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import tiny_dense  # noqa: E402
from repro_torch import checkpoint  # noqa: E402
from repro_torch.config import DecodeConfig, ModelConfig, TrainConfig  # noqa: E402
from repro_torch.core import decode as D  # noqa: E402
from repro_torch.data.synthetic import MarkovLM  # noqa: E402
from repro_torch.launch import steps as steps_lib  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import optimizer_init  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def trained_lm():
    """Small dense LM trained on a low-entropy Markov chain (predictable
    enough that the heads learn to forecast several tokens)."""
    cfg = ModelConfig(**dataclasses.asdict(
        tiny_dense(vocab_size=32, bpd_k=4, d_model=96, d_ff=192)))
    tc = TrainConfig(global_batch=16, seq_len=48, lr=3e-3, warmup_steps=20,
                     head_loss="mean")
    task = MarkovLM(vocab=cfg.vocab_size, temperature=0.12, seed=3)
    params = M.init(cfg, seed=0, device="cpu")
    opt = optimizer_init(params, tc)
    step = steps_lib.make_train_step(cfg, tc)
    gen = task.batches(batch=tc.global_batch, seq_len=tc.seq_len, seed=1)
    draws = torch.Generator().manual_seed(1)
    for _ in range(250):
        batch = {k: torch.as_tensor(v) for k, v in next(gen).items()}
        params, opt, metrics = step(params, opt, batch, draws)
    return cfg, params, task, float(metrics["loss"])


def _prompts(task, seed, rows, length):
    return {"tokens": torch.as_tensor(task.sample(np.random.default_rng(seed),
                                                  rows, length))}


def test_training_converged(trained_lm):
    _, _, _, loss = trained_lm
    assert loss < 2.4           # well below log(32) ~ 3.47


def test_bpd_speedup_and_equivalence_after_training(trained_lm):
    cfg, params, task, _ = trained_lm
    batch = _prompts(task, 9, 8, 12)
    dec = DecodeConfig(max_new_tokens=32, block_k=4, criterion="exact")
    bt, bs = D.bpd_decode(params, cfg, dec, batch)
    gt, gs = D.greedy_decode(params, cfg, dec, batch)
    assert torch.equal(bt[:, :44], gt[:, :44])
    mean_k = bs["mean_accepted"]
    assert mean_k > 1.5, f"trained heads should accept blocks, got {mean_k}"
    assert bs["invocations"] < gs["invocations"]


def test_invocation_accounting(trained_lm):
    """Paper §4: a combined model needs ~ m/k̂ + 1 invocations for m tokens."""
    cfg, params, task, _ = trained_lm
    dec = DecodeConfig(max_new_tokens=24, block_k=4)
    _, bs = D.bpd_decode(params, cfg, dec, _prompts(task, 10, 4, 12))
    bound = 24 / bs["mean_accepted"] + 1
    assert bs["invocations"] <= bound * 1.35 + 1   # per-row k̂ variance slack


def test_checkpoint_roundtrip_preserves_decode(trained_lm, tmp_path):
    cfg, params, task, _ = trained_lm
    checkpoint.save(str(tmp_path), 1, params)
    restored, _ = checkpoint.restore(str(tmp_path), M.init(cfg, device="cpu"))
    batch = _prompts(task, 11, 2, 10)
    dec = DecodeConfig(max_new_tokens=12, block_k=4)
    t1, _ = D.bpd_decode(params, cfg, dec, batch)
    t2, _ = D.bpd_decode(restored, cfg, dec, batch)
    assert torch.equal(t1, t2)

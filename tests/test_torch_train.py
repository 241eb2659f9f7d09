"""The port's training path against the JAX reference on the CPU, in fp32:
the §6 losses (their values and every leaf's gradient against ``jax.grad``),
scheduled sampling, short training runs, the synthetic tasks,
distillation, the data pipeline and the refusals (``conftest`` geometry;
weights made by the reference and carried across by ``bridge``).

The two frameworks' random streams differ, so each test computes the
reference's own draws from its key (the head index, the swap mask) and
hands them to the port through ``head_idx=`` / ``swap=``.

Tolerances (fp32): scalars rtol 1e-5 / atol 1e-6; a tree's leaves rtol
1e-5 and atol 1e-5 × the leaf's max |value|.  A gradient summed over many
positions is large where the noise of its terms is not (tiny_dense's
embed/table: max |g| 3.1, the two frameworks 3.3e-6 apart, 1.1e-6 of the
max), so an absolute atol would hold big leaves to a tighter relative
bound than small ones."""
import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_dense, tiny_seq2seq  # noqa: E402
from repro import config as jconfig  # noqa: E402
from repro.core import distill as jdistill  # noqa: E402
from repro.core import heads as jheads  # noqa: E402
from repro.core import train as jtrain  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import seq2seq as jseq2seq  # noqa: E402
from repro.utils.tree import flatten_with_names as jflatten  # noqa: E402
from repro_torch import bridge, config as tconfig  # noqa: E402
from repro_torch.core import distill as tdistill  # noqa: E402
from repro_torch.core import heads as theads  # noqa: E402
from repro_torch.core import train as ttrain  # noqa: E402
from repro_torch.data import pipeline as tpipeline  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.optim import freeze_mask, optimizer_init  # noqa: E402
from repro_torch.utils.tree import flatten_with_names  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-6)


def port_cfg(jcfg):
    return tconfig.ModelConfig(**dataclasses.asdict(jcfg))


def port_tc(jtc):
    return tconfig.TrainConfig(**dataclasses.asdict(jtc))


def bridged(jcfg, jp):
    return bridge.from_jax_params(jax.tree_util.tree_map(np.asarray, jp),
                                  port_cfg(jcfg), device="cpu")


@pytest.fixture(scope="module")
def dense():
    jcfg = tiny_dense()
    return jcfg, jmodel.init(jax.random.PRNGKey(0), jcfg)


@pytest.fixture(scope="module")
def dense_tied():
    """The tied-embedding layout (granite's): the table gets gradients
    through the lookup and through the vocab projection."""
    jcfg = tiny_dense(tie_embeddings=True)
    return jcfg, jmodel.init(jax.random.PRNGKey(1), jcfg)


@pytest.fixture(scope="module")
def s2s():
    jcfg = tiny_seq2seq()
    return jcfg, jseq2seq.init(jax.random.PRNGKey(0), jcfg)


def lm_batch(cfg, b=3, s=12, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}


def s2s_batch(cfg, b=3, ss=7, st=10, seed=2, tgt_mask=False):
    rng = np.random.default_rng(seed)
    out = {"src": rng.integers(1, cfg.vocab_size, (b, ss)).astype(np.int32),
           "tgt": rng.integers(1, cfg.vocab_size, (b, st)).astype(np.int32)}
    if tgt_mask:
        m = np.ones((b, st), bool)
        m[0, st - 3:] = False
        m[2, st - 1:] = False
        out["tgt_mask"] = m
    return out


def to_torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def ref_draws(key, jcfg, jtc, shape):
    """The reference's head index and swap mask for ``key``, drawn as
    ``lm_loss`` / ``seq2seq_loss`` draw them."""
    swap = None
    if jtc.scheduled_sampling:
        key, mix_key = jax.random.split(key)
        swap = np.asarray(jax.random.bernoulli(mix_key, jtc.ss_ratio, shape))
    head = jtrain._sample_head(key, jcfg, jtc)
    return (None if head is None else int(head)), swap


def key_for_head(idx, jcfg, jtc, shape):
    """A key under which the reference's loss draws head ``idx``."""
    for n in range(500):
        key = jax.random.PRNGKey(n)
        if ref_draws(key, jcfg, jtc, shape)[0] == idx:
            return key
    raise AssertionError(f"no key draws head {idx}")


def port_grads(tp):
    """{name: gradient} of every leaf after a backward: a leaf autograd
    did not reach has a zero gradient, as under ``jax.grad``."""
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p))
            for n, p in flatten_with_names(tp)}


def assert_leaf_close(got, want, name):
    want = np.asarray(want)
    atol = 1e-5 * float(np.abs(want).max(initial=0.0))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol, err_msg=name)


def assert_tree_close(port, ref, names=None):
    ref_flat = dict(jflatten(ref))
    names = names if names is not None else sorted(ref_flat)
    assert set(port) >= set(names)
    for n in names:
        assert_leaf_close(port[n].detach().numpy(), ref_flat[n], n)


def run_loss(kind, jcfg, jp, jtc, batch, key):
    """(reference loss, reference grads, port loss, port grads, port
    metrics) of one loss on the same weights, batch and draws."""
    jloss_fn = jtrain.lm_loss if kind == "lm" else jtrain.seq2seq_loss
    tloss_fn = ttrain.lm_loss if kind == "lm" else ttrain.seq2seq_loss
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jloss_fn(p, jcfg, jtc, jb, key), has_aux=True)(jp)
    shape = batch["tokens"].shape if kind == "lm" else batch["tgt"].shape
    head, swap = ref_draws(key, jcfg, jtc, shape)
    tcfg, ttc = port_cfg(jcfg), port_tc(jtc)
    tp = bridged(jcfg, jp)
    tmodel.set_trainable(tp, tsteps.differentiated(tcfg, ttc, tp))
    tl, tm = tloss_fn(tp, tcfg, ttc, to_torch(batch), None, head_idx=head,
                      swap=None if swap is None else torch.tensor(swap))
    tl.backward()
    return jl, jm, jg, tl, tm, port_grads(tp)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


def test_train_config_fields_match_reference():
    ref = {f.name: f.default for f in dataclasses.fields(jconfig.TrainConfig)}
    port = {f.name: f.default for f in dataclasses.fields(tconfig.TrainConfig)}
    assert port == ref


@pytest.mark.parametrize("kw,match", [
    (dict(head_loss="banana"), "head_loss.*random.*mean"),
    (dict(ss_ratio=1.5), "ss_ratio"),
    (dict(ss_anneal_steps=-3), "ss_anneal_steps"),
])
def test_train_config_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        jconfig.TrainConfig(**kw)
    with pytest.raises(ValueError, match=match):
        tconfig.TrainConfig(**kw)


# ---------------------------------------------------------------------------
# softmax_xent
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["plain", "mask", "smoothing", "z_loss", "all"])
def test_softmax_xent_matches_reference(case):
    rng = np.random.default_rng(3)
    logits = (3 * rng.standard_normal((4, 9, 33))).astype(np.float32)
    targets = rng.integers(0, 33, (4, 9)).astype(np.int32)
    targets[0, :3] = logits[0, :3].argmax(-1)           # some hits
    mask = (rng.random((4, 9)) > 0.3).astype(np.float32)
    kw = {"plain": {}, "mask": dict(mask=mask),
          "smoothing": dict(label_smoothing=0.1), "z_loss": dict(z_loss=1e-3),
          "all": dict(mask=mask, label_smoothing=0.2, z_loss=1e-4)}[case]
    jl, jm = jtrain.softmax_xent(jnp.asarray(logits), jnp.asarray(targets),
                                 **{k: (jnp.asarray(v) if k == "mask" else v)
                                    for k, v in kw.items()})
    tl, tm = ttrain.softmax_xent(torch.as_tensor(logits), torch.as_tensor(targets),
                                 **{k: (torch.as_tensor(v) if k == "mask" else v)
                                    for k, v in kw.items()})
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    np.testing.assert_allclose(float(tm["accuracy"]), float(jm["accuracy"]), **TOL)
    assert float(tm["accuracy"]) > 0


# ---------------------------------------------------------------------------
# heads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("head", [0, 1, 3])
@pytest.mark.parametrize("detach", [False, True])
def test_head_apply_dynamic_value_and_grad(dense, head, detach):
    jcfg, jp = dense
    rng = np.random.default_rng(head)
    hidden = rng.standard_normal((2, 5, jcfg.d_model)).astype(np.float32)

    def jf(p, h):
        out = jheads.head_apply_dynamic(p, jcfg, h, jnp.asarray(head),
                                        detach_residual=detach)
        return jnp.sum(jnp.sin(out))

    jv, (jgp, jgh) = jax.value_and_grad(jf, argnums=(0, 1))(jp["bpd_heads"],
                                                          jnp.asarray(hidden))
    tp = {k: torch.tensor(np.asarray(v), requires_grad=True)
          for k, v in jp["bpd_heads"].items()}
    th = torch.tensor(hidden, requires_grad=True)
    out = theads.head_apply_dynamic(tp, port_cfg(jcfg), th, head,
                                    detach_residual=detach)
    tv = torch.sin(out).sum()
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    assert_leaf_close(th.grad.numpy(), jgh, "hidden")
    for k, v in tp.items():
        got = v.grad if v.grad is not None else torch.zeros_like(v)
        assert_leaf_close(got.numpy(), jgp[k], k)


# ---------------------------------------------------------------------------
# lm_loss / seq2seq_loss: loss and every leaf's gradient
# ---------------------------------------------------------------------------


LM_CASES = {
    "mean": dict(head_loss="mean"),
    "mean_frozen": dict(head_loss="mean", freeze_base=True),
    "random_h0": dict(head=0),
    "random_h1": dict(head=1),
    "random_h2": dict(head=2),
    "random_h3": dict(head=3),
    "frozen_h1": dict(head=1, freeze_base=True),
    "frozen_h3": dict(head=3, freeze_base=True),
    "detach_residual_h2": dict(head=2, detach_head_residual=True),
    "smoothing_h1": dict(head=1, label_smoothing=0.1, z_loss=1e-3),
    "ss_gold_h2": dict(head=2, scheduled_sampling=True, ss_ratio=0.5),
    "ss_self_frozen_h1": dict(head=1, scheduled_sampling=True, ss_ratio=0.5,
                              ss_self_targets=True, freeze_base=True),
    "ss_mean_frozen": dict(head_loss="mean", scheduled_sampling=True,
                           ss_ratio=0.7, ss_self_targets=True, freeze_base=True),
}


def _case(case, jcfg, shape):
    kw = dict(LM_CASES[case])
    head = kw.pop("head", None)
    jtc = jconfig.TrainConfig(**kw)
    key = (key_for_head(head, jcfg, jtc, shape) if head is not None
           else jax.random.PRNGKey(5))
    return jtc, key


def _check_lm_case(jcfg, jp, case):
    batch = lm_batch(jcfg)
    jtc, key = _case(case, jcfg, batch["tokens"].shape)
    jl, jm, jg, tl, tm, tg = run_loss("lm", jcfg, jp, jtc, batch, key)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    np.testing.assert_allclose(float(tm["accuracy"]), float(jm["accuracy"]), **TOL)
    if "head_idx" in jm:
        assert tm["head_idx"] == float(jm["head_idx"])
    assert_tree_close(tg, jg)
    if jtc.freeze_base:      # the trunk gets nothing; the vocab matrix does
        proj = "embed/table" if jcfg.tie_embeddings else "lm_head/w"
        assert float(tg["blocks/0/attn/wq"].abs().sum()) == 0
        assert float(tg[proj].abs().sum()) > 0


@pytest.mark.parametrize("case", sorted(LM_CASES))
def test_lm_loss_and_grads_match_reference(dense, case):
    _check_lm_case(*dense, case)


@pytest.mark.parametrize("case", ["mean", "random_h2", "frozen_h3",
                                  "ss_self_frozen_h1"])
def test_lm_loss_tied_embeddings_match_reference(dense_tied, case):
    _check_lm_case(*dense_tied, case)


S2S_CASES = {
    "mean": dict(head_loss="mean"),
    "random_h0": dict(head=0),
    "random_h2": dict(head=2),
    "frozen_h1": dict(head=1, freeze_base=True),
    "frozen_h3": dict(head=3, freeze_base=True),
    "detach_residual_h3": dict(head=3, detach_head_residual=True),
    "tgt_mask_h1": dict(head=1, tgt_mask=True),
    "tgt_mask_mean": dict(head_loss="mean", tgt_mask=True),
    "ss_gold_h1": dict(head=1, scheduled_sampling=True, ss_ratio=0.5),
    "ss_self_frozen_h2": dict(head=2, scheduled_sampling=True, ss_ratio=0.6,
                              ss_self_targets=True, freeze_base=True),
}


@pytest.mark.parametrize("case", sorted(S2S_CASES))
def test_seq2seq_loss_and_grads_match_reference(s2s, case):
    jcfg, jp = s2s
    kw = dict(S2S_CASES[case])
    head = kw.pop("head", None)
    batch = s2s_batch(jcfg, tgt_mask=kw.pop("tgt_mask", False))
    jtc = jconfig.TrainConfig(**kw)
    key = (key_for_head(head, jcfg, jtc, batch["tgt"].shape) if head is not None
           else jax.random.PRNGKey(6))
    jl, jm, jg, tl, tm, tg = run_loss("s2s", jcfg, jp, jtc, batch, key)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    np.testing.assert_allclose(float(tm["accuracy"]), float(jm["accuracy"]), **TOL)
    assert_tree_close(tg, jg)


def test_random_subloss_is_unbiased_sample_of_heads(dense):
    """The random-head loss at each head index averages to the mean loss
    (the reference's test, on the port with injected indices)."""
    jcfg, jp = dense
    tcfg = port_cfg(jcfg)
    tp = bridged(jcfg, jp)
    batch = to_torch(lm_batch(jcfg, b=4, s=20))
    with torch.no_grad():
        mean, _ = ttrain.lm_loss(tp, tcfg, tconfig.TrainConfig(head_loss="mean",
                                                               z_loss=0.0), batch, None)
        per_head = [float(ttrain.lm_loss(tp, tcfg, tconfig.TrainConfig(z_loss=0.0),
                                         batch, None, head_idx=i)[0])
                    for i in range(tcfg.bpd_k)]
    np.testing.assert_allclose(np.mean(per_head), float(mean), rtol=1e-5)


# ---------------------------------------------------------------------------
# scheduled sampling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 3, 5, 10, 999])
@pytest.mark.parametrize("kw", [dict(scheduled_sampling=True, ss_ratio=0.8,
                                     ss_anneal_steps=10),
                                dict(scheduled_sampling=True, ss_ratio=0.5),
                                dict(ss_ratio=0.5, ss_anneal_steps=10)])
def test_scheduled_sampling_ratio_matches_reference(kw, step):
    assert ttrain.scheduled_sampling_ratio(tconfig.TrainConfig(**kw), step) == \
        jtrain.scheduled_sampling_ratio(jconfig.TrainConfig(**kw), step)


@pytest.mark.parametrize("ratio", [0.0, 1.0])
@pytest.mark.parametrize("kind", ["lm", "s2s"])
def test_ss_mix_matches_reference_at_deterministic_ratios(dense, s2s, kind, ratio):
    """At ratio 0 and 1 the swap mask is fixed, so the port's own generator
    gives the reference's streams: gold (and BOS / position 0) at 0, the
    model's prediction at every later position at 1."""
    jcfg, jp = dense if kind == "lm" else s2s
    batch = lm_batch(jcfg) if kind == "lm" else s2s_batch(jcfg)
    jfn = jtrain.ss_mix_lm if kind == "lm" else jtrain.ss_mix_seq2seq
    tfn = ttrain.ss_mix_lm if kind == "lm" else ttrain.ss_mix_seq2seq
    jmixed, jpred = jfn(jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
                        jax.random.PRNGKey(3), jnp.float32(ratio), with_pred=True)
    tmixed, tpred = tfn(bridged(jcfg, jp), port_cfg(jcfg), to_torch(batch),
                        torch.Generator().manual_seed(0), ratio, with_pred=True)
    np.testing.assert_array_equal(tmixed.numpy(), np.asarray(jmixed))
    np.testing.assert_array_equal(tpred.numpy(), np.asarray(jpred))


def test_ss_mix_draws_from_the_generator(dense):
    """Same generator state, same mixture; position 0 stays gold."""
    jcfg, jp = dense
    tp, tcfg = bridged(jcfg, jp), port_cfg(jcfg)
    batch = to_torch(lm_batch(jcfg, b=4, s=20))
    m1 = ttrain.ss_mix_lm(tp, tcfg, batch, torch.Generator().manual_seed(7), 0.7)
    m2 = ttrain.ss_mix_lm(tp, tcfg, batch, torch.Generator().manual_seed(7), 0.7)
    assert torch.equal(m1, m2)
    assert torch.equal(m1[:, 0], batch["tokens"][:, 0])
    assert bool((m1 != batch["tokens"]).any())


# ---------------------------------------------------------------------------
# short training runs with the port's own generator
# ---------------------------------------------------------------------------


def _train(tcfg, ttc, batches, n_steps, mask=None, seed=0):
    params = tmodel.init(tcfg, seed=seed, device="cpu")
    p0 = {n: p.detach().clone() for n, p in flatten_with_names(params)}
    opt = optimizer_init(params, ttc, mask)
    step = tsteps.make_train_step(tcfg, ttc, mask=mask)
    gen = torch.Generator().manual_seed(seed + 1)
    losses = []
    for _ in range(n_steps):
        params, opt, m = step(params, opt, to_torch(next(batches)), gen)
        losses.append(float(m["loss"]))
    return p0, params, losses


def test_lm_loss_decreases_on_markov_data():
    tcfg = port_cfg(tiny_dense(bpd_k=2, vocab_size=32))
    ttc = tconfig.TrainConfig(global_batch=8, seq_len=32, lr=3e-3,
                              warmup_steps=10, head_loss="random")
    task = tsyn.MarkovLM(vocab=tcfg.vocab_size, temperature=0.15)
    _, _, losses = _train(tcfg, ttc, task.batches(batch=8, seq_len=32), 30)
    assert np.mean(losses[-5:]) < 0.9 * np.mean(losses[:5])


def test_freeze_base_moves_only_heads():
    tcfg = port_cfg(tiny_dense())
    ttc = tconfig.TrainConfig(global_batch=4, seq_len=16, lr=1e-2,
                              freeze_base=True, head_loss="random")
    fm = freeze_mask(tmodel.init(tcfg, device="meta"), train_only_heads=True)
    task = tsyn.MarkovLM(vocab=tcfg.vocab_size)
    p0, p1, _ = _train(tcfg, ttc, task.batches(batch=4, seq_len=16), 5, mask=fm)
    moved = {n: float((p - p0[n]).abs().sum()) for n, p in flatten_with_names(p1)}
    assert sum(v for n, v in moved.items() if n.startswith("bpd_heads")) > 0
    assert sum(v for n, v in moved.items() if not n.startswith("bpd_heads")) == 0


# ---------------------------------------------------------------------------
# synthetic tasks and the pipeline
# ---------------------------------------------------------------------------


TASKS = {
    "markov": (lambda m, seed: m.MarkovLM(vocab=24, temperature=0.2, seed=seed),
               dict(batch=3, seq_len=10)),
    "cipher": (lambda m, seed: m.CipherMT(vocab=40, seed=seed),
               dict(batch=3, src_len=6)),
    "phrase": (lambda m, seed: m.PhraseMT(vocab=40, expand=3, seed=seed),
               dict(batch=3, src_len=5)),
}


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("task", sorted(TASKS))
def test_synthetic_tasks_match_reference(task, seed):
    make, kw = TASKS[task]
    want = make(jsyn, seed).batches(seed=seed + 3, **kw)
    got = make(tsyn, seed).batches(seed=seed + 3, **kw)
    for _ in range(3):
        a, b = next(got), next(want)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_prefetch_keeps_order_and_raises_the_source_error():
    def source():
        for i in range(5):
            yield {"x": np.full((2,), i, np.int32)}
        raise RuntimeError("source broke")

    it = tpipeline.prefetch(source(), depth=2, device="cpu")
    got = [int(next(it)["x"][0]) for _ in range(5)]
    assert got == [0, 1, 2, 3, 4]
    with pytest.raises(RuntimeError, match="source broke"):
        next(it)


def test_prefetch_close_stops_the_worker():
    def endless():
        i = 0
        while True:
            yield {"x": np.full((1,), i)}
            i += 1

    before = threading.active_count()
    it = tpipeline.prefetch(endless(), depth=2, device="cpu")
    assert int(next(it)["x"][0]) == 0
    it.close()
    assert threading.active_count() == before
    assert tpipeline.take(iter(range(10)), 3) == [0, 1, 2]


def test_to_device_makes_tensors():
    out = tpipeline.to_device({"tokens": np.arange(6, dtype=np.int32).reshape(2, 3)},
                              "cpu")
    assert out["tokens"].dtype == torch.int32 and out["tokens"].shape == (2, 3)


# ---------------------------------------------------------------------------
# distillation
# ---------------------------------------------------------------------------


def test_distill_lm_batches_match_reference():
    jcfg = tiny_dense(bpd_k=1, vocab_size=32, bpd_enabled=False)
    jp = jmodel.init(jax.random.PRNGKey(0), jcfg)
    batch = {"tokens": np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (2, 12)).astype(np.int32)}
    want = jdistill.distill_lm_batches(jp, jcfg, [{"tokens": jnp.asarray(batch["tokens"])}],
                                       prompt_len=4, max_new=8)
    got = tdistill.distill_lm_batches(bridged(jcfg, jp), port_cfg(jcfg), [batch],
                                      prompt_len=4, max_new=8)
    np.testing.assert_array_equal(got[0]["tokens"].numpy(), np.asarray(want[0]["tokens"]))
    np.testing.assert_array_equal(got[0]["tokens"].numpy()[:, :4], batch["tokens"][:, :4])


@pytest.mark.parametrize("prompt_len,max_new,match", [
    (4, 4, "cannot fill the stream"), (12, 4, "no positions to distill")])
def test_distill_lm_batches_rejects_short_decode(prompt_len, max_new, match):
    tcfg = port_cfg(tiny_dense(bpd_k=1, vocab_size=32, bpd_enabled=False))
    params = tmodel.init(tcfg, device="cpu")
    batch = {"tokens": torch.zeros((2, 12), dtype=torch.int32)}
    with pytest.raises(ValueError, match=match):
        tdistill.distill_lm_batches(params, tcfg, [batch], prompt_len=prompt_len,
                                    max_new=max_new)


def test_distill_seq2seq_to_causal_batches_match_reference(s2s):
    jcfg, jp = s2s
    srcs = [np.random.default_rng(s).integers(1, jcfg.vocab_size, (2, 6)).astype(np.int32)
            for s in (0, 1)]
    want = jdistill.distill_seq2seq_to_causal_batches(jp, jcfg, srcs, max_new=7)
    got = tdistill.distill_seq2seq_to_causal_batches(bridged(jcfg, jp), port_cfg(jcfg),
                                                     srcs, max_new=7)
    for a, b in zip(got, want):
        assert a["tokens"].shape == (2, 8)
        np.testing.assert_array_equal(a["tokens"].numpy(), np.asarray(b["tokens"]))


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def test_encoder_only_and_unported_families_refused():
    """An audio encoder trains on the masked-prediction loss; a text
    encoder and a vision_text backbone with MoE MLPs, which no registered
    arch uses, raise."""
    assert ttrain.loss_fn_for(port_cfg(tiny_dense(
        is_encoder_only=True, modality="audio"))) is ttrain.masked_prediction_loss
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttrain.loss_fn_for(port_cfg(tiny_dense(is_encoder_only=True)))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttrain.loss_fn_for(port_cfg(jconfig.get_config("llava-next-34b",
                                                       smoke=True)).replace(
            mlp_type="moe", num_experts=4, num_experts_per_tok=2))
    moe = tconfig.get_config("olmoe-1b-7b", smoke=True)     # ported since MoE
    assert ttrain.loss_fn_for(moe) is ttrain.lm_loss


def test_sharding_refused():
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 8"):
        tpipeline.to_device({"x": np.zeros(2)}, "cpu", sharding=object())
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 8"):
        next(tpipeline.prefetch(iter([]), device="cpu", sharding=object()))


def test_text_len_for_matches_reference():
    for cfg in (tiny_dense(), tiny_dense(num_meta_tokens=4)):
        for s in (4, 16, 64):
            assert tsteps.text_len_for(port_cfg(cfg), s) == jsteps.text_len_for(cfg, s)

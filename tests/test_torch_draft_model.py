"""The ``draft_model`` policy (``ModelBundle`` + ``DraftModelDrafter``)
against the JAX reference, on the CPU: twins of tests/test_draft_model.py
on bridged ``tiny_dense`` / ``tiny_seq2seq`` weights and a bridged
``draft_config`` student (d 32 over 2 heads), with and without the
drafter's carry-over.  The port and the reference decode the same batch
to the same tokens, iterations, ``generated`` and k̂ (which are greedy's
tokens); the engine serves the same finish records; the refusals raise the
reference's error types.  Also: the draft's sequential forwards per
iteration counted through a bundle's ``backend_factory``, a self-draft at
k̂ = k, and the launcher's ``--policy draft_model`` static and as an
engine group."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_dense, tiny_rwkv, tiny_seq2seq  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.config import DecodeConfig as JDecodeConfig  # noqa: E402
from repro.config import ModelConfig as JModelConfig  # noqa: E402
from repro.core import decode as jdecode  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.core.bundle import ModelBundle as JModelBundle  # noqa: E402
from repro.core.draft import DraftModelDrafter as JDraftModelDrafter  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import seq2seq as jseq  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.config import DecodeConfig, ModelConfig  # noqa: E402
from repro_torch.core import ModelBundle  # noqa: E402
from repro_torch.core.draft import DraftModelDrafter  # noqa: E402
from repro_torch.core import decode as tdecode  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

torch.set_num_threads(2)


def draft_config(vocab: int) -> JModelConfig:
    return JModelConfig(name="tiny-draft", num_layers=1, d_model=32,
                        num_heads=2, num_kv_heads=2, d_ff=64,
                        vocab_size=vocab, bpd_enabled=False,
                        max_seq_len=512, dtype="float32")


def port(jcfg, jparams):
    """The port's config and the bridged parameters of a reference model."""
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    return tcfg, bridge.from_jax_params(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")


@pytest.fixture(scope="module")
def stack():
    """tests/test_draft_model.py's ``dense_with_draft`` on both sides."""
    jcfg = tiny_dense()
    jp = jmodel.init(jax.random.PRNGKey(0), jcfg)
    jdcfg = draft_config(jcfg.vocab_size)
    jdp = jmodel.init(jax.random.PRNGKey(9), jdcfg)
    tcfg, tp = port(jcfg, jp)
    tdcfg, tdp = port(jdcfg, jdp)
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (3, 6), 0,
                                           jcfg.vocab_size), np.int32)
    return dict(jcfg=jcfg, jp=jp, jdcfg=jdcfg, jdp=jdp, tcfg=tcfg, tp=tp,
                tdcfg=tdcfg, tdp=tdp, tokens=tokens)


def bundles(s, side, self_draft=False):
    if side == "jax":
        return {"draft": JModelBundle(*((s["jp"], s["jcfg"]) if self_draft
                                        else (s["jdp"], s["jdcfg"])))}
    return {"draft": ModelBundle(*((s["tp"], s["tcfg"]) if self_draft
                                   else (s["tdp"], s["tdcfg"])))}


def policies(carry_over, dec_kw):
    """The draft_model policy with ``carry_over`` on both sides."""
    jp = jpolicy.resolve_policy(JDecodeConfig(**dec_kw), "draft_model")
    tp = tpolicy.resolve_policy(DecodeConfig(**dec_kw), "draft_model")
    return (dataclasses.replace(jp, drafter=JDraftModelDrafter(
                carry_over=carry_over)),
            dataclasses.replace(tp, drafter=DraftModelDrafter(
                carry_over=carry_over)))


def assert_same_decode(jout, tout):
    (jt, js), (tt, ts) = jout, tout
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert ts["iterations"] == int(js["iterations"])
    np.testing.assert_array_equal(ts["generated"].numpy(),
                                  np.asarray(js["generated"]))
    assert ts["mean_accepted"] == pytest.approx(float(js["mean_accepted"]),
                                                rel=1e-6)


# ---------------------------------------------------------------------------
# Losslessness: draft_model + exact == greedy_decode, and == the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("carry_over", [True, False])
def test_draft_model_token_identical_to_greedy(stack, carry_over):
    s = stack
    kw = dict(max_new_tokens=12, block_k=4)
    jpol, tpol = policies(carry_over, kw)
    jout = jdecode.bpd_decode(s["jp"], s["jcfg"], JDecodeConfig(**kw),
                              {"tokens": jnp.asarray(s["tokens"])},
                              policy=jpol, bundles=bundles(s, "jax"))
    tout = tdecode.bpd_decode(s["tp"], s["tcfg"], DecodeConfig(**kw),
                              {"tokens": torch.tensor(s["tokens"])},
                              policy=tpol, bundles=bundles(s, "torch"))
    assert_same_decode(jout, tout)
    gt, gs = tdecode.greedy_decode(s["tp"], s["tcfg"], DecodeConfig(**kw),
                                   {"tokens": torch.tensor(s["tokens"])})
    w = s["tokens"].shape[1] + kw["max_new_tokens"]
    assert torch.equal(tout[0][:, :w], gt[:, :w])
    assert torch.equal(tout[1]["generated"], gs["generated"])


@pytest.mark.parametrize("carry_over", [True, False])
def test_draft_model_lossless_seq2seq(carry_over):
    jcfg = tiny_seq2seq()
    jp = jseq.init(jax.random.PRNGKey(2), jcfg)
    jdcfg = draft_config(jcfg.vocab_size)
    jdp = jmodel.init(jax.random.PRNGKey(11), jdcfg)
    tcfg, tp = port(jcfg, jp)
    tdcfg, tdp = port(jdcfg, jdp)
    kw = dict(max_new_tokens=10, block_k=4)
    src = np.asarray(jax.random.randint(jax.random.PRNGKey(3), (2, 6), 1,
                                        jcfg.vocab_size), np.int32)
    jpol, tpol = policies(carry_over, kw)
    jout = jdecode.bpd_decode_seq2seq(
        jp, jcfg, JDecodeConfig(**kw), {"src": jnp.asarray(src)},
        policy=jpol, bundles={"draft": JModelBundle(jdp, jdcfg)})
    tout = tdecode.bpd_decode_seq2seq(
        tp, tcfg, DecodeConfig(**kw), {"src": torch.tensor(src)},
        policy=tpol, bundles={"draft": ModelBundle(tdp, tdcfg)})
    assert_same_decode(jout, tout)
    ref, ref_s = tdecode.bpd_decode_seq2seq(tp, tcfg, DecodeConfig(**kw),
                                            {"src": torch.tensor(src)})
    assert torch.equal(tout[0], ref)
    assert torch.equal(tout[1]["generated"], ref_s["generated"])


def test_good_draft_model_cuts_iterations(stack):
    """A draft model that IS the verifier proposes the verifier's greedy
    continuation, so every block verifies fully: ceil(max_new / block_k)
    iterations, k̂ = k, greedy's tokens, as the reference."""
    s = stack
    kw = dict(max_new_tokens=12, block_k=4)
    batch = {"tokens": torch.tensor(s["tokens"])}
    ref_t, _ = tdecode.bpd_decode(s["tp"], s["tcfg"], DecodeConfig(**kw),
                                  batch)
    tout = tdecode.bpd_decode(s["tp"], s["tcfg"], DecodeConfig(**kw), batch,
                              policy="draft_model",
                              bundles=bundles(s, "torch", self_draft=True))
    assert torch.equal(ref_t, tout[0])
    assert tout[1]["iterations"] == -(-12 // 4)
    assert tout[1]["mean_accepted"] >= 4.0 - 1e-6
    jout = jdecode.bpd_decode(s["jp"], s["jcfg"], JDecodeConfig(**kw),
                              {"tokens": jnp.asarray(s["tokens"])},
                              policy="draft_model",
                              bundles=bundles(s, "jax", self_draft=True))
    assert_same_decode(jout, tout)


@pytest.mark.parametrize("carry_over", [True, False])
def test_draft_forwards_per_iteration(stack, carry_over):
    """The draft's sequential forwards, counted through the bundle's
    ``backend_factory``: ``draft_steps_per_iter`` (k-1 with carry-over, k
    without) for every iteration and for the first draft after the
    prefill; carry-over changes neither tokens nor iterations."""
    s = stack
    kw = dict(max_new_tokens=12, block_k=4)
    calls = []

    def factory(cfg, kv_chunk):
        be = tdecode.causal_lm_backend(cfg)

        def decode_block(p, h, c, ln, tree=None):
            calls.append(h.shape[1])
            return be.decode_block(p, h, c, ln, tree=tree)

        return be._replace(decode_block=decode_block)

    _, tpol = policies(carry_over, kw)
    sess = tserving.DecodeSession(
        s["tp"], s["tcfg"], DecodeConfig(**kw), policy=tpol,
        bundles={"draft": ModelBundle(s["tdp"], s["tdcfg"],
                                      backend_factory=factory)})
    toks, stats = sess.decode({"tokens": torch.tensor(s["tokens"])})
    steps = sess.policy.drafter.draft_steps_per_iter(4)
    assert steps == (3 if carry_over else 4)
    assert len(calls) == steps * (stats["iterations"] + 1)
    assert calls.count(2) == (stats["iterations"] + 1 if carry_over else 0)
    other, other_s = tdecode.bpd_decode(
        s["tp"], s["tcfg"], DecodeConfig(**kw),
        {"tokens": torch.tensor(s["tokens"])},
        policy=policies(not carry_over, kw)[1], bundles=bundles(s, "torch"))
    assert torch.equal(toks, other)
    assert stats["iterations"] == other_s["iterations"]


@pytest.mark.parametrize("carry_over", [True, False])
def test_frozen_rows_keep_their_draft_cache(stack, carry_over):
    """A frozen row (k̂ = 0) leaves its draft cache as it was, as the
    reference's functional freeze does: the port writes caches in place,
    so the drafter re-drafts a frozen row's block from the committed token
    and the row's own slot-0 proposal, rewriting the same values.  One
    live iteration, then one with every row inactive: tokens, proposals
    and the draft cache bit for bit unchanged."""
    s = stack
    dec = DecodeConfig(max_new_tokens=12, block_k=4)
    pol = dataclasses.replace(
        tpolicy.resolve_policy(dec, "draft_model"),
        drafter=DraftModelDrafter(carry_over=carry_over)).bind(
            bundles(s, "torch", self_draft=True), s["tcfg"])
    aux = {"draft": s["tp"]}
    batch = {"tokens": torch.tensor(s["tokens"])}
    state, prefix = tdecode.bpd_prefill_causal_lm(
        s["tp"], s["tcfg"], dec, batch, max_new=12, policy=pol,
        aux_params=aux)
    be = tdecode.causal_lm_backend(s["tcfg"])

    def iterate(st, active=None):
        return tdecode.bpd_iteration(s["tp"], s["tcfg"], dec, be, st,
                                     prefix_offset=prefix, max_new=12,
                                     active=active, policy=pol,
                                     aux_params=aux)

    with torch.no_grad():
        state = iterate(state)
        before = jax.tree_util.tree_map(torch.clone,
                                        state.policy_state.drafter)
        frozen = iterate(state, active=torch.zeros(3, dtype=torch.bool))
    assert torch.equal(frozen.tokens, state.tokens)
    assert torch.equal(frozen.proposals, state.proposals)
    for a, b in zip(jax.tree_util.tree_leaves(frozen.policy_state.drafter),
                    jax.tree_util.tree_leaves(before)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Serving engine: admission prefill + per-slot draft cache lifecycle
# ---------------------------------------------------------------------------


def _manual_run(side, s, dec_kw, policy):
    """tests/test_draft_model.py's engine drive: two slots, the third
    request waits for an eviction, a step between the first two admits."""
    if side == "jax":
        mod, params, cfg, dcls = jserving, s["jp"], s["jcfg"], JDecodeConfig
    else:
        mod, params, cfg, dcls = tserving, s["tp"], s["tcfg"], DecodeConfig
    eng = mod.ContinuousBatchingEngine(
        params, cfg, dcls(**dec_kw),
        mod.EngineConfig(num_slots=2, max_prompt_len=6, max_new_cap=12),
        policy=policy, bundles=bundles(s, side))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, size=6) for _ in range(3)]
    done = []
    for i, p in enumerate(prompts):
        while not eng.free_slots():
            done += eng.step()
        eng.admit(mod.Request(rid=i, prompt=p, max_new=12))
        if i == 1:
            done += eng.step()
    while eng.has_active():
        done += eng.step()
    return eng, done, prompts


@pytest.mark.parametrize("carry_over", [True, False])
def test_engine_draft_model_matches_run_to_completion(stack, carry_over):
    s = stack
    kw = dict(max_new_tokens=12, block_k=4)
    jpol, tpol = policies(carry_over, kw)
    jeng, jdone, _ = _manual_run("jax", s, kw, jpol)
    teng, tdone, prompts = _manual_run("torch", s, kw, tpol)
    rec = lambda f: (f.rid, f.tokens.tolist(), f.generated,  # noqa: E731
                     f.invocations)
    assert [rec(f) for f in tdone] == [rec(f) for f in jdone]
    assert len(tdone) == 3
    for f in tdone:
        ref_t, ref_s = tdecode.bpd_decode(
            s["tp"], s["tcfg"], DecodeConfig(**kw),
            {"tokens": torch.tensor(prompts[f.rid])[None]}, policy=tpol,
            bundles=bundles(s, "torch"))
        n = int(ref_s["text_len"][0])
        assert f.tokens.tolist() == ref_t[0, 6:n].tolist()
    assert all(v == 1 for v in teng.compile_counts().values())
    assert teng.compile_counts() == jeng.compile_counts()


def _sched_run(side, s, ecfg_kw, dec_kw, self_draft):
    """A draft_model and an exact group of two slots, eight requests of
    3-6 tokens with budgets 4-12, on a virtual clock."""
    if side == "jax":
        mod, params, cfg, dcls = jserving, s["jp"], s["jcfg"], JDecodeConfig
    else:
        mod, params, cfg, dcls = tserving, s["tp"], s["tcfg"], DecodeConfig
    eng = mod.ContinuousBatchingEngine(
        params, cfg, dcls(**dec_kw), mod.EngineConfig(**ecfg_kw),
        policies={"draft_model": 2, "exact": 2},
        bundles=bundles(s, side, self_draft))
    sched = mod.Scheduler(eng)
    rng = np.random.default_rng(83)
    for i in range(8):
        sched.submit(mod.Request(
            rid=i, policy=("draft_model", "exact")[i % 2], arrival=0.0,
            prompt=rng.integers(0, cfg.vocab_size,
                                size=int(rng.integers(3, 7))),
            max_new=int(rng.integers(4, 13))))
    now, done = 0.0, []
    while not sched.drained():
        assert now < 500
        done += sched.step(now=now)
        now += 1.0
    return eng, done


@pytest.mark.serving
@pytest.mark.parametrize("ecfg_kw,dec_kw,self_draft", [
    (dict(), dict(), False),
    (dict(prefill_slots=2), dict(), False),
    (dict(steps_per_sync=3), dict(cache_backend="paged", page_size=8), True),
], ids=["unified", "disaggregated", "window-paged-self-draft"])
def test_engine_draft_group_equals_reference(stack, ecfg_kw, dec_kw,
                                             self_draft):
    """A draft_model group beside an exact group, unified, disaggregated
    (prefill batches of 2: the draft cache rides the packet) and with
    windows of 3 iterations on the paged pool (masked no-op iterations
    freeze every row; a self-draft there accepts whole blocks only while
    the draft cache stays the committed stream): the reference's finish
    records, and every serving function built once."""
    s = stack
    ecfg_kw = dict(num_slots=4, max_prompt_len=6, max_new_cap=12, **ecfg_kw)
    dec_kw = dict(max_new_tokens=12, block_k=4, **dec_kw)
    jeng, jdone = _sched_run("jax", s, ecfg_kw, dec_kw, self_draft)
    teng, tdone = _sched_run("torch", s, ecfg_kw, dec_kw, self_draft)
    rec = lambda f: (f.rid, f.policy, f.tokens.tolist(), f.generated,  # noqa: E731
                     f.invocations)
    assert sorted(map(rec, tdone)) == sorted(map(rec, jdone))
    assert len(tdone) == 8
    assert all(v == 1 for v in teng.compile_counts().values())
    if self_draft:
        khat = [f.generated / (f.invocations - 1) for f in tdone
                if f.policy == "draft_model"]
        assert min(khat) > 2.0, khat


@pytest.mark.serving
def test_engine_rejects_recurrent_aux_bundle(stack):
    """The engine refuses any recurrent auxiliary bundle (its padded
    admission prefill is sound for KV caches only), as the reference."""
    s = stack
    jr = tiny_rwkv(vocab_size=s["jcfg"].vocab_size)
    tr = ModelConfig(**dataclasses.asdict(jr))
    kw = dict(max_new_tokens=8, block_k=4)
    ecfg = dict(num_slots=2, max_prompt_len=6, max_new_cap=8)
    with pytest.raises(NotImplementedError, match="padded admission"):
        jserving.ContinuousBatchingEngine(
            s["jp"], s["jcfg"], JDecodeConfig(**kw),
            jserving.EngineConfig(**ecfg),
            bundles={"aux": JModelBundle(jmodel.init(jax.random.PRNGKey(5),
                                                     jr), jr)})
    with pytest.raises(NotImplementedError, match="padded admission"):
        tserving.ContinuousBatchingEngine(
            s["tp"], s["tcfg"], DecodeConfig(**kw),
            tserving.EngineConfig(**ecfg),
            bundles={"aux": ModelBundle(tmodel.init(tr, seed=5, device="cpu"),
                                        tr)})


# ---------------------------------------------------------------------------
# Bundle binding + validation
# ---------------------------------------------------------------------------


def test_draft_model_unbound_raises(stack):
    s = stack
    kw = dict(max_new_tokens=8, block_k=4)
    with pytest.raises(ValueError, match="ModelBundle"):
        jdecode.bpd_decode(s["jp"], s["jcfg"], JDecodeConfig(**kw),
                           {"tokens": jnp.asarray(s["tokens"])},
                           policy="draft_model")
    with pytest.raises(ValueError, match="ModelBundle"):
        tdecode.bpd_decode(s["tp"], s["tcfg"], DecodeConfig(**kw),
                           {"tokens": torch.tensor(s["tokens"])},
                           policy="draft_model")
    # the unbound drafter itself refuses, before any forward
    with pytest.raises(ValueError, match="unbound"):
        DraftModelDrafter().init_state(s["tcfg"], DecodeConfig(**kw), None, 1)


def test_bind_validates_draft_config(stack):
    """The four refusals raise the reference's error types and messages;
    a good bundle binds its config."""
    s = stack
    jd, td = draft_config(s["jcfg"].vocab_size), s["tdcfg"]
    cases = [
        (jd.replace(vocab_size=13), ValueError, "vocab_size"),
        (tiny_rwkv(vocab_size=97), NotImplementedError, "recurrent"),
        (tiny_seq2seq(vocab_size=97), ValueError, "decoder-only"),
        (jd.replace(modality="vision_text"), NotImplementedError,
         "plain text LM"),
    ]
    for jbad, err, match in cases:
        with pytest.raises(err, match=match) as jexc:
            JDraftModelDrafter().bind({"draft": JModelBundle(None, jbad)},
                                      s["jcfg"])
        tbad = ModelConfig(**dataclasses.asdict(jbad))
        with pytest.raises(err, match=match) as texc:
            DraftModelDrafter().bind({"draft": ModelBundle(None, tbad)},
                                     s["tcfg"])
        assert str(texc.value) == str(jexc.value)
    with pytest.raises(ValueError, match="ModelBundle"):
        DraftModelDrafter().bind({}, s["tcfg"])
    bound = DraftModelDrafter().bind({"draft": ModelBundle(s["tdp"], td,
                                                           kv_chunk=3)},
                                     s["tcfg"])
    assert bound.cfg == td and bound.kv_chunk == 3
    # binding is a no-op for single-model policies
    exact = tpolicy.resolve_policy(DecodeConfig(), "exact")
    assert exact.bind({"draft": ModelBundle(s["tdp"], td)}, s["tcfg"]) is exact


def test_session_policy_mismatch_guard(stack):
    """A session fixes its bundles at construction; the wrappers reject
    late bundles and policy mismatches instead of silently re-binding."""
    s = stack
    dec = DecodeConfig(max_new_tokens=8, block_k=4)
    batch = {"tokens": torch.tensor(s["tokens"])}
    sess = tserving.DecodeSession(s["tp"], s["tcfg"], dec,
                                  policy="draft_model",
                                  bundles=bundles(s, "torch"))
    with pytest.raises(ValueError, match="fixed at DecodeSession"):
        tdecode.bpd_decode(s["tp"], s["tcfg"], dec, batch, session=sess,
                           bundles=bundles(s, "torch"))
    with pytest.raises(ValueError, match="policy is fixed"):
        tdecode.bpd_decode(s["tp"], s["tcfg"], dec, batch, session=sess,
                           policy="exact")
    t1, _ = tdecode.bpd_decode(s["tp"], s["tcfg"], dec, batch, session=sess,
                               policy="draft_model")
    t2, _ = tdecode.bpd_decode(s["tp"], s["tcfg"], dec, batch,
                               policy="draft_model",
                               bundles=bundles(s, "torch"))
    assert torch.equal(t1, t2)


def test_self_draft_in_another_dtype_is_refused(stack):
    """A session casts its bundles in place, so a self-draft whose cfg
    computes in another dtype than the primary's is refused before any
    tensor of the primary is touched."""
    s = stack
    tp = bridge.from_jax_params(
        jax.tree_util.tree_map(np.asarray, s["jp"]), s["tcfg"], device="cpu")
    before = {n: p.dtype for n, p in tp.named_parameters()}
    dec = DecodeConfig(max_new_tokens=8, block_k=4)
    with pytest.raises(ValueError, match="recast the primary"):
        tserving.DecodeSession(
            tp, s["tcfg"], dec, policy="draft_model",
            bundles={"draft": ModelBundle(
                tp, s["tcfg"].replace(dtype="bfloat16"))})
    assert {n: p.dtype for n, p in tp.named_parameters()} == before


def test_draft_cache_state_is_batch_leading(stack):
    """The drafter's state honours the policy-state contract (batch-leading
    leaves), with the same shapes with and without the draft's parameters
    (the engine's paramless init and evict against its admission)."""
    s = stack
    dec = DecodeConfig(max_new_tokens=8, block_k=4)
    pol = tpolicy.resolve_policy(dec, "draft_model").bind(bundles(s, "torch"),
                                                          s["tcfg"])
    batch = {"tokens": torch.tensor(s["tokens"])}
    b = batch["tokens"].shape[0]
    state = pol.init_state(s["tcfg"], dec, batch, b,
                           aux={"draft": s["tdp"]})
    bare = pol.init_state(s["tcfg"], dec, batch, b)
    leaves = jax.tree_util.tree_leaves(state.drafter)
    assert leaves
    for leaf, other in zip(leaves, jax.tree_util.tree_leaves(bare.drafter)):
        assert leaf.dim() >= 1 and leaf.shape[0] == b, leaf.shape
        assert leaf.shape == other.shape and leaf.dtype == other.dtype
    # the prefilled cache holds the prompt's positions, the bare one none
    pos = state.drafter["caches"][0]["attn"]["pos"]
    assert (pos[:, :6] == torch.arange(6, dtype=pos.dtype)).all()
    assert (bare.drafter["caches"][0]["attn"]["pos"] == -1).all()


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def test_serve_launcher_draft_model(capsys):
    """launch/serve.py --policy draft_model serves on the CPU with the
    smoke draft, statically (greedy's tokens) and as an engine group."""
    from repro_torch.launch import serve

    base = ["--arch", "granite-3-8b", "--device", "cpu", "--batch", "2",
            "--prompt-len", "8", "--max-new", "6"]
    out = serve.main(base + ["--policy", "draft_model"])
    text = capsys.readouterr().out
    assert "policy=draft_model" in text and "draft model:" in text
    assert out["session"].policy.drafter.cfg.bpd_enabled is False
    gt, _ = tdecode.greedy_decode(out["params"], out["cfg"], out["dec"],
                                  out["batch"])
    n = 8 + 6
    assert torch.equal(out["tokens"][:, :n], gt[:, :n])
    out = serve.main(base + ["--engine", "--policies",
                             "exact=1,draft_model=1"])
    finished = out["finished"]
    assert len(finished) == 4
    assert {f.policy for f in finished} <= {"exact", "draft_model"}
    assert all(v == 1 for v in out["engine"].compile_counts().values())

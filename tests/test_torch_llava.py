"""The port's vision_text backbone (llava-next-34b) against the JAX
reference, on the CPU: the registered configs, the full config's parameter
count, the stub patch embeddings, ``embed_inputs`` / ``prefix_len`` with and
without patches, full-forward logits, and on bridged smoke weights (d 256,
8/2 heads of 32, 2 layers, vocab 256, weights made by
``repro.models.model.init`` and carried across by ``bridge``) with 16
patches before each prompt: greedy and BPD under exact, topk, adaptive and
topk_tree on the dense and the paged cache, a chunked prefill, hand-made
iterations at the patch offset, ``draft_model`` under a patch-prefix
primary, one ``make_train_step`` frozen and fine-tuned, both launchers
with their 4 zero patches, and the engine's refusal.

Tolerances: the embeddings exactly; logits within 2e-5 (fp32 on both
sides, sums in another order); decoded tokens, iterations, k̂ and
invocations exactly; the training step as ``test_torch_hymba.py``'s.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_dense  # noqa: E402
from repro import config as jconfig  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.config import DecodeConfig as JDecodeConfig  # noqa: E402
from repro.core import decode as jdecode  # noqa: E402
from repro.core import train as jtrain  # noqa: E402
from repro.core.bundle import ModelBundle as JModelBundle  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving.types import EngineConfig as JEngineConfig  # noqa: E402
from repro_torch import bridge, config as tconfig  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.config import DecodeConfig, ModelConfig  # noqa: E402
from repro_torch.core import ModelBundle  # noqa: E402
from repro_torch.core import decode as tdecode  # noqa: E402
from repro_torch.core import train as ttrain  # noqa: E402
from repro_torch.data import pipeline as tpipeline  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.optim import freeze_mask, optimizer_init  # noqa: E402
from repro_torch.utils.tree import flatten_with_names  # noqa: E402
from repro.utils.tree import flatten_with_names as jflatten  # noqa: E402
from test_torch_train import (  # noqa: E402
    TOL as TRAIN_TOL,
    assert_tree_close,
    port_grads,
    port_tc,
    ref_draws,
    to_torch,
)

torch.set_num_threads(2)
TOL = dict(rtol=2e-5, atol=2e-5)
NAME = "llava-next-34b"
B, PROMPT, MAX_NEW, K = 2, 8, 12, 4
FULL_PARAMS = 36_737_948_672      # jax.eval_shape of the reference's init


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               **(tol or TOL))


def _smoke():
    return jconfig.get_config(NAME, smoke=True).replace(dtype="float32")


@pytest.fixture(scope="module")
def setup():
    """The smoke config's bridged weights and a batch of B rows: 16 stub
    patch embeddings, then PROMPT tokens."""
    jcfg = _smoke()
    jp = jmodel.init(jax.random.PRNGKey(3), jcfg)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    tp = bridge.from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                                device="cpu")
    batch = jpipeline.stub_frontend_inputs(jcfg, np.random.default_rng(4), B,
                                           PROMPT)
    return jcfg, tcfg, jp, tp, batch


def _batches(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.tensor(v) for k, v in batch.items()})


# ---------------------------------------------------------------------------
# config, parameters, inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True])
def test_registered_llava_matches_reference(smoke):
    want = jconfig.get_config(NAME, smoke=smoke)
    got = tconfig.get_config(NAME, smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.num_patch_tokens == (16 if smoke else 2880)
    tblocks.check_supported(got)
    assert NAME in tblocks.PORTED_ARCHS


def test_full_parameter_count_matches_reference():
    """The port's init on the meta device against jax.eval_shape of the
    reference's: the same leaves, shapes and 36,737,948,672 parameters."""
    cfg = jconfig.get_config(NAME)
    shapes = jax.eval_shape(lambda k: jmodel.init(k, cfg),
                            jax.random.PRNGKey(0))
    want = {n: tuple(x.shape) for n, x in jflatten(shapes)}
    meta = tmodel.init(tconfig.get_config(NAME), device="meta")
    got = {n: tuple(p.shape) for n, p in flatten_with_names(meta)}
    assert got == want
    assert sum(int(np.prod(s)) for s in got.values()) == FULL_PARAMS


@pytest.mark.parametrize("name,b,text_len", [(NAME, 3, 8),
                                             ("granite-3-8b", 2, 5)])
def test_stub_frontend_inputs_match_reference(name, b, text_len):
    """From one generator state the same arrays, bit for bit: patches
    (vision_text only), then tokens."""
    cfg = jconfig.get_config(name, smoke=True)
    want = jpipeline.stub_frontend_inputs(cfg, np.random.default_rng(9), b,
                                          text_len)
    got = tpipeline.stub_frontend_inputs(
        tconfig.get_config(name, smoke=True), np.random.default_rng(9), b,
        text_len)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    if name == NAME:
        assert got["patch_embeds"].shape == (b, 16, cfg.d_model)


@pytest.mark.parametrize("patches", [True, False])
def test_embed_inputs_and_prefix_len(setup, patches):
    """Patches cast to the compute dtype before the token embeddings; a
    batch without them is text only, with no prefix."""
    jcfg, tcfg, jp, tp, batch = setup
    if not patches:
        batch = {"tokens": batch["tokens"]}
    jb, tb = _batches(batch)
    jh = jmodel.embed_inputs(jp, jcfg, jb)
    th = tmodel.embed_inputs(tp, tcfg, tb)
    n = 16 if patches else 0
    assert th.shape == (B, n + PROMPT, jcfg.d_model)
    close(th, jh, rtol=0, atol=0)
    assert tmodel.prefix_len(tcfg, tb) == jmodel.prefix_len(jcfg, jb) == n
    bf = tmodel.embed_inputs(tp, tcfg.replace(dtype="bfloat16"), tb)
    assert bf.dtype == torch.bfloat16
    if patches:
        assert torch.equal(bf[:, :n], tb["patch_embeds"].to(torch.bfloat16))


def test_forward_logits_match_reference(setup):
    """The whole stack over the patches and the prompt: every head's logits
    at the text positions."""
    jcfg, tcfg, jp, tp, batch = setup
    jb, tb = _batches(batch)
    jhid, _, _ = jmodel.forward_hidden(jp, jcfg, jmodel.embed_inputs(jp, jcfg,
                                                                     jb))
    with torch.no_grad():
        thid, _ = tmodel.forward_hidden(tp, tcfg,
                                        tmodel.embed_inputs(tp, tcfg, tb))
    close(tmodel.all_head_logits(tp, tcfg, thid[:, 16:]),
          jmodel.all_head_logits(jp, jcfg, jhid[:, 16:]))


# ---------------------------------------------------------------------------
# decode against the reference
# ---------------------------------------------------------------------------


def _rows(toks, stats):
    n = np.asarray(stats["text_len"])
    t = np.asarray(toks)
    return [t[r, :n[r]].tolist() for r in range(len(n))]


def _check_same(jres, tres):
    jt, js = jres
    tt, ts = tres
    assert _rows(tt.numpy(), ts) == _rows(jt, js)
    assert ts["iterations"] == int(js["iterations"])
    assert ts["invocations"] == int(js["invocations"])
    np.testing.assert_array_equal(ts["generated"].numpy(),
                                  np.asarray(js["generated"]))
    np.testing.assert_allclose(ts["mean_accepted"], float(js["mean_accepted"]),
                               rtol=1e-6)


def _decs(**kw):
    kw = dict(max_new_tokens=MAX_NEW, block_k=K, top_k=2, **kw)
    return JDecodeConfig(**kw), DecodeConfig(**kw)


@pytest.fixture(scope="module")
def greedy(setup):
    jcfg, tcfg, jp, tp, batch = setup
    jdec, tdec = _decs()
    jb, tb = _batches(batch)
    return (jdecode.greedy_decode(jp, jcfg, jdec, jb),
            tdecode.greedy_decode(tp, tcfg, tdec, tb))


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_greedy_decode_matches_reference(setup, greedy, backend):
    _check_same(*greedy)
    if backend == "paged":
        jcfg, tcfg, jp, tp, batch = setup
        jdec, tdec = _decs(cache_backend="paged", page_size=8)
        jb, tb = _batches(batch)
        tres = tdecode.greedy_decode(tp, tcfg, tdec, tb)
        _check_same(jdecode.greedy_decode(jp, jcfg, jdec, jb), tres)
        assert _rows(*tres) == _rows(*greedy[1])


@pytest.mark.parametrize("backend", ["dense", "paged"])
@pytest.mark.parametrize("policy", ["exact", "topk", "adaptive", "topk_tree"])
def test_bpd_decode_policy_matches_reference(setup, greedy, policy, backend):
    jcfg, tcfg, jp, tp, batch = setup
    jdec, tdec = _decs(policy=policy, cache_backend=backend, page_size=8)
    jb, tb = _batches(batch)
    tres = tdecode.bpd_decode(tp, tcfg, tdec, tb)
    _check_same(jdecode.bpd_decode(jp, jcfg, jdec, jb), tres)
    if policy in ("exact", "adaptive", "topk_tree"):   # greedy's tokens
        assert _rows(*tres) == _rows(*greedy[1])


def test_kv_chunk_prefill_matches_reference(setup, greedy):
    """The prefill's attention in chunks of 7 keys over 16 patches + 8
    tokens, through DecodeSession(kv_chunk=) and the reference's; the
    session's greedy takes the patches too."""
    jcfg, tcfg, jp, tp, batch = setup
    jdec, tdec = _decs()
    jb, tb = _batches(batch)
    sess = tserving.DecodeSession(tp, tcfg, tdec, kv_chunk=7)
    tres = sess.decode(tb)
    _check_same(jdecode.bpd_decode(jp, jcfg, jdec, jb, kv_chunk=7), tres)
    assert _rows(*tres) == _rows(*greedy[1])
    assert _rows(*sess.greedy(tb)) == _rows(*greedy[1])


@pytest.mark.parametrize("corrupt", [None, 2])
def test_iteration_with_handmade_proposals(setup, greedy, corrupt):
    """From the prefill state (prefix 16), propose greedy's own
    continuation (k̂ = k) or corrupt slot j of it (k̂ = j), then a second
    iteration: both packages agree on tokens and proposals, and the tokens
    stay greedy's."""
    jcfg, tcfg, jp, tp, batch = setup
    jdec, tdec = _decs()
    g_rows = _rows(*greedy[1])
    props = np.asarray([r[PROMPT:PROMPT + K] for r in g_rows], np.int32)
    if corrupt is not None:
        props[:, corrupt] = (props[:, corrupt] + 1) % jcfg.vocab_size
    jb, tb = _batches(batch)
    js, jpre = jdecode.bpd_prefill_causal_lm(jp, jcfg, jdec, jb,
                                             max_new=MAX_NEW)
    ts, tpre = tdecode.bpd_prefill_causal_lm(tp, tcfg, tdec, tb,
                                             max_new=MAX_NEW)
    assert tpre == jpre == 16
    np.testing.assert_array_equal(ts.proposals.numpy(), np.asarray(js.proposals))
    js = js._replace(proposals=jnp.asarray(props))
    ts = ts._replace(proposals=torch.tensor(props))
    for it in range(2):
        js = jdecode.bpd_iteration(jp, jcfg, jdec,
                                   jdecode.causal_lm_backend(jcfg), js,
                                   prefix_offset=jpre, max_new=MAX_NEW)
        ts = tdecode.bpd_iteration(tp, tcfg, tdec,
                                   tdecode.causal_lm_backend(tcfg), ts,
                                   prefix_offset=tpre, max_new=MAX_NEW)
        if it == 0:
            khat = K if corrupt is None else corrupt
            assert ts.text_len.tolist() == [PROMPT + khat] * B
        np.testing.assert_array_equal(ts.text_len.numpy(), np.asarray(js.text_len))
        np.testing.assert_array_equal(ts.tokens.numpy(), np.asarray(js.tokens))
        np.testing.assert_array_equal(ts.proposals.numpy(), np.asarray(js.proposals))
        n = ts.text_len.tolist()
        assert [r[:n[i]] for i, r in enumerate(ts.tokens.tolist())] == \
            [r[:n[i]] for i, r in enumerate(g_rows)]


def test_draft_model_under_a_patch_prefix(setup, greedy):
    """A plain text draft (2 layers, d 64, at the primary's vocab) drafts
    for the patch-prefixed primary: its positions are the output stream's,
    the primary's run 16 ahead.  The reference runs this pairing; the port
    equals it and greedy."""
    jcfg, tcfg, jp, tp, batch = setup
    jdcfg = tiny_dense(vocab_size=jcfg.vocab_size, bpd_enabled=False)
    jdp = jmodel.init(jax.random.PRNGKey(7), jdcfg)
    tdcfg = ModelConfig(**dataclasses.asdict(jdcfg))
    tdp = bridge.from_jax_params(jax.tree_util.tree_map(np.asarray, jdp),
                                 tdcfg, device="cpu")
    jdec, tdec = _decs(policy="draft_model")
    jb, tb = _batches(batch)
    jres = jdecode.bpd_decode(jp, jcfg, jdec, jb,
                              bundles={"draft": JModelBundle(jdp, jdcfg)})
    tres = tdecode.bpd_decode(tp, tcfg, tdec, tb,
                              bundles={"draft": ModelBundle(tdp, tdcfg)})
    _check_same(jres, tres)
    assert _rows(*tres) == _rows(*greedy[1])


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def test_engine_refuses_vision_text(setup):
    """Per-request patches would make the admission prefill's shape
    dynamic: both packages refuse at construction, in the same words."""
    jcfg, tcfg, jp, tp, _ = setup
    with pytest.raises(NotImplementedError) as jerr:
        jengine.ContinuousBatchingEngine(jp, jcfg, JDecodeConfig(),
                                         JEngineConfig())
    with pytest.raises(NotImplementedError) as terr:
        tserving.ContinuousBatchingEngine(tp, tcfg, DecodeConfig(),
                                          tserving.EngineConfig())
    assert str(terr.value) == str(jerr.value)
    assert "text-only" in str(terr.value)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("frozen", [False, True])
def test_make_train_step_matches_reference(setup, frozen):
    """B 2 x 12 tokens behind 16 patches: the loss (the patches' hidden
    states dropped) and every gradient equal the reference's jitted step,
    and every updated leaf and AdamW's state equal the reference's
    ``optimizer_update`` applied to the port's gradients, fine-tuned and
    with a frozen base."""
    jcfg, tcfg, jp, _, _ = setup
    jtc = jconfig.TrainConfig(lr=1e-3, warmup_steps=1, freeze_base=frozen)
    batch = jpipeline.stub_frontend_inputs(jcfg, np.random.default_rng(5), 2,
                                           12)
    key = jax.random.PRNGKey(11)
    jmask = joptim.freeze_mask(jp, train_only_heads=True) if frozen else None
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss_fn = jtrain.loss_fn_for(jcfg)
    jg = jax.jit(jax.grad(lambda p, b, k: jloss_fn(p, jcfg, jtc, b, k)[0]))(
        jp, jb, key)
    _, _, jm = jax.jit(jsteps.make_train_step(jcfg, jtc, mask=jmask))(
        jp, joptim.optimizer_init(jp, jtc), jb, key)

    ttc = port_tc(jtc)
    assert ttrain.loss_fn_for(tcfg) is ttrain.lm_loss
    tp = bridge.from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                                device="cpu")
    tmask = freeze_mask(tp, train_only_heads=True) if frozen else None
    topt = optimizer_init(tp, ttc, tmask)
    head, _ = ref_draws(key, jcfg, jtc, batch["tokens"].shape)
    step = tsteps.make_train_step(tcfg, ttc, mask=tmask)
    tp, topt, tm = step(tp, topt, to_torch(batch), None, head_idx=head)

    for name in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   err_msg=name, **TRAIN_TOL)
    grads = port_grads(tp)
    assert_tree_close(grads, jg)
    if not frozen:
        assert float(grads["blocks/0/attn/wq"].abs().max()) > 0
    names = [n for n, _ in jflatten(jg)]
    tg = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jg), [
        jnp.asarray(grads[n].numpy()) for n in names])
    jparams, jopt, _ = jax.jit(lambda g: joptim.optimizer_update(
        g, joptim.optimizer_init(jp, jtc), jp, jtc, mask=jmask))(tg)
    assert_tree_close(dict(flatten_with_names(tp)), jparams)
    trained = sorted(n for n, _ in flatten_with_names(tp)
                     if tmask is None or tmask[n] > 0)
    assert_tree_close(topt["mu"], jopt["mu"], trained)
    assert_tree_close(topt["nu"], jopt["nu"], trained)


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------


def test_serve_llava_on_cpu(capsys):
    """The static serve of the smoke config with the reference's 4 zero
    patches before each prompt: BPD exact emits greedy's tokens on them."""
    from repro_torch.launch import serve

    out = serve.main(["--arch", NAME, "--device", "cpu", "--batch", "2",
                      "--prompt-len", "8", "--max-new", "6"])
    assert NAME in capsys.readouterr().out
    pe = out["batch"]["patch_embeds"]
    assert pe.shape == (2, 4, 256) and pe.dtype == torch.float32
    assert not bool(pe.any())
    assert tmodel.prefix_len(out["cfg"], out["batch"]) == 4
    gt, gs = tdecode.greedy_decode(out["params"], out["cfg"], out["dec"],
                                   out["batch"])
    assert _rows(out["tokens"].numpy(), out["stats"]) == _rows(gt.numpy(), gs)


def test_serve_llava_refuses_the_engine():
    from repro_torch.launch import serve

    with pytest.raises(NotImplementedError, match="text-only"):
        serve.main(["--arch", NAME, "--device", "cpu", "--batch", "2",
                    "--prompt-len", "4", "--max-new", "2", "--engine"])


def test_train_launcher_llava_on_cpu(capsys):
    """The reference's vision branch: MarkovLM tokens behind 4 zero
    patches."""
    from repro_torch.launch import train

    gen = train.data_for(tconfig.get_config(NAME, smoke=True), 2, 16, 1)
    b = next(gen)
    assert b["patch_embeds"].shape == (2, 4, 256) and b["tokens"].shape == (2, 16)
    out = train.main(["--arch", NAME, "--device", "cpu", "--steps", "3",
                      "--batch", "2", "--seq", "16", "--log-every", "3"])
    assert out["cfg"].name == NAME
    assert "loss" in capsys.readouterr().out
    assert np.isfinite(float(out["metrics"]["loss"]))

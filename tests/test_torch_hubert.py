"""The port's encoder-only audio model (hubert-xlarge) against the JAX
reference, on the CPU: the registered configs, the full config's parameter
count, ``pos_embed`` / ``mask_embed`` carried by ``bridge``,
``MaskedFrames``, the audio ``embed_inputs`` with its mask, the
bidirectional forward, ``masked_prediction_loss`` (its loss and every
gradient, at the smoke vocab of 64 and at the full vocab of 504 padded to
512 lanes), one ``make_train_step``, the train launcher, and the refusals
to decode (the serve launcher's, in the reference's words, and the decode
entry points').  Weights are made by ``repro.models.model.init`` on the
smoke config (d 128, 4 heads of 32, 2 layers, LayerNorm, gelu).

Tolerances: embeddings and synthetic data exactly; hidden states and logits
within 2e-5 (fp32 on both sides, sums in another order); the loss and the
gradients as ``test_torch_train.py``'s (rtol 1e-5, atol 1e-5 of each
leaf's max); the step as ``test_torch_hymba.py``'s.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import config as jconfig  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.config import DecodeConfig as JDecodeConfig  # noqa: E402
from repro.core import decode as jdecode  # noqa: E402
from repro.core import train as jtrain  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import bridge, config as tconfig  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.config import DecodeConfig, ModelConfig  # noqa: E402
from repro_torch.core import decode as tdecode  # noqa: E402
from repro_torch.core import train as ttrain  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.optim import optimizer_init  # noqa: E402
from repro_torch.utils.tree import flatten_with_names  # noqa: E402
from repro.utils.tree import flatten_with_names as jflatten  # noqa: E402
from test_torch_train import (  # noqa: E402
    TOL as TRAIN_TOL,
    assert_tree_close,
    port_grads,
    port_tc,
    to_torch,
)

torch.set_num_threads(2)
TOL = dict(rtol=2e-5, atol=2e-5)
NAME = "hubert-xlarge"
FULL_PARAMS = 987_221_760         # jax.eval_shape of the reference's init


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               **(tol or TOL))


def _bridged(jcfg, seed):
    jp = jmodel.init(jax.random.PRNGKey(seed), jcfg)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    tp = bridge.from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                                device="cpu")
    return jp, tcfg, tp


@pytest.fixture(scope="module")
def setup():
    jcfg = jconfig.get_config(NAME, smoke=True).replace(dtype="float32")
    jp, tcfg, tp = _bridged(jcfg, 3)
    frames = tsyn.MaskedFrames(jcfg.d_model, codebook=jcfg.vocab_size,
                               seed=1).sample(np.random.default_rng(2), 3, 40)
    return jcfg, tcfg, jp, tp, frames


def _batches(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.tensor(v) for k, v in batch.items()})


# ---------------------------------------------------------------------------
# config, parameters, data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True])
def test_registered_hubert_matches_reference(smoke):
    want = jconfig.get_config(NAME, smoke=smoke)
    got = tconfig.get_config(NAME, smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.is_encoder_only and not got.bpd_enabled
    assert got.padded_vocab_size == want.padded_vocab_size == (
        256 if smoke else 512)
    tblocks.check_supported(got)
    assert ttrain.loss_fn_for(got) is ttrain.masked_prediction_loss
    assert jtrain.loss_fn_for(want) is jtrain.masked_prediction_loss


def test_full_parameter_count_matches_reference():
    cfg = jconfig.get_config(NAME)
    shapes = jax.eval_shape(lambda k: jmodel.init(k, cfg),
                            jax.random.PRNGKey(0))
    want = {n: tuple(x.shape) for n, x in jflatten(shapes)}
    meta = tmodel.init(tconfig.get_config(NAME), device="meta")
    got = {n: tuple(p.shape) for n, p in flatten_with_names(meta)}
    assert got == want
    assert got["pos_embed"] == (32768, 1280) and got["mask_embed"] == (1280,)
    assert sum(int(np.prod(s)) for s in got.values()) == FULL_PARAMS


def test_pos_and_mask_embed_are_bridged(setup):
    """Both leaves under the reference's keys, value for value; the port's
    own init draws them at std 0.02."""
    jcfg, tcfg, jp, tp, _ = setup
    sd = tp.state_dict()
    np.testing.assert_array_equal(sd["pos_embed"].numpy(),
                                  np.asarray(jp["pos_embed"]))
    np.testing.assert_array_equal(sd["mask_embed"].numpy(),
                                  np.asarray(jp["mask_embed"]))
    own = tmodel.init(tcfg, seed=1, device="cpu")
    for key in ("pos_embed", "mask_embed"):
        assert 0.015 < float(own[key].std()) < 0.025


@pytest.mark.parametrize("seed,kw", [(0, {}), (5, dict(mask_prob=0.3, span=3)),
                                     (7, dict(mask_prob=0.0, span=50))])
def test_masked_frames_match_reference(seed, kw):
    """The codebook, then two samples from one generator: frames, mask and
    targets bit for bit, also through ``batches``."""
    want = jsyn.MaskedFrames(48, codebook=30, seed=seed)
    got = tsyn.MaskedFrames(48, codebook=30, seed=seed)
    np.testing.assert_array_equal(got.codebook, want.codebook)
    jr, tr = np.random.default_rng(seed + 1), np.random.default_rng(seed + 1)
    for _ in range(2):
        w, g = want.sample(jr, 3, 40, **kw), got.sample(tr, 3, 40, **kw)
        assert sorted(g) == sorted(w) == ["frame_embeds", "mask", "targets"]
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
    w = next(want.batches(batch=2, seq_len=24, seed=seed, **kw))
    g = next(got.batches(batch=2, seq_len=24, seed=seed, **kw))
    for k in w:
        np.testing.assert_array_equal(g[k], w[k])


# ---------------------------------------------------------------------------
# embedding, forward, loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [True, False])
def test_audio_embed_inputs(setup, masked):
    """Masked frames become ``mask_embed``, then every frame gets
    ``pos_embed`` of its position; no prefix."""
    jcfg, tcfg, jp, tp, frames = setup
    batch = {"frame_embeds": frames["frame_embeds"]}
    if masked:
        batch["mask"] = frames["mask"]
    jb, tb = _batches(batch)
    th = tmodel.embed_inputs(tp, tcfg, tb)
    close(th, jmodel.embed_inputs(jp, jcfg, jb), rtol=0, atol=0)
    assert tmodel.prefix_len(tcfg, tb) == 0
    m = torch.tensor(frames["mask"])
    want = tp["mask_embed"] + tp["pos_embed"][:40]
    assert masked == torch.equal(th[m], want.expand(3, -1, -1)[m])


def test_bidirectional_forward_matches_reference(setup):
    """The whole stack without RoPE or a causal mask: hidden states and
    logits within 2e-5, and the first frame sees the last."""
    jcfg, tcfg, jp, tp, frames = setup
    jb, tb = _batches(frames)
    jh = jmodel.embed_inputs(jp, jcfg, jb)
    jhid, _, _ = jmodel.forward_hidden(jp, jcfg, jh, bidirectional=True)
    with torch.no_grad():
        th = tmodel.embed_inputs(tp, tcfg, tb)
        thid, _ = tmodel.forward_hidden(tp, tcfg, th, bidirectional=True)
        close(thid, jhid)
        close(tmodel.project_vocab(tp, tcfg, thid),
              jmodel.project_vocab(jp, jcfg, jhid))
        th2 = th.clone()
        th2[:, -1] += 1.0
        thid2, _ = tmodel.forward_hidden(tp, tcfg, th2, bidirectional=True)
        causal, _ = tmodel.forward_hidden(tp, tcfg, th2)
    assert not torch.allclose(thid2[:, 0], thid[:, 0])
    close(causal[:, :-1], tmodel.forward_hidden(tp, tcfg, th)[0][:, :-1]
          .detach().numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("vocab", [64, 504])
def test_masked_prediction_loss_and_grads_match_reference(vocab):
    """Loss, accuracy and every leaf's gradient (``embed`` unused: zero);
    at vocab 504 the 8 pad lanes of 512 are masked to -1e9."""
    jcfg = jconfig.get_config(NAME, smoke=True).replace(dtype="float32",
                                                        vocab_size=vocab)
    jp, tcfg, tp = _bridged(jcfg, 4)
    batch = jsyn.MaskedFrames(jcfg.d_model, codebook=vocab, seed=2).sample(
        np.random.default_rng(3), 2, 48, mask_prob=0.1, span=5)
    jtc = jconfig.TrainConfig(z_loss=1e-3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jtrain.masked_prediction_loss(p, jcfg, jtc, jb,
                                                jax.random.PRNGKey(0)),
        has_aux=True)(jp)
    ttc = port_tc(jtc)
    tmodel.set_trainable(tp, tsteps.differentiated(tcfg, ttc, tp))
    tl, tm = ttrain.masked_prediction_loss(tp, tcfg, ttc, to_torch(batch))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TRAIN_TOL)
    np.testing.assert_allclose(float(tm["accuracy"]), float(jm["accuracy"]),
                               rtol=0, atol=1e-7)
    grads = port_grads(tp)
    assert_tree_close(grads, jg)
    assert float(grads["embed/table"].abs().max()) == 0
    assert float(grads["mask_embed"].abs().max()) > 0
    assert float(grads["pos_embed"][48:].abs().max()) == 0
    with torch.no_grad():
        h, _ = tmodel.forward_hidden(tp, tcfg, tmodel.embed_inputs(
            tp, tcfg, to_torch(batch)), bidirectional=True)
        logits = tmodel.project_vocab(tp, tcfg, h)
    assert logits.shape[-1] == tcfg.padded_vocab_size
    assert bool((logits[..., vocab:] == -1e9).all())


def test_make_train_step_matches_reference(setup):
    """One AdamW step on MaskedFrames (B 2 x S 32): the loss and gradient
    norm equal the reference's jitted step, every gradient its jax.grad,
    and every updated leaf and AdamW's state the reference's
    ``optimizer_update`` applied to the port's gradients.  A frozen base
    changes nothing here: the reference's masked loss stops no
    gradient."""
    jcfg, tcfg, jp, _, _ = setup
    batch = jsyn.MaskedFrames(jcfg.d_model, codebook=jcfg.vocab_size,
                              seed=6).sample(np.random.default_rng(7), 2, 32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(11)
    for frozen in (False, True):
        jtc = jconfig.TrainConfig(lr=1e-3, warmup_steps=1, freeze_base=frozen)
        jg = jax.jit(jax.grad(lambda p, b, k: jtrain.masked_prediction_loss(
            p, jcfg, jtc, b, k)[0]))(jp, jb, key)
        _, _, jm = jax.jit(jsteps.make_train_step(jcfg, jtc))(
            jp, joptim.optimizer_init(jp, jtc), jb, key)
        ttc = port_tc(jtc)
        tp = bridge.from_jax_params(jax.tree_util.tree_map(np.asarray, jp),
                                    tcfg, device="cpu")
        topt = optimizer_init(tp, ttc)
        step = tsteps.make_train_step(tcfg, ttc)
        tp, topt, tm = step(tp, topt, to_torch(batch), None)
        for name in ("loss", "grad_norm", "accuracy"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       err_msg=name, **TRAIN_TOL)
        grads = port_grads(tp)
        assert_tree_close(grads, jg)
        names = [n for n, _ in jflatten(jg)]
        tg = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jg), [
            jnp.asarray(grads[n].numpy()) for n in names])
        jparams, jopt, _ = jax.jit(lambda g: joptim.optimizer_update(
            g, joptim.optimizer_init(jp, jtc), jp, jtc))(tg)
        assert_tree_close(dict(flatten_with_names(tp)), jparams)
        assert_tree_close(topt["mu"], jopt["mu"])
        assert_tree_close(topt["nu"], jopt["nu"])


# ---------------------------------------------------------------------------
# the launchers and the refusals
# ---------------------------------------------------------------------------


def test_train_launcher_hubert_on_cpu(capsys):
    """The reference's audio branch: MaskedFrames over min(vocab, 504)
    codes, then a few steps of masked prediction."""
    from repro_torch.launch import train

    cfg = tconfig.get_config(NAME, smoke=True)
    got = next(train.data_for(cfg, 2, 24, 1))
    want = next(jsyn.MaskedFrames(cfg.d_model, codebook=64, seed=1).batches(
        batch=2, seq_len=24, seed=1))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    out = train.main(["--arch", NAME, "--device", "cpu", "--steps", "3",
                      "--batch", "2", "--seq", "24", "--log-every", "3"])
    assert out["cfg"].name == NAME
    assert "loss" in capsys.readouterr().out
    assert np.isfinite(float(out["metrics"]["loss"]))


def test_serve_launcher_refuses_hubert():
    from repro_torch.launch import serve

    with pytest.raises(SystemExit, match="hubert-xlarge is encoder-only — no "
                                         "decode path"):
        serve.main(["--arch", NAME, "--device", "cpu", "--batch", "1",
                    "--prompt-len", "4", "--max-new", "2"])


@pytest.mark.parametrize("entry", ["greedy", "bpd", "session"])
def test_decode_refuses_hubert(setup, entry):
    """The reference's decode fails on the missing ``frame_embeds``; the
    port's entry points refuse an encoder-only model by name."""
    jcfg, tcfg, jp, tp, _ = setup
    toks = np.zeros((1, 4), np.int32)
    jfn = jdecode.greedy_decode if entry == "greedy" else jdecode.bpd_decode
    with pytest.raises(KeyError, match="frame_embeds"):
        jfn(jp, jcfg, JDecodeConfig(max_new_tokens=2, block_k=1),
            {"tokens": jnp.asarray(toks)})
    dec = DecodeConfig(max_new_tokens=2, block_k=1)
    batch = {"tokens": torch.tensor(toks)}
    with pytest.raises(NotImplementedError, match="encoder-only — no decode"):
        if entry == "greedy":
            tdecode.greedy_decode(tp, tcfg, dec, batch)
        elif entry == "bpd":
            tdecode.bpd_decode(tp, tcfg, dec, batch)
        else:
            tserving.DecodeSession(tp, tcfg, dec).decode(batch)

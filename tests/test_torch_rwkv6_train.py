"""RWKV-6 training on the port against the JAX reference, on the CPU.

The wkv scan's gradient (``kernels/ref.py: rwkv6_scan_bwd``, the reverse
scan from per-chunk checkpoints and the oracle of the CUDA backward
kernel) against ``jax.vjp`` of the reference's ``_wkv_scan`` (its training
path: chunks of 128 under ``jax.checkpoint``), with a cotangent on y and,
separately, on the final state, at S 1, 16, 17, 37 and 130, D 16, 32 and
64 and logw -8, -20 and 0 beside -20; ``RWKV6Scan`` against autograd
through the plain forward; the gradients' independence of the chunk
length; one ``make_train_step`` on bridged ``tiny_rwkv`` and rwkv6-1.6b
smoke weights against the reference's jitted step (frozen, fine-tuned,
scheduled sampling with self targets); and the train launcher with a
checkpoint round trip.

Tolerances: the scan's gradients within 1e-5 of each output's max |value|
(fp32 sums in another order); the training step as
``tests/test_torch_hymba.py`` holds hymba's (loss and gradient norm rtol
1e-5; every updated leaf rtol 1e-5, atol 1e-5 of the leaf's max), except
that each gradient is held at rtol 1e-4 (atol 1e-5 of its max, as
``chip_smoke.py`` holds the card to the CPU): u's gradient sums r k (dy·v)
over every position in fp32, terms that largely cancel, and the two
frameworks' orders leave it a few 1e-5 of its max apart on tiny_rwkv.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_rwkv  # noqa: E402
from repro import config as jconfig  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.core import train as jtrain  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import ModelConfig  # noqa: E402
from repro_torch.core import train as ttrain  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.rwkv6_scan import RWKV6Scan  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.optim import freeze_mask, optimizer_init  # noqa: E402
from repro_torch.utils.tree import flatten_with_names  # noqa: E402
from repro.utils.tree import flatten_with_names as jflatten  # noqa: E402
from test_torch_rwkv6 import _randomize  # noqa: E402
from test_torch_train import (  # noqa: E402
    TOL as TRAIN_TOL,
    assert_tree_close,
    lm_batch,
    port_grads,
    port_tc,
    ref_draws,
    to_torch,
)

torch.set_num_threads(2)
SCAN_REL = 1e-5          # of each output's max |value|
GRAD_RTOL = 1e-4         # a training step's gradients (see the module)
B, H = 2, 2


def _scan_inputs(s, d, logw_kind, seed=0):
    """r, k, v (B, S, H, D), logw, u (H, D) as numpy f32."""
    rng = np.random.default_rng(seed + 31 * s + d)
    r, k, v = (rng.standard_normal((B, s, H, d)).astype(np.float32)
               for _ in range(3))
    if logw_kind == "mixed":                      # w = 1 beside w = e^-20
        logw = np.zeros((B, s, H, d), np.float32)
        logw[..., 1::2] = -20.0
    else:
        logw = np.full((B, s, H, d), float(logw_kind), np.float32)
    u = (0.1 * rng.standard_normal((H, d))).astype(np.float32)
    return r, k, v, logw, u


def _close(got, want, name):
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy()
    atol = SCAN_REL * float(np.abs(want).max(initial=0.0))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=name)


# ---------------------------------------------------------------------------
# the reverse scan against jax.vjp of the reference's scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cotangent", ["y", "state"])
@pytest.mark.parametrize("logw_kind", ["-8", "-20", "mixed"])
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("s", [1, 16, 17, 37, 130])
def test_rwkv6_scan_bwd_matches_jax_vjp(s, d, logw_kind, cotangent):
    """``rwkv6_scan_bwd`` from the plain forward's checkpoints of every 16
    steps equals ``jax.vjp`` of ``_wkv_scan(return_states=False)`` (w =
    exp(logw), a zero state0; dlogw = dw · w), S 130 past the reference's
    128-step chunk."""
    r, k, v, logw, u = _scan_inputs(s, d, logw_kind)
    rng = np.random.default_rng(s * d)
    if cotangent == "y":
        dy = rng.standard_normal((B, s, H, d)).astype(np.float32)
        dstate = None
    else:
        dy = np.zeros((B, s, H, d), np.float32)
        dstate = rng.standard_normal((B, H, d, d)).astype(np.float32)
    w = np.exp(logw)
    state0 = jnp.zeros((B, H, d, d), jnp.float32)
    (jy, jfinal), vjp = jax.vjp(
        lambda *a: jrwkv._wkv_scan(*a, state0, return_states=False),
        *(jnp.asarray(x) for x in (r, k, v, w, u)))
    jds = (jnp.zeros_like(jfinal) if dstate is None
           else jnp.asarray(dstate)[:, None])
    jdr, jdk, jdv, jdw, jdu = vjp((jnp.asarray(dy), jds))

    tr, tk, tv, tlw, tu = (torch.as_tensor(x) for x in (r, k, v, logw, u))
    y, final, ck = ref.rwkv6_scan(tr, tk, tv, tlw, tu, chunk=16)
    _close(y, jy, "y")
    _close(final, np.asarray(jfinal)[:, 0], "final state")
    got = ref.rwkv6_scan_bwd(tr, tk, tv, tlw, tu, ck, torch.as_tensor(dy),
                             None if dstate is None else torch.as_tensor(dstate),
                             chunk=16)
    want = (jdr, jdk, jdv, np.asarray(jdw) * w, jdu)
    for name, g, wt in zip(("dr", "dk", "dv", "dlogw", "du"), got, want):
        assert g.dtype == torch.float32
        _close(g, wt, name)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("d", [16, 32])
def test_rwkv6_scan_function_matches_autograd_through_the_plain_forward(
        d, with_state):
    """``RWKV6Scan`` on CPU tensors (the plain forward with checkpoints,
    the plain reverse scan) against autograd through the step-by-step
    plain forward, for a loss on y and, with ``with_state``, on the final
    state too."""
    s = 29
    xs = _scan_inputs(s, d, "-8", seed=5)
    rng = np.random.default_rng(9)
    wy = torch.as_tensor(rng.standard_normal((B, s, H, d)).astype(np.float32))
    ws = torch.as_tensor(rng.standard_normal((B, H, d, d)).astype(np.float32))
    # mild decay: -exp(N(-1, 0.5)), as the model's
    xs = xs[:3] + (-np.exp(rng.standard_normal(xs[3].shape) * 0.5 - 1.0
                           ).astype(np.float32), xs[4])
    grads = []
    for run in ("function", "autograd"):
        ins = [torch.as_tensor(x).requires_grad_(True) for x in xs]
        if run == "function":
            y, state = RWKV6Scan.apply(*ins, 16)
        else:
            y, state = ref.rwkv6_scan(*ins)
        loss = (y * wy).sum() + ((state * ws).sum() if with_state else 0.0)
        loss.backward()
        grads.append([x.grad for x in ins])
    for name, g, w in zip(("r", "k", "v", "logw", "u"), *grads):
        _close(g, w.numpy(), name)


def test_rwkv6_scan_function_keeps_the_input_dtypes():
    """bf16 r/k/v get bf16 gradients; logw and u stay f32."""
    xs = _scan_inputs(20, 16, "-8", seed=2)
    ins = [torch.as_tensor(x) for x in xs]
    ins = [t.bfloat16() if i < 3 else t for i, t in enumerate(ins)]
    ins = [t.requires_grad_(True) for t in ins]
    y, _ = RWKV6Scan.apply(*ins, 16)
    y.sum().backward()
    assert [x.grad.dtype for x in ins] == [torch.bfloat16] * 3 + [torch.float32] * 2


@pytest.mark.parametrize("chunk", [1, 8, 16, 37])
def test_gradients_do_not_depend_on_the_chunk(chunk):
    """Through ``ops.rwkv6_scan`` (the grad route): the chunk between
    checkpoints, 1 to S, changes no gradient's bits: the recomputed states
    repeat the forward's arithmetic."""
    s = 37
    xs = _scan_inputs(s, 32, "mixed", seed=7)
    wy = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (B, s, H, 32)).astype(np.float32))
    grads = []
    for c in (s, chunk):
        ins = [torch.as_tensor(x).requires_grad_(True) for x in xs]
        y, state = ops.rwkv6_scan(*ins, chunk=c)
        ((y * wy).sum() + state.sum()).backward()
        grads.append([x.grad for x in ins])
    for g, w in zip(*grads):
        assert torch.equal(g, w)


def test_no_grad_scan_saves_nothing():
    """Under no_grad (decode, serve) ``ops.rwkv6_scan`` is the plain
    forward: two outputs, no graph, whatever requires grad."""
    xs = [torch.as_tensor(x).requires_grad_(True)
          for x in _scan_inputs(17, 16, "-8")]
    with torch.no_grad():
        y, state = ops.rwkv6_scan(*xs)
    assert y.grad_fn is None and state.grad_fn is None
    y, state = ops.rwkv6_scan(*xs)
    assert type(y.grad_fn).__name__ == "RWKV6ScanBackward"


# ---------------------------------------------------------------------------
# one make_train_step against the reference's
# ---------------------------------------------------------------------------


TRAIN_CASES = {
    "fine-tuned": dict(),
    "frozen": dict(freeze_base=True),
    "ss_self_frozen": dict(freeze_base=True, scheduled_sampling=True,
                           ss_ratio=0.5, ss_self_targets=True),
}


def _train_cfg(model):
    if model == "tiny":
        return tiny_rwkv()
    return jconfig.get_config("rwkv6-1.6b", smoke=True).replace(dtype="float32")


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
@pytest.mark.parametrize("model", ["tiny", "smoke"])
def test_make_train_step_matches_reference(model, case):
    """B 3 x S 40 (a ragged 16-step chunk last): the loss, the gradient
    norm and every gradient (every time-mix leaf through the scan's
    backward) equal the reference's jitted step, and every updated leaf
    and AdamW's moments equal the reference's ``optimizer_update`` applied
    to the port's gradients (AdamW's first step magnifies 1e-5-of-max
    gradient noise, as for hymba).

    The heads' ReLU has a kink at 0: a pre-activation within fp32 noise of
    it may be gated on one side and not on the other, and the two
    gradients are then both right and far apart (lm_batch seed 4 puts one
    of the smoke model's 3 x 40 x 3 x 256 at 1.4e-8, 3e-9 of the largest,
    and its w1 gradient 25% apart).  So the batch is checked first to keep
    every head pre-activation (gold tokens) at least 1e-6 of the largest
    away from the kink."""
    jcfg = _train_cfg(model)
    tree = _randomize(jmodel.init(jax.random.PRNGKey(0), jcfg), 1)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    kw = TRAIN_CASES[case]
    frozen = kw.get("freeze_base", False)
    jtc = jconfig.TrainConfig(lr=1e-3, warmup_steps=1, head_loss="random", **kw)
    batch = lm_batch(jcfg, b=3, s=40, seed=6)
    key = jax.random.PRNGKey(11)
    jmask = joptim.freeze_mask(jp, train_only_heads=True) if frozen else None
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss_fn = jtrain.loss_fn_for(jcfg)
    jg = jax.jit(jax.grad(lambda p, b, k: jloss_fn(p, jcfg, jtc, b, k)[0]))(
        jp, jb, key)
    _, _, jm = jax.jit(jsteps.make_train_step(jcfg, jtc, mask=jmask))(
        jp, joptim.optimizer_init(jp, jtc), jb, key)

    tcfg, ttc = ModelConfig(**dataclasses.asdict(jcfg)), port_tc(jtc)
    assert ttrain.loss_fn_for(tcfg) is ttrain.lm_loss
    tp = bridge.from_jax_params(tree, tcfg, device="cpu")
    with torch.no_grad():
        hidden, _ = tmodel.forward_hidden(
            tp, tcfg, tmodel.embed_inputs(tp, tcfg, to_torch(batch)))
        pre = (torch.einsum("bsd,dkh->bskh", hidden, tp["bpd_heads"]["w1"])
               + tp["bpd_heads"]["b1"])[:, :, 1:]
    assert float(pre.abs().min()) > 1e-6 * float(pre.abs().max())
    tmask = freeze_mask(tp, train_only_heads=True) if frozen else None
    topt = optimizer_init(tp, ttc, tmask)
    head, swap = ref_draws(key, jcfg, jtc, batch["tokens"].shape)
    step = tsteps.make_train_step(tcfg, ttc, mask=tmask)
    tp, topt, tm = step(tp, topt, to_torch(batch), None, head_idx=head,
                        swap=None if swap is None else torch.as_tensor(swap))

    for name in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   err_msg=name, **TRAIN_TOL)
    grads = port_grads(tp)
    for name, want in jflatten(jg):
        want = np.asarray(want)
        np.testing.assert_allclose(
            grads[name].numpy(), want, rtol=GRAD_RTOL,
            atol=1e-5 * float(np.abs(want).max(initial=0.0)), err_msg=name)
    if not frozen:
        for leaf in ("w0", "u", "wr", "wk", "wv", "decay_A"):
            assert float(grads[f"blocks/0/tm/{leaf}"].abs().max()) > 0, leaf
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
# the launcher
# ---------------------------------------------------------------------------


def test_train_launcher_rwkv6_checkpoint_round_trip(tmp_path, capsys):
    """3 steps of rwkv6-1.6b's smoke config on the CPU with a checkpoint
    directory: the saved weights restore bit for bit, and a second run
    resumes from step 3."""
    from repro_torch.checkpoint import latest_step, restore
    from repro_torch.launch import train

    d = str(tmp_path / "ck")
    argv = ["--arch", "rwkv6-1.6b", "--device", "cpu", "--batch", "2",
            "--seq", "24", "--log-every", "1", "--ckpt-dir", d]
    out = train.main(argv + ["--steps", "3"])
    assert out["start"] == 0 and latest_step(d) == 3
    assert np.isfinite(float(out["metrics"]["loss"]))
    assert "[train] step     3  loss" in capsys.readouterr().out
    restored, extra = restore(d, out["params"])
    assert extra == {"arch": "rwkv6-1.6b"}
    for (name, a), (_, b) in zip(flatten_with_names(restored),
                                 flatten_with_names(out["params"])):
        assert torch.equal(a, b), name
    again = train.main(argv + ["--steps", "4"])
    assert again["start"] == 3 and latest_step(d) == 4
    assert "[train] restored step 3" in capsys.readouterr().out

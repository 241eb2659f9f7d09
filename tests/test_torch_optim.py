"""The port's optimizers against ``repro.optim`` on the CPU, in fp32: three
AdamW / Adafactor updates from the same params, grads and state under each
schedule, with clipping on and off, under ``freeze_mask`` and a fractional
``lr_scale_mask``; the schedules; the masks; the tree helpers; and one
whole ``make_train_step`` (loss, every gradient, every updated leaf and the
optimizer state) against the reference's jitted step.

Tolerances: rtol 1e-5 and atol 1e-5 × the leaf's max |value|, as in
``test_torch_train.py``.  The gradients of the update tests are drawn away
from zero, so AdamW's sign-sensitive first step is determined everywhere;
the whole step's are the model's (``assert_params_close``)."""
import dataclasses
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_dense  # noqa: E402
from repro import config as jconfig  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.core import train as jtrain  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.utils import tree as jtree  # noqa: E402
from repro.utils.tree import flatten_with_names as jflatten  # noqa: E402
from repro_torch import bridge, config as tconfig  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.optim import freeze_mask, optimizer_init  # noqa: E402
from repro_torch.utils import tree as ttree  # noqa: E402
from repro_torch.utils.tree import flatten_with_names  # noqa: E402
from test_torch_train import (  # noqa: E402
    TOL,
    assert_leaf_close,
    assert_tree_close,
    bridged,
    dense,
    lm_batch,
    port_cfg,
    port_grads,
    port_tc,
    ref_draws,
    s2s,
    s2s_batch,
    to_torch,
)

torch.set_num_threads(2)

SHAPES = {"bpd_heads": {"w1": (6, 3, 5), "b1": (3, 5), "w2": (3, 5, 6),
                        "b2": (3, 6)},
          "blocks": [{"attn": {"wq": (6, 2, 3)}, "ln1": {"scale": (6,)}}],
          "embed": {"table": (11, 6)}}


def make_tree(fn, shapes=SHAPES):
    if isinstance(shapes, dict):
        return {k: make_tree(fn, v) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [make_tree(fn, v) for v in shapes]
    return fn(shapes)


def draw(rng, away_from_zero=False):
    def fn(shape):
        x = rng.standard_normal(shape).astype(np.float32)
        if away_from_zero:                  # |g| in [0.05, ...): sign fixed
            x = np.where(x >= 0, x + 0.05, x - 0.05).astype(np.float32)
        return x
    return fn


def check_close(got, want, name):
    want = np.asarray(want)
    atol = 1e-5 * float(np.abs(want).max(initial=0.0))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=atol,
                               err_msg=name)


def port_tree(np_tree):
    return make_tree_like(np_tree, lambda a: torch.tensor(a))


def make_tree_like(tree, fn):
    if isinstance(tree, dict):
        return {k: make_tree_like(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [make_tree_like(v, fn) for v in tree]
    return fn(tree)


def masks(kind, np_params):
    jp = make_tree_like(np_params, jnp.asarray)
    if kind == "none":
        return None, None
    if kind == "freeze":
        return (joptim.freeze_mask(jp, train_only_heads=True),
                toptim.freeze_mask(np_params, train_only_heads=True))
    return (joptim.lr_scale_mask(jp, trunk_scale=0.25),
            toptim.lr_scale_mask(np_params, trunk_scale=0.25))


# ---------------------------------------------------------------------------
# schedules and masks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", ["inv_sqrt", "cosine", "constant"])
def test_schedules_match_reference(schedule):
    kw = dict(lr=3e-3, warmup_steps=7, steps=40, schedule=schedule)
    want = joptim.make_schedule(jconfig.TrainConfig(**kw))
    got = toptim.make_schedule(tconfig.TrainConfig(**kw))
    for step in (0, 1, 2, 6, 7, 8, 20, 39, 40, 55):
        assert got(step) == float(want(jnp.asarray(step, jnp.int32))), step


def test_masks_match_reference():
    np_params = make_tree(draw(np.random.default_rng(0)))
    jp = make_tree_like(np_params, jnp.asarray)
    for jm, tm in [(joptim.freeze_mask(jp, train_only_heads=True),
                    toptim.freeze_mask(np_params, train_only_heads=True)),
                   (joptim.lr_scale_mask(jp, trunk_scale=0.3),
                    toptim.lr_scale_mask(np_params, trunk_scale=0.3))]:
        assert {n: float(v) for n, v in jtree.flatten_with_names(jm)} == \
            pytest.approx(tm)
    assert toptim.freeze_mask(np_params, train_only_heads=False) is None


# ---------------------------------------------------------------------------
# three updates against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mask_kind", ["none", "freeze", "lr_scale"])
@pytest.mark.parametrize("clip", [0.0, 1.0])
@pytest.mark.parametrize("schedule", ["inv_sqrt", "cosine", "constant"])
@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_three_updates_match_reference(optimizer, schedule, clip, mask_kind):
    rng = np.random.default_rng(zlib.crc32(f"{optimizer}{schedule}{clip}{mask_kind}".encode()))
    kw = dict(optimizer=optimizer, schedule=schedule, grad_clip=clip, lr=1e-2,
              warmup_steps=2, steps=10, weight_decay=0.05)
    jtc, ttc = jconfig.TrainConfig(**kw), tconfig.TrainConfig(**kw)
    np_params = make_tree(draw(rng))
    jmask, tmask = masks(mask_kind, np_params)
    jp = make_tree_like(np_params, jnp.asarray)
    tp = port_tree(np_params)
    jstate = joptim.optimizer_init(jp, jtc)
    tstate = toptim.optimizer_init(tp, ttc, tmask)
    trained = [n for n, _ in ttree.flatten_with_names(tp)
               if tmask is None or tmask[n] > 0]
    for _ in range(3):
        g = make_tree(draw(rng, away_from_zero=True))
        jp, jstate, jm = joptim.optimizer_update(
            make_tree_like(g, jnp.asarray), jstate, jp, jtc, mask=jmask)
        tgrads = dict(ttree.flatten_with_names(port_tree(g)))
        tp, tstate, tm = toptim.optimizer_update(tgrads, tstate, tp, ttc, mask=tmask)
        check_close(float(tm["grad_norm"]), float(jm["grad_norm"]), "grad_norm")
        assert tm["lr"] == float(jm["lr"])
        for n, want in jtree.flatten_with_names(jp):
            check_close(dict(ttree.flatten_with_names(tp))[n].numpy(), want, n)
        if optimizer == "adamw":
            jmu = dict(jtree.flatten_with_names(jstate["mu"]))
            jnu = dict(jtree.flatten_with_names(jstate["nu"]))
            assert sorted(tstate["mu"]) == sorted(trained)
            for n in trained:
                check_close(tstate["mu"][n].numpy(), jmu[n], f"mu {n}")
                check_close(tstate["nu"][n].numpy(), jnu[n], f"nu {n}")
        else:
            jv = dict(jtree.flatten_with_names(jstate["v"]))
            assert sorted(tstate["v"]) == sorted(trained)
            for n in trained:
                for k, v in tstate["v"][n].items():
                    check_close(v.numpy(), jv[f"{n}/{k}"], f"v {n}/{k}")
    assert tstate["step"] == int(jstate["step"]) == 3


def test_frozen_leaves_hold_no_state_and_do_not_move():
    """A frozen leaf keeps its value and has no moments; a leaf the mask
    trains but no gradient reaches decays by weight decay alone, as the
    reference's zero gradient makes it."""
    rng = np.random.default_rng(1)
    tp = port_tree(make_tree(draw(rng)))
    before = {n: p.clone() for n, p in ttree.flatten_with_names(tp)}
    mask = toptim.freeze_mask(tp, train_only_heads=True)
    ttc = tconfig.TrainConfig(lr=1e-2, warmup_steps=1)
    state = toptim.optimizer_init(tp, ttc, mask)
    assert all(n.startswith("bpd_heads") for n in state["mu"])
    grads = {"bpd_heads/w1": torch.ones((6, 3, 5)), "embed/table": torch.ones((11, 6))}
    toptim.optimizer_update(grads, state, tp, ttc, mask=mask)
    after = dict(ttree.flatten_with_names(tp))
    for n, p in before.items():
        if n.startswith("bpd_heads"):
            assert not torch.equal(after[n], p), n
        else:
            assert torch.equal(after[n], p), n
    lr = toptim.make_schedule(ttc)(1)
    b2 = before["bpd_heads/b2"]
    torch.testing.assert_close(after["bpd_heads/b2"], b2 - lr * ttc.weight_decay * b2)


# ---------------------------------------------------------------------------
# tree helpers
# ---------------------------------------------------------------------------


def test_tree_helpers_match_reference():
    jcfg = tiny_dense()
    jp = jmodel.init(jax.random.PRNGKey(0), jcfg)
    tp = bridge.from_jax_params(jax.tree_util.tree_map(np.asarray, jp),
                                tconfig.ModelConfig(**dataclasses.asdict(jcfg)),
                                device="cpu")
    want = dict(jtree.flatten_with_names(jp))
    got = dict(ttree.flatten_with_names(tp))
    assert sorted(got) == sorted(want)
    assert {"bpd_heads/w1", "blocks/0/attn/wq", "blocks/1/mlp/w2/w"} <= set(got)
    assert ttree.tree_size(tp) == jtree.tree_size(jp)
    nested = make_tree(draw(np.random.default_rng(2)))
    assert sorted(n for n, _ in ttree.flatten_with_names(port_tree(nested))) == \
        sorted(n for n, _ in jtree.flatten_with_names(
            make_tree_like(nested, jnp.asarray)))
    check_close(float(ttree.global_norm(p for _, p in ttree.flatten_with_names(tp))),
                float(jtree.global_norm(jp)), "global_norm")
    assert ttree.tree_map_with_name(lambda n, p: n.startswith("bpd"), tp)["bpd_heads/b1"]
    assert float(ttree.global_norm([])) == 0.0


def test_set_trainable_turns_grads_on_for_masked_leaves_only():
    tcfg = tconfig.ModelConfig(**dataclasses.asdict(tiny_dense()))
    params = tmodel.init(tcfg, device="cpu")
    assert not any(p.requires_grad for p in params.parameters())
    tmodel.set_trainable(params, toptim.freeze_mask(params, train_only_heads=True))
    on = {n for n, p in ttree.flatten_with_names(params) if p.requires_grad}
    assert on == {"bpd_heads/w1", "bpd_heads/b1", "bpd_heads/w2", "bpd_heads/b2"}
    tmodel.set_trainable(params, None)
    assert all(p.requires_grad for p in params.parameters())


def assert_params_close(port, ref, ref_grads, lr, mask, adamw):
    """Updated leaves as ``assert_tree_close``, except that AdamW's first
    step moves an element by lr·g/(|g| + eps): where the reference's
    gradient lies within the gradient tolerance of zero its sign is not
    determined by fp32 arithmetic, and the element may differ by up to
    2·lr·mask (the two signs' updates)."""
    grads = dict(jflatten(ref_grads))
    for n, want in jflatten(ref):
        want, got = np.asarray(want), port[n].detach().numpy()
        atol = 1e-5 * float(np.abs(want).max(initial=0.0))
        bad = np.abs(got - want) > atol + 1e-5 * np.abs(want)
        if adamw:
            g = np.abs(np.asarray(grads[n]))
            undetermined = g <= 1e-5 * g.max(initial=0.0) + 1e-5 * g
            m = 1.0 if mask is None else mask[n]
            flip_ok = np.abs(got - want) <= 2 * lr * m + atol
            bad &= ~(undetermined & flip_ok)
        assert not bad.any(), (n, int(bad.sum()), float(np.abs(got - want).max()))


# ---------------------------------------------------------------------------
# make_train_step: one whole step against the reference's jitted step
# ---------------------------------------------------------------------------


STEP_CASES = {
    "lm_frozen_adamw": ("lm", dict(freeze_base=True), True),
    "lm_finetune_adamw": ("lm", dict(), False),
    "lm_frozen_ss_self": ("lm", dict(freeze_base=True, scheduled_sampling=True,
                                     ss_self_targets=True), True),
    "lm_finetune_adafactor": ("lm", dict(optimizer="adafactor"), False),
    "s2s_finetune_adamw": ("s2s", dict(), False),
    "s2s_frozen_adafactor": ("s2s", dict(freeze_base=True,
                                         optimizer="adafactor"), True),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_make_train_step_matches_reference(dense, s2s, case):
    kind, kw, frozen = STEP_CASES[case]
    jcfg, jp = dense if kind == "lm" else s2s
    jtc = jconfig.TrainConfig(lr=1e-3, warmup_steps=1, **kw)
    batch = lm_batch(jcfg) if kind == "lm" else s2s_batch(jcfg)
    shape = batch["tokens" if kind == "lm" else "tgt"].shape
    key = jax.random.PRNGKey(11)
    jmask = joptim.freeze_mask(jp, train_only_heads=True) if frozen else None
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss_fn = jtrain.loss_fn_for(jcfg)
    jg = jax.jit(jax.grad(lambda p, b, k: jloss_fn(p, jcfg, jtc, b, k)[0]))(jp, jb, key)
    jparams, jopt, jm = jax.jit(jsteps.make_train_step(jcfg, jtc, mask=jmask))(
        jp, joptim.optimizer_init(jp, jtc), jb, key)

    tcfg, ttc = port_cfg(jcfg), port_tc(jtc)
    tp = bridged(jcfg, jp)
    tmask = freeze_mask(tp, train_only_heads=True) if frozen else None
    topt = optimizer_init(tp, ttc, tmask)
    head, swap = ref_draws(key, jcfg, jtc, shape)
    step = tsteps.make_train_step(tcfg, ttc, mask=tmask)
    tp, topt, tm = step(tp, topt, to_torch(batch), None, head_idx=head,
                        swap=None if swap is None else torch.tensor(swap))

    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), **TOL)
    np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-7)
    assert_tree_close(port_grads(tp), jg)
    assert_params_close(dict(flatten_with_names(tp)), jparams, jg, tm["lr"], tmask,
                        ttc.optimizer == "adamw")
    trained = sorted(n for n, _ in flatten_with_names(tp)
                     if tmask is None or tmask[n] > 0)
    if ttc.optimizer == "adamw":
        assert sorted(topt["mu"]) == trained
        assert_tree_close(topt["mu"], jopt["mu"], trained)
        assert_tree_close(topt["nu"], jopt["nu"], trained)
    else:
        for n in trained:
            for k, v in topt["v"][n].items():
                assert_leaf_close(v.numpy(), dict(jflatten(jopt["v"]))[f"{n}/{k}"],
                                  f"{n}/{k}")
    assert topt["step"] == int(jopt["step"]) == 1


def test_global_norm_is_exact_on_large_leaves():
    """The clip's norm of a leaf of millions of elements equals its float64
    value to fp32 rounding, as the reference's fp32 sum does (an fp32
    vector_norm on the CPU does not)."""
    rng = np.random.default_rng(4)
    big = rng.standard_normal((4096, 4096)).astype(np.float32) * 1e-3
    small = rng.standard_normal((7, 5)).astype(np.float32)
    want = np.sqrt(np.sum(big.astype(np.float64) ** 2)
                   + np.sum(small.astype(np.float64) ** 2))
    got = ttree.global_norm([torch.as_tensor(big), torch.as_tensor(small)])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=2e-7)
    jgot = jtree.global_norm({"a": jnp.asarray(big), "b": jnp.asarray(small)})
    np.testing.assert_allclose(float(jgot), want, rtol=1e-6)

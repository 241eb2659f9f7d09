"""The MoE family (olmoe-1b-7b, qwen2-moe-a2.7b) in the port against the JAX
reference, in fp32 on the CPU, on weights made by the reference and carried
across by ``bridge``: the registered configs; ``moe_apply`` at both smoke
geometries and a padded one (6 experts padded to 8), with full capacity and
capacity-bounded with drops; the assignment ranks on ids with many
repeats; the zero-router tie; pad experts never chosen nor computed;
full-forward logits and metrics; the cached block step, chain and tree;
that every decode path asks for full capacity and training does not; and
one whole ``make_train_step`` with the router's aux and z terms.

Tolerances: outputs and logits within 2e-5 (fp32 on both sides, sums in
another order), the metrics within 1e-6, ids, ranks and the kept mask
exactly; the training step as ``test_torch_optim.py``'s.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import config as jconfig  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.core import train as jtrain  # noqa: E402
from repro.kernels.tree_mask import default_tree as jdefault_tree  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import config as tconfig  # noqa: E402
from repro_torch.config import DecodeConfig  # noqa: E402
from repro_torch.core import ModelBundle  # noqa: E402
from repro_torch.core import decode as tdecode  # noqa: E402
from repro_torch.core import train as ttrain  # noqa: E402
from repro_torch.kernels.tree_mask import default_tree  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.blocks import check_supported  # noqa: E402
from repro_torch.optim import freeze_mask, optimizer_init  # noqa: E402
from repro_torch.utils.tree import flatten_with_names  # noqa: E402
from test_torch_optim import assert_params_close  # noqa: E402
from test_torch_train import (  # noqa: E402
    TOL as TRAIN_TOL,
    assert_tree_close,
    bridged,
    lm_batch,
    port_cfg,
    port_grads,
    port_tc,
    ref_draws,
    to_torch,
)

torch.set_num_threads(2)
TOL = dict(rtol=2e-5, atol=2e-5)
METRIC_TOL = dict(rtol=1e-6, atol=1e-6)
MOE_ARCHS = ("olmoe-1b-7b", "qwen2-moe-a2.7b")
GEOMETRIES = {
    "olmoe-1b-7b": ("olmoe-1b-7b", {}),
    "qwen2-moe-a2.7b": ("qwen2-moe-a2.7b", {}),
    "padded-6-of-8": ("qwen2-moe-a2.7b", dict(num_experts=6,
                                               expert_pad_multiple=8)),
}
B, S = 3, 40


def moe_config(geometry: str):
    name, kw = GEOMETRIES[geometry]
    return jconfig.get_config(name, smoke=True).replace(dtype="float32", **kw)


def to_port(tree):
    if isinstance(tree, dict):
        return {k: to_port(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree))


@pytest.fixture(scope="module", params=list(GEOMETRIES))
def layer(request):
    jcfg = moe_config(request.param)
    jp = jmoe.moe_init(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(4)
    # tokens share a direction, so the router favours a few experts and the
    # capacity-bounded path drops assignments
    x = (rng.standard_normal((B, S, jcfg.d_model))
         + rng.standard_normal(jcfg.d_model)).astype(np.float32)
    return jcfg, port_cfg(jcfg), jp, to_port(jp), x


def reference_routing(jp, jcfg, x, full_capacity):
    """The reference's expert ids (B, S, K) and kept mask (B, S·K), as its
    ``moe_apply`` computes them."""
    probs = jax.nn.softmax(jnp.asarray(x) @ jp["router"]["w"], axis=-1)
    _, ids = jax.lax.top_k(probs, jcfg.num_experts_per_tok)
    cap = S if full_capacity else int(max(
        1, jcfg.capacity_factor * jcfg.num_experts_per_tok * S
        / jcfg.num_experts))
    ranks = jax.vmap(jmoe._assignment_ranks)(ids.reshape(B, -1))
    return np.asarray(ids), np.asarray(ranks < min(cap, S))


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_registered_moe_configs_match_reference(arch, smoke):
    want = jconfig.get_config(arch, smoke=smoke)
    got = tconfig.get_config(arch, smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.padded_num_experts == want.padded_num_experts
    check_supported(got)
    assert ttrain.loss_fn_for(got) is ttrain.lm_loss


@pytest.mark.parametrize("full_capacity", [True, False])
def test_moe_apply_matches_reference(layer, full_capacity):
    jcfg, tcfg, jp, tp, x = layer
    jy, jm = jmoe.moe_apply(jp, jcfg, jnp.asarray(x),
                            full_capacity=full_capacity)
    ty, tm = tmoe.moe_apply(tp, tcfg, torch.tensor(x),
                            full_capacity=full_capacity)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for name in ("moe_aux_loss", "moe_z_loss", "moe_dropped_frac"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   err_msg=name, **METRIC_TOL)
    jids, jkeep = reference_routing(jp, jcfg, x, full_capacity)
    _, _, _, ids = tmoe.route(tp, tcfg, torch.tensor(x))
    np.testing.assert_array_equal(ids.numpy(), jids)
    cap = S if full_capacity else tmoe.capacity(tcfg, S)
    keep = tmoe.assignment_ranks(ids.reshape(B, -1)) < cap
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    if full_capacity:
        assert keep.all() and float(tm["moe_dropped_frac"]) == 0.0
    else:
        assert not keep.all() and float(tm["moe_dropped_frac"]) > 0.0


def test_assignment_ranks_match_reference_on_repeats():
    ids = np.random.default_rng(5).integers(0, 3, (4, 50)).astype(np.int32)
    want = np.asarray(jax.vmap(jmoe._assignment_ranks)(jnp.asarray(ids)))
    got = tmoe.assignment_ranks(torch.tensor(ids).long())
    np.testing.assert_array_equal(got.numpy(), want)
    for row, ranks in zip(ids, got.numpy()):
        for e in range(3):
            assert ranks[row == e].tolist() == list(range(int((row == e).sum())))


@pytest.mark.parametrize("full_capacity", [True, False])
def test_zero_router_picks_the_lowest_ids(layer, full_capacity):
    """Every probability ties: both sides take experts 0..K-1 with equal
    gates, and the outputs agree."""
    jcfg, tcfg, jp, tp, x = layer
    jp = dict(jp, router={"w": jnp.zeros_like(jp["router"]["w"])})
    tp = dict(tp, router={"w": torch.zeros_like(tp["router"]["w"])})
    _, _, gates, ids = tmoe.route(tp, tcfg, torch.tensor(x))
    k = tcfg.num_experts_per_tok
    assert (ids == torch.arange(k)).all()
    torch.testing.assert_close(gates, torch.full_like(gates, 1.0 / k))
    np.testing.assert_array_equal(ids.numpy(),
                                  reference_routing(jp, jcfg, x, True)[0])
    jy, _ = jmoe.moe_apply(jp, jcfg, jnp.asarray(x),
                           full_capacity=full_capacity)
    ty, _ = tmoe.moe_apply(tp, tcfg, torch.tensor(x),
                           full_capacity=full_capacity)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)


@pytest.mark.parametrize("full_capacity", [True, False])
def test_pad_experts_are_never_chosen_nor_computed(full_capacity):
    jcfg = moe_config("padded-6-of-8")
    tcfg = port_cfg(jcfg)
    assert (tcfg.num_experts, tcfg.padded_num_experts) == (6, 8)
    jp = jmoe.moe_init(jax.random.PRNGKey(6), jcfg)
    tp = to_port(jp)
    assert tp["w1"].shape[0] == tp["w2"].shape[0] == tp["w3"].shape[0] == 8
    x = torch.randn((B, S, tcfg.d_model),
                    generator=torch.Generator().manual_seed(7))
    want, _ = tmoe.moe_apply(tp, tcfg, x, full_capacity=full_capacity)
    for leaf in ("w1", "w2", "w3"):
        tp[leaf][6:] = float("nan")
    got, _ = tmoe.moe_apply(tp, tcfg, x, full_capacity=full_capacity)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert int(tmoe.route(tp, tcfg, x)[3].max()) < 6


# ---------------------------------------------------------------------------
# the whole model: forwards, block steps, where full capacity is asked for
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=MOE_ARCHS)
def model(request):
    jcfg = jconfig.get_config(request.param, smoke=True).replace(
        dtype="float32")
    jp = jmodel.init(jax.random.PRNGKey(1), jcfg)
    prompt = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (B, 24)).astype(np.int32)
    return jcfg, port_cfg(jcfg), jp, bridged(jcfg, jp), prompt


def _forward(jcfg, tcfg, jp, tp, prompt, full):
    jh, jm, _ = jmodel.forward_hidden(
        jp, jcfg, jmodel.embed_inputs(jp, jcfg, {"tokens": jnp.asarray(prompt)}),
        moe_full_capacity=full)
    tm = {}
    th, _ = tmodel.forward_hidden(
        tp, tcfg, tmodel.embed_inputs(tp, tcfg,
                                      {"tokens": torch.tensor(prompt)}),
        moe_full_capacity=full, metrics=tm)
    return jh, jm, th, tm


@pytest.mark.parametrize("full", [True, False])
def test_forward_logits_and_metrics_match_reference(model, full):
    jcfg, tcfg, jp, tp, prompt = model
    jh, jm, th, tm = _forward(jcfg, tcfg, jp, tp, prompt, full)
    want = np.asarray(jmodel.base_logits(jp, jcfg, jh))
    got = tmodel.base_logits(tp, tcfg, th).numpy()
    assert got.shape == want.shape == (B, 24, jcfg.padded_vocab_size)
    np.testing.assert_allclose(got, want, **TOL)
    assert sorted(tm) == sorted(jm)
    for name in jm:
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   err_msg=name, **METRIC_TOL)
    assert (float(tm["moe_dropped_frac"]) > 0) != full


def test_capacity_bounded_prefill_differs(model):
    """A 24-token prompt overflows the default capacity: the hidden states
    without ``moe_full_capacity`` are not the decode paths' ones."""
    jcfg, tcfg, jp, tp, prompt = model
    _, _, full, _ = _forward(jcfg, tcfg, jp, tp, prompt, True)
    _, _, bounded, m = _forward(jcfg, tcfg, jp, tp, prompt, False)
    assert float(m["moe_dropped_frac"]) > 0
    assert float((full - bounded).abs().max()) > 1e-2


@pytest.mark.parametrize("tree", [False, True])
def test_block_step_matches_reference(model, tree):
    """Prefill 16 tokens into both caches, then one block of 4 (a chain,
    or a tree of 4 nodes of fanout 2): hidden states within 2e-5."""
    jcfg, tcfg, jp, tp, prompt = model
    k, plen = 4, 16
    jc = jmodel.init_caches(jcfg, B, 32, k)
    tc = tmodel.init_caches(tcfg, B, 32, k, device="cpu")
    pos = np.arange(plen, dtype=np.int32)
    _, _, jc = jmodel.forward_hidden(
        jp, jcfg, jmodel.embed_inputs(jp, jcfg, {"tokens": jnp.asarray(
            prompt[:, :plen])}), positions=jnp.asarray(pos), caches=jc,
        moe_full_capacity=True)
    _, tc = tmodel.forward_hidden(
        tp, tcfg, tmodel.embed_inputs(tp, tcfg, {"tokens": torch.tensor(
            prompt[:, :plen])}), positions=torch.tensor(pos), caches=tc,
        moe_full_capacity=True)
    blk = prompt[:, plen:plen + k]
    length = np.full((B,), plen, np.int32)
    jh, _ = jmodel.decode_block_step(
        jp, jcfg, jmodel.embed_inputs(jp, jcfg, {"tokens": jnp.asarray(blk)}),
        jc, jnp.asarray(length), tree=jdefault_tree(k, 2) if tree else None)
    th, _ = tmodel.decode_block_step(
        tp, tcfg, tmodel.embed_inputs(tp, tcfg, {"tokens": torch.tensor(blk)}),
        tc, torch.tensor(length), tree=default_tree(k, 2) if tree else None)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)


def _flags(monkeypatch):
    """Record ``full_capacity`` of every ``moe_apply`` call."""
    seen = []
    real = tmoe.moe_apply

    def spy(*args, full_capacity=False, **kw):
        seen.append(full_capacity)
        return real(*args, full_capacity=full_capacity, **kw)
    monkeypatch.setattr(tmoe, "moe_apply", spy)
    return seen


@pytest.mark.parametrize("path", ["greedy", "exact", "topk_tree",
                                  "draft_model"])
def test_every_decode_path_runs_full_capacity(model, monkeypatch, path):
    """Prefills, block steps and a self-draft's own prefill and steps all
    ask for full capacity."""
    _, tcfg, _, tp, prompt = model
    seen = _flags(monkeypatch)
    batch = {"tokens": torch.tensor(prompt)}
    dec = DecodeConfig(max_new_tokens=6, block_k=4, top_k=2,
                       policy="" if path == "greedy" else path)
    if path == "greedy":
        tdecode.greedy_decode(tp, tcfg, dec, batch)
    else:
        bundles = ({"draft": ModelBundle(tp, tcfg)} if path == "draft_model"
                   else None)
        tdecode.bpd_decode(tp, tcfg, dec, batch, bundles=bundles)
    assert seen and all(seen), seen


def test_training_forward_is_capacity_bounded(model, monkeypatch):
    _, tcfg, _, tp, prompt = model
    seen = _flags(monkeypatch)
    tc = tconfig.TrainConfig(scheduled_sampling=True, ss_ratio=0.5)
    _, m = ttrain.lm_loss(tp, tcfg, tc, {"tokens": torch.tensor(prompt)},
                          torch.Generator().manual_seed(0))
    assert len(seen) == 2 * tcfg.num_layers and not any(seen)
    assert float(m["moe_dropped_frac"]) > 0


# ---------------------------------------------------------------------------
# one whole training step with the router's terms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("frozen", [False, True])
def test_make_train_step_matches_reference(frozen):
    """olmoe's smoke config, B 3 x S 24 (capacity 15 of 48 assignments a
    row: some dropped): loss, the three MoE metrics, every gradient, every
    updated leaf and AdamW's state equal the reference's jitted step.  With
    a frozen base the aux and z terms still reach the trunk, as in the
    reference, and the freeze mask keeps it in place."""
    jcfg = jconfig.get_config("olmoe-1b-7b", smoke=True).replace(
        dtype="float32")
    jp = jmodel.init(jax.random.PRNGKey(0), jcfg)
    jtc = jconfig.TrainConfig(lr=1e-3, warmup_steps=1, freeze_base=frozen)
    batch = lm_batch(jcfg, b=3, s=24)
    key = jax.random.PRNGKey(11)
    jmask = joptim.freeze_mask(jp, train_only_heads=True) if frozen else None
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss_fn = jtrain.loss_fn_for(jcfg)
    jg = jax.jit(jax.grad(lambda p, b, k: jloss_fn(p, jcfg, jtc, b, k)[0]))(
        jp, jb, key)
    jparams, jopt, jm = jax.jit(jsteps.make_train_step(jcfg, jtc, mask=jmask))(
        jp, joptim.optimizer_init(jp, jtc), jb, key)

    tcfg, ttc = port_cfg(jcfg), port_tc(jtc)
    tp = bridged(jcfg, jp)
    tmask = freeze_mask(tp, train_only_heads=True) if frozen else None
    topt = optimizer_init(tp, ttc, tmask)
    head, _ = ref_draws(key, jcfg, jtc, batch["tokens"].shape)
    step = tsteps.make_train_step(tcfg, ttc, mask=tmask)
    tp, topt, tm = step(tp, topt, to_torch(batch), None, head_idx=head)

    assert float(tm["moe_dropped_frac"]) > 0
    for name in ("loss", "grad_norm", "moe_aux_loss", "moe_z_loss",
                 "moe_dropped_frac"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   err_msg=name, **TRAIN_TOL)
    grads = port_grads(tp)
    assert_tree_close(grads, jg)
    assert float(grads["blocks/0/moe/router/w"].abs().max()) > 0
    assert_params_close(dict(flatten_with_names(tp)), jparams, jg, tm["lr"],
                        tmask, True)
    trained = sorted(n for n, _ in flatten_with_names(tp)
                     if tmask is None or tmask[n] > 0)
    assert_tree_close(topt["mu"], jopt["mu"], trained)
    assert_tree_close(topt["nu"], jopt["nu"], trained)

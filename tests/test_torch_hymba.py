"""The port's Hymba family against the JAX reference, on the CPU
(``conftest.tiny_hymba``: d 64, 4/2 heads, 2 layers, layer 0 global and
layer 1 windowed at 32, 4 meta tokens; and hymba-1.5b's smoke config;
weights made by ``repro.models.model.init``, the constant leaves redrawn,
carried across by ``bridge``): the Mamba heads in both modes with their
per-step conv and SSM states, the block's full and cached paths and the
commit at k̂ 0, 1 and k, full-forward logits, greedy and BPD under exact,
topk, distance and adaptive on the dense and the paged cache with prompts
past the window (the ring wraps around its reserved meta slots and the
prefill keeps the meta head), hand-made iterations that roll the Mamba
state back, ``reset_rows``, the bf16 cast, the refusals (tree verification,
the engine, a meta-token primary under ``draft_model``), one
``make_train_step`` frozen and fine-tuned, and both launchers.

Tolerances: the Mamba heads within 1e-5, blocks and logits within 2e-5
(fp32 on both sides, sums in another order); decoded tokens, iterations,
k̂ and invocations exactly; the training step as ``test_torch_optim.py``'s.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_dense, tiny_hymba  # noqa: E402
from repro import config as jconfig  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.config import DecodeConfig as JDecodeConfig  # noqa: E402
from repro.core import decode as jdecode  # noqa: E402
from repro.core import train as jtrain  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import cache as jcache  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving.types import EngineConfig as JEngineConfig  # noqa: E402
from repro_torch import bridge, config as tconfig  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.config import DecodeConfig, ModelConfig  # noqa: E402
from repro_torch.core import ModelBundle  # noqa: E402
from repro_torch.core import decode as tdecode  # noqa: E402
from repro_torch.core import train as ttrain  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import cache as tcache  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.optim import freeze_mask, optimizer_init  # noqa: E402
from repro_torch.utils.tree import flatten_with_names  # noqa: E402
from repro.utils.tree import flatten_with_names as jflatten  # noqa: E402
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
TOL = dict(rtol=2e-5, atol=2e-5)
MAMBA_TOL = dict(rtol=1e-5, atol=1e-5)
# B rows of PROMPT tokens: 4 meta + 380 prompt positions outrun the
# windowed layer's 256-slot ring at the prefill (the meta head is kept) and
# the decode wraps it further.  384 is a multiple of the reference's scan
# chunk of 128: at other lengths past 128 its prefill state is zero
# (``test_prefill_state_past_a_ragged_chunk``).
B, PROMPT, MAX_NEW, K = 2, 380, 10, 4
POLICY_KW = dict(top_k=2, epsilon=2.0)


def _x(shape, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               **(tol or TOL))


def _randomize(tree, seed):
    """The reference's init leaves constants in the conv bias, D, the
    fusion betas and the norms; draw each such leaf (numpy, seeded) so the
    comparison sees every one."""
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(np.asarray, tree)

    def near_one(a):
        return (1 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    for blk in tree["blocks"]:
        mb = blk["mamba"]
        mb["conv_b"] = (0.1 * rng.standard_normal(mb["conv_b"].shape)
                        ).astype(np.float32)
        mb["D"] = near_one(mb["D"])
        for name in ("beta_attn", "beta_ssm"):
            blk[name] = near_one(blk[name])
        for norm in ("ln1", "ln2", "fuse_ln_attn", "fuse_ln_ssm"):
            blk[norm]["scale"] = near_one(blk[norm]["scale"])
    tree["final_norm"]["scale"] = near_one(tree["final_norm"]["scale"])
    return tree


def _bridged(jcfg, seed):
    """(reference params as jnp, port cfg, port params) from one tree."""
    tree = _randomize(jmodel.init(jax.random.PRNGKey(seed), jcfg), seed)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    tp = bridge.from_jax_params(tree, tcfg, device="cpu")
    return jax.tree_util.tree_map(jnp.asarray, tree), tcfg, tp


@pytest.fixture(scope="module")
def setup():
    jcfg = tiny_hymba()
    jp, tcfg, tp = _bridged(jcfg, 3)
    prompt = np.random.default_rng(4).integers(0, jcfg.vocab_size,
                                               (B, PROMPT)).astype(np.int32)
    return jcfg, tcfg, jp, tp, prompt


def _mamba(setup, layer=0):
    jcfg, tcfg, jp, tp, _ = setup
    return jp["blocks"][layer]["mamba"], tp["blocks"][layer]["mamba"]


# ---------------------------------------------------------------------------
# config and parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True])
def test_registered_hymba_matches_reference(smoke):
    want = jconfig.get_config("hymba-1.5b", smoke=smoke)
    got = tconfig.get_config("hymba-1.5b", smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.padded_vocab_size == want.padded_vocab_size == (
        32256 if not smoke else 256)
    tblocks.check_supported(got)


def test_meta_tokens_only_with_the_hymba_block():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tblocks.check_supported(ModelConfig(**dataclasses.asdict(
            tiny_dense(num_meta_tokens=4))))


def test_state_dict_keys_are_reference_paths(setup):
    """Every leaf of the reference's tree (meta tokens, the Mamba heads,
    the fusion norms and betas) under its key path, also from the port's
    own init on the meta device."""
    jcfg, tcfg, jp, tp, _ = setup
    paths = {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
             tuple(np.shape(leaf))
             for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert {k: tuple(v.shape) for k, v in tp.state_dict().items()} == paths
    for key in ("meta_tokens", "blocks.1.mamba.dt_proj.b",
                "blocks.0.mamba.A_log", "blocks.0.fuse_ln_ssm.scale",
                "blocks.1.beta_attn", "lm_head.w"):
        assert key in paths
    meta = tmodel.init(tcfg, device="meta")
    assert {k: tuple(v.shape) for k, v in meta.state_dict().items()} == paths


def test_init_draws_the_reference_distributions():
    """The port's own init (another generator, so other numbers): A_log and
    D exactly the reference's, dt_proj's bias the softplus inverse of a dt
    in [1e-3, 1e-1], the meta tokens at std 0.02 (the two logs of A_log
    may differ in the last bit)."""
    cfg = ModelConfig(**dataclasses.asdict(tiny_hymba()))
    tp = tmodel.init(cfg, seed=1, device="cpu")
    jp = jmodel.init(jax.random.PRNGKey(1), tiny_hymba())
    mb, jmb = tp["blocks"][0]["mamba"], jp["blocks"][0]["mamba"]
    close(mb["A_log"], jmb["A_log"], rtol=1e-7, atol=0)
    close(mb["D"], jmb["D"], rtol=0, atol=0)
    dt = torch.nn.functional.softplus(mb["dt_proj"]["b"])
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1 * 1.001
    assert 0.015 < float(tp["meta_tokens"].std()) < 0.025


# ---------------------------------------------------------------------------
# the Mamba heads, the block, the forward
# ---------------------------------------------------------------------------


def test_mamba_apply_full(setup):
    """Prefill mode from zero states: the output and the final conv window
    and SSM state."""
    jcfg, tcfg = setup[0], setup[1]
    jm, tm = _mamba(setup)
    x = _x((2, 37, 64), 5)
    want, waux = jmamba.mamba_apply(jm, jcfg, jnp.asarray(x))
    got, aux = tmamba.mamba_apply(tm, tcfg, torch.tensor(x))
    close(got, want, **MAMBA_TOL)
    assert aux["ssm"].dtype == torch.float32 and aux["ssm"].shape == (2, 128, 8)
    assert aux["conv"].shape == (2, 3, 128)
    close(aux["conv"], waux["conv"], **MAMBA_TOL)
    close(aux["ssm"], waux["ssm"], **MAMBA_TOL)


def test_mamba_apply_per_step_states(setup):
    """Decode mode from carried-in states: per-step conv windows (B, k, W-1,
    di) and SSM states (B, k, di, N), as the reference stacks them."""
    jcfg, tcfg = setup[0], setup[1]
    jm, tm = _mamba(setup, 1)
    x = _x((3, K, 64), 6)
    conv, h0 = _x((3, 3, 128), 7), _x((3, 128, 8), 8, scale=0.3)
    want, waux = jmamba.mamba_apply(jm, jcfg, jnp.asarray(x),
                                    conv_state=jnp.asarray(conv),
                                    h0=jnp.asarray(h0), return_states=True)
    got, aux = tmamba.mamba_apply(tm, tcfg, torch.tensor(x),
                                  conv_state=torch.tensor(conv),
                                  h0=torch.tensor(h0), return_states=True)
    assert aux["conv"].shape == (3, K, 3, 128)
    assert aux["ssm"].shape == (3, K, 128, 8)
    close(got, want, **MAMBA_TOL)
    close(aux["conv"], waux["conv"], **MAMBA_TOL)
    close(aux["ssm"], waux["ssm"], **MAMBA_TOL)
    # the last step's states are what the prefill mode ends with
    full, faux = tmamba.mamba_apply(tm, tcfg, torch.tensor(x),
                                    conv_state=torch.tensor(conv),
                                    h0=torch.tensor(h0))
    close(full, got.detach().numpy(), rtol=0, atol=0)
    close(faux["conv"], aux["conv"][:, -1].numpy(), rtol=0, atol=0)
    close(faux["ssm"], aux["ssm"][:, -1].numpy(), rtol=0, atol=0)


def test_prefill_state_past_a_ragged_chunk(setup):
    """Past 128 steps the reference scans its prefill in chunks of 128 and
    pads the last one with zeros after the exponential, so dA = 0 there
    and its final SSM state is zero whenever S % 128 != 0 (hymba-1.5b's
    128 meta tokens + a 64-token prompt: S 192).  The port's final state
    is the recurrence's: the reference's own per-step scan (no chunks)
    ends on it, and its output y, which the padding does not reach,
    agrees."""
    jcfg, tcfg = setup[0], setup[1]
    jm, tm = _mamba(setup, 1)
    x = _x((2, 150, 64), 9)
    want, waux = jmamba.mamba_apply(jm, jcfg, jnp.asarray(x))
    _, steps = jmamba.mamba_apply(jm, jcfg, jnp.asarray(x), return_states=True)
    got, aux = tmamba.mamba_apply(tm, tcfg, torch.tensor(x))
    close(got, want, **MAMBA_TOL)
    close(aux["ssm"], steps["ssm"][:, -1], **MAMBA_TOL)
    close(aux["conv"], waux["conv"], **MAMBA_TOL)
    assert float(aux["ssm"].abs().max()) > 1e-3
    assert float(jnp.abs(waux["ssm"]).max()) == 0.0


def _prefilled_layer(setup, layer, b=4, s=7):
    """block_full with a cache in both packages, from the same input."""
    jcfg, tcfg, jp, tp, _ = setup
    x = _x((b, s, 64), 11 + layer)
    jc = jblocks.block_cache_init(jcfg, layer, b, 32, K, jnp.float32)
    tc = tblocks.block_cache_init(tcfg, layer, b, 32, K, torch.float32)
    jy, _, jc = jblocks.block_full(jp["blocks"][layer], jcfg, layer,
                                   jnp.asarray(x), cache=jc)
    ty, tc = tblocks.block_full(tp["blocks"][layer], tcfg, layer,
                                torch.tensor(x), cache=tc)
    return jy, ty, jc, tc


@pytest.mark.parametrize("layer", [0, 1])
def test_block_full_fills_both_caches(setup, layer):
    jy, ty, jc, tc = _prefilled_layer(setup, layer)
    close(ty, jy)
    assert set(tc) == set(jc) == {"attn", "mamba"}
    assert tc["mamba"]["h"].dtype == torch.float32
    for name in ("conv", "h"):
        close(tc["mamba"][name], jc["mamba"][name])
    for name in ("k", "v", "pos"):
        close(tc["attn"][name], jc["attn"][name])


@pytest.mark.parametrize("layer", [0, 1])
def test_block_cached_stages_and_commit_picks(setup, layer):
    """block_cached stages per-step conv windows and SSM states beside the
    old entries; commit_cache with per-row k̂ [0, 1, 2, k] picks step k̂-1,
    or the old entry for k̂ = 0, as the reference's ``pick``."""
    jcfg, tcfg, jp, tp, _ = setup
    _, _, jc, tc = _prefilled_layer(setup, layer)
    x = _x((4, K, 64), 20)
    ln = np.full((4,), 7, np.int32)
    jy, jst = jblocks.block_cached(jp["blocks"][layer], jcfg, layer,
                                   jnp.asarray(x), jc, jnp.asarray(ln))
    ty, tst = tblocks.block_cached(tp["blocks"][layer], tcfg, layer,
                                   torch.tensor(x), tc, torch.tensor(ln))
    close(ty, jy)
    assert set(tst["mamba"]) == set(jst["mamba"])
    for name, want in jst["mamba"].items():
        close(tst["mamba"][name], want)
    khat = np.asarray([0, 1, 2, K], np.int32)
    jcom = jblocks.commit_cache(jcfg, jst, jnp.asarray(khat))
    tcom = tblocks.commit_cache(tcfg, tst, torch.tensor(khat))
    assert set(tcom["mamba"]) == {"conv", "h"}
    for name, want in jcom["mamba"].items():
        close(tcom["mamba"][name], want)
        assert tcom["mamba"][name].dtype == tc["mamba"][name].dtype
    assert torch.equal(tcom["mamba"]["h"][0], tc["mamba"]["h"][0])
    assert torch.equal(tcom["mamba"]["h"][1], tst["mamba"]["h_steps"][1, 0])
    assert torch.equal(tcom["mamba"]["conv"][3],
                       tst["mamba"]["conv_steps"][3, -1])


@pytest.mark.parametrize("model", ["tiny", "smoke"])
def test_forward_logits_match_reference(setup, model):
    """Meta tokens prepended, the whole stack, every head's logits at the
    text positions, past the window (S 44 over a window of 32)."""
    if model == "tiny":
        jcfg, tcfg, jp, tp, _ = setup
    else:
        jcfg = jconfig.get_config("hymba-1.5b", smoke=True).replace(
            dtype="float32")
        jp, tcfg, tp = _bridged(jcfg, 5)
    toks = np.random.default_rng(6).integers(0, jcfg.vocab_size,
                                             (2, 40)).astype(np.int32)
    jh = jmodel.embed_inputs(jp, jcfg, {"tokens": jnp.asarray(toks)})
    th = tmodel.embed_inputs(tp, tcfg, {"tokens": torch.tensor(toks)})
    assert th.shape == (2, 40 + jcfg.num_meta_tokens, jcfg.d_model)
    close(th, jh, rtol=0, atol=0)
    jhid, _, _ = jmodel.forward_hidden(jp, jcfg, jh)
    with torch.no_grad():
        thid, _ = tmodel.forward_hidden(tp, tcfg, th)
    m = jcfg.num_meta_tokens
    close(tmodel.all_head_logits(tp, tcfg, thid[:, m:]),
          jmodel.all_head_logits(jp, jcfg, jhid[:, m:]))


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def test_caches_per_backend(setup):
    """Both caches hold the attention and the Mamba part; the paged
    backend pages the global layer only; the windowed layer's ring holds
    the meta slots beside the window."""
    tcfg = setup[1]
    ctx = tcfg.num_meta_tokens + PROMPT + MAX_NEW
    dense = tmodel.init_caches(tcfg, B, ctx, K, device="cpu")
    paged = tmodel.init_caches(tcfg, B, ctx, K, device="cpu",
                               backend=tcache.PagedBackend(8))
    assert all(set(c) == {"attn", "mamba"} for c in dense + paged)
    assert tcache.is_paged(paged[0]) and not tcache.is_paged(paged[1])
    assert dense[1]["attn"]["k"].shape[1] == tcache.attn_buf_len(
        tcfg, 1, ctx, K) == 256 < ctx
    assert dense[0]["mamba"]["h"].dtype == torch.float32


def test_reset_rows_zeroes_mamba(setup):
    """Evicted rows get pos = -1 and zero Mamba states; the others keep
    theirs, as the reference's ``reset_rows``."""
    jcfg, tcfg = setup[0], setup[1]
    tc = tblocks.block_cache_init(tcfg, 1, 3, 32, K, torch.float32)
    jc = jblocks.block_cache_init(jcfg, 1, 3, 32, K, jnp.float32)
    for name in ("conv", "h"):
        v = _x(tuple(tc["mamba"][name].shape), 30)
        tc["mamba"][name].copy_(torch.tensor(v))
        jc["mamba"][name] = jnp.asarray(v)
    tc["attn"]["pos"].fill_(5)
    jc["attn"]["pos"] = jnp.full_like(jc["attn"]["pos"], 5)
    mask = np.asarray([False, True, False])
    jout = jcache.reset_rows(jc, jnp.asarray(mask))
    tout = tcache.reset_rows(tc, torch.tensor(mask))
    for name in ("conv", "h"):
        close(tout["mamba"][name], jout["mamba"][name], rtol=0, atol=0)
        assert float(tout["mamba"][name][1].abs().max()) == 0
    close(tout["attn"]["pos"], jout["attn"]["pos"], rtol=0, atol=0)


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
    kw = dict(max_new_tokens=MAX_NEW, block_k=K, **POLICY_KW, **kw)
    return JDecodeConfig(**kw), DecodeConfig(**kw)


def _batches(prompt):
    return {"tokens": jnp.asarray(prompt)}, {"tokens": torch.tensor(prompt)}


@pytest.fixture(scope="module")
def greedy(setup):
    """Greedy in both packages on the dense cache; the port's rows are what
    the lossless policies emit."""
    jcfg, tcfg, jp, tp, prompt = setup
    jdec, tdec = _decs()
    jb, tb = _batches(prompt)
    return (jdecode.greedy_decode(jp, jcfg, jdec, jb),
            tdecode.greedy_decode(tp, tcfg, tdec, tb))


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_greedy_decode_matches_reference(setup, greedy, backend):
    _check_same(*greedy)
    if backend == "paged":
        jcfg, tcfg, jp, tp, prompt = setup
        jdec, tdec = _decs(cache_backend="paged", page_size=8)
        jb, tb = _batches(prompt)
        tres = tdecode.greedy_decode(tp, tcfg, tdec, tb)
        _check_same(jdecode.greedy_decode(jp, jcfg, jdec, jb), tres)
        assert _rows(*tres) == _rows(*greedy[1])


@pytest.mark.parametrize("backend", ["dense", "paged"])
@pytest.mark.parametrize("policy", ["exact", "topk", "distance", "adaptive"])
def test_bpd_decode_policy_matches_reference(setup, greedy, policy, backend):
    jcfg, tcfg, jp, tp, prompt = setup
    jdec, tdec = _decs(policy=policy, cache_backend=backend, page_size=8)
    jb, tb = _batches(prompt)
    tres = tdecode.bpd_decode(tp, tcfg, tdec, tb)
    _check_same(jdecode.bpd_decode(jp, jcfg, jdec, jb), tres)
    if policy in ("exact", "adaptive"):              # exact acceptance
        assert _rows(*tres) == _rows(*greedy[1])


def test_decode_session_matches_bpd_decode(setup):
    """DecodeSession's decode and greedy are the run-to-completion paths."""
    jcfg, tcfg, jp, tp, prompt = setup
    _, tdec = _decs(policy="adaptive")
    tb = _batches(prompt)[1]
    sess = tserving.DecodeSession(tp, tcfg, tdec)
    want = tdecode.bpd_decode(tp, tcfg, tdec, tb)
    got = sess.decode(tb)
    assert _rows(*got) == _rows(*want)
    assert got[1]["iterations"] == want[1]["iterations"]
    g = sess.greedy(tb)
    assert _rows(*g) == _rows(*tdecode.greedy_decode(tp, tcfg, tdec, tb))


@pytest.mark.parametrize("corrupt", [None, 2])
def test_iteration_with_handmade_proposals(setup, greedy, corrupt):
    """From the prefill state, propose greedy's own continuation (k̂ = k),
    or corrupt slot j of it (k̂ = j), then run a second iteration on the
    committed state: both packages agree on tokens, proposals and the
    Mamba caches, and the tokens stay greedy's."""
    jcfg, tcfg, jp, tp, prompt = setup
    jdec, tdec = _decs()
    g_rows = _rows(*greedy[1])
    g = np.asarray([r[PROMPT:PROMPT + K] for r in g_rows], np.int32)
    props = g.copy()
    if corrupt is not None:
        props[:, corrupt] = (props[:, corrupt] + 1) % jcfg.vocab_size
    jb, tb = _batches(prompt)
    js, jpre = jdecode.bpd_prefill_causal_lm(jp, jcfg, jdec, jb,
                                             max_new=MAX_NEW)
    ts, tpre = tdecode.bpd_prefill_causal_lm(tp, tcfg, tdec, tb,
                                             max_new=MAX_NEW)
    assert tpre == jpre == jcfg.num_meta_tokens
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
        for tc, jc in zip(ts.caches, js.caches):
            assert set(tc["mamba"]) == set(jc["mamba"]) == {"conv", "h"}
            for name, want in jc["mamba"].items():
                close(tc["mamba"][name], want, rtol=1e-4, atol=1e-4)
        n = ts.text_len.tolist()
        assert [r[:n[i]] for i, r in enumerate(ts.tokens.tolist())] == \
            [r[:n[i]] for i, r in enumerate(g_rows)]


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def test_topk_tree_raises_the_reference_error(setup):
    jcfg, tcfg, jp, tp, prompt = setup
    jdec, tdec = _decs(policy="topk_tree")
    jb, tb = _batches(prompt[:, :8])
    with pytest.raises(NotImplementedError) as jerr:
        jdecode.bpd_decode(jp, jcfg, jdec, jb)
    with pytest.raises(NotImplementedError) as terr:
        tdecode.bpd_decode(tp, tcfg, tdec, tb)
    assert str(terr.value) == str(jerr.value)
    assert "pure attention blocks" in str(terr.value)


def test_engine_refuses_hymba(setup):
    """The engine's padded admission prefill is unsound for the Mamba
    state: both packages refuse at construction."""
    jcfg, tcfg, jp, tp, _ = setup
    with pytest.raises(NotImplementedError) as jerr:
        jengine.ContinuousBatchingEngine(jp, jcfg, JDecodeConfig(),
                                         JEngineConfig())
    with pytest.raises(NotImplementedError) as terr:
        tserving.ContinuousBatchingEngine(tp, tcfg, DecodeConfig(),
                                          tserving.EngineConfig())
    assert "block_type='attn'" in str(terr.value)
    assert "'hymba'" in str(jerr.value) and "'hymba'" in str(terr.value)


def test_draft_model_refuses_a_meta_token_primary(setup):
    """The reference fails with a broadcast error inside its decode (the
    meta prefix offsets the primary's positions from the draft's); the
    port refuses at the session, before any work, naming the prefix."""
    jcfg, tcfg, jp, tp, prompt = setup
    dcfg = ModelConfig(**dataclasses.asdict(tiny_dense(bpd_enabled=False)))
    dparams = tmodel.init(dcfg, seed=7, device="cpu")
    _, tdec = _decs(policy="draft_model")
    with pytest.raises(NotImplementedError, match="meta tokens.*meta prefix"):
        tserving.DecodeSession(tp, tcfg, tdec,
                               bundles={"draft": ModelBundle(dparams, dcfg)})
    with pytest.raises(NotImplementedError, match="meta tokens"):
        tdecode.bpd_decode(tp, tcfg, tdec, _batches(prompt[:, :8])[1],
                           bundles={"draft": ModelBundle(dparams, dcfg)})


# ---------------------------------------------------------------------------
# the bf16 cast
# ---------------------------------------------------------------------------


def test_bf16_cast_keeps_fp32_read_leaves(setup):
    """A_log and D (read ``.astype(f32)`` by the reference) and every norm
    scale stay fp32; the rest, the meta tokens and betas included, go to
    bf16."""
    jcfg, tcfg, jp, _, _ = setup
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tp = bridge.from_jax_params(tree, tcfg, device="cpu")
    tmodel.cast_for_compute(tp, tcfg.replace(dtype="bfloat16"))
    kept = sorted(k for k, v in tp.state_dict().items()
                  if v.dtype == torch.float32)
    assert "blocks.0.mamba.A_log" in kept and "blocks.1.mamba.D" in kept
    assert "blocks.1.fuse_ln_attn.scale" in kept
    assert all(k.endswith((".scale", ".A_log", ".D")) for k in kept), kept
    sd = tp.state_dict()
    for key in ("meta_tokens", "blocks.0.beta_ssm", "blocks.0.mamba.conv_w",
                "blocks.0.mamba.dt_proj.b"):
        assert sd[key].dtype == torch.bfloat16, key
    np.testing.assert_array_equal(sd["blocks.0.mamba.A_log"].numpy(),
                                  tree["blocks"][0]["mamba"]["A_log"])


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("frozen", [False, True])
def test_make_train_step_matches_reference(frozen):
    """tiny_hymba, B 3 x S 24 (4 meta positions first, a window of 16
    crossed): loss and every gradient (the Mamba leaves through the scan)
    equal the reference's jitted step, and every updated leaf and AdamW's
    state equal the reference's ``optimizer_update`` applied to the port's
    gradients, fine-tuned and with a frozen base.  (AdamW's first step
    divides a gradient by its own magnitude plus eps, so at an element
    whose gradient is a few 1e-5 of the leaf's largest the fp32 noise of
    the gradient grows to 1e-4 of the update: the step is held in its two
    parts, each to its tolerance, as phase 11a holds the card to the
    CPU.)"""
    jcfg = tiny_hymba(sliding_window=16)
    jp = jmodel.init(jax.random.PRNGKey(0), jcfg)
    jtc = jconfig.TrainConfig(lr=1e-3, warmup_steps=1, freeze_base=frozen)
    batch = lm_batch(jcfg, b=3, s=24)
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
        assert float(grads["blocks/1/mamba/A_log"].abs().max()) > 0
        assert float(grads["meta_tokens"].abs().max()) > 0
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


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_serve_hymba_on_cpu(capsys, backend):
    """The static serve of hymba-1.5b's smoke config on the CPU: BPD
    exact emits greedy's tokens on either cache."""
    from repro_torch.launch import serve

    out = serve.main(["--arch", "hymba-1.5b", "--device", "cpu", "--batch",
                      "2", "--prompt-len", "40", "--max-new", "6",
                      "--cache-backend", backend])
    assert "hymba-1.5b" in capsys.readouterr().out
    gt, gs = tdecode.greedy_decode(out["params"], out["cfg"], out["dec"],
                                   out["batch"])
    assert _rows(out["tokens"].numpy(), out["stats"]) == _rows(gt.numpy(), gs)


@pytest.mark.parametrize("flags,match", [
    (["--policy", "topk_tree"], "pure attention blocks"),
    (["--engine"], "block_type='attn'"),
])
def test_serve_hymba_refusals(flags, match):
    from repro_torch.launch import serve

    with pytest.raises(NotImplementedError, match=match):
        serve.main(["--arch", "hymba-1.5b", "--device", "cpu", "--batch",
                    "1", "--prompt-len", "4", "--max-new", "2", *flags])


def test_train_launcher_hymba_on_cpu(capsys):
    from repro_torch.launch import train

    out = train.main(["--arch", "hymba-1.5b", "--device", "cpu", "--steps",
                      "4", "--batch", "2", "--seq", "24", "--log-every", "2"])
    assert out["cfg"].name == "hymba-1.5b"
    assert "loss" in capsys.readouterr().out
    assert np.isfinite(float(out["metrics"]["loss"]))

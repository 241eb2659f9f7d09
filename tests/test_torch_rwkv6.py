"""The port's RWKV-6 family against the JAX reference, on the CPU
(``conftest.tiny_rwkv``: d 64, head_dim 32, 2 layers; weights made by
``repro.models.model.init`` and carried across by ``bridge``): the wkv scan's
plain version against the reference oracle and the interpreted Pallas
kernel, the group norm, the time and channel mix, the block's cache paths
and commit, decode under every chain policy, hand-made iterations, the
tree refusal, the serve launcher, and the bf16 cast that keeps the
fp32-read leaves in fp32."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_rwkv  # noqa: E402
from repro import config as jconfig  # noqa: E402
from repro.config import DecodeConfig as JDecodeConfig  # noqa: E402
from repro.core import decode as jdecode  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro_torch import bridge, config as tconfig  # noqa: E402
from repro_torch.config import DecodeConfig, ModelConfig  # noqa: E402
from repro_torch.core import decode as tdecode  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import cache as tcache  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import rwkv6 as trwkv  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=2e-5, atol=2e-5)
B, PROMPT, MAX_NEW, K = 3, 6, 12, 4
POLICY_KW = dict(top_k=2, epsilon=2.0)


def _x(shape, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               **(tol or TOL))


def _randomize(tree, seed):
    """The reference's init leaves zeros / ones / constants in the mixing
    anchors, w0 and the norms; draw every such leaf (numpy, seeded) so the
    comparison sees each one."""
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(np.asarray, tree)
    for blk in tree["blocks"]:
        tm, cm = blk["tm"], blk["cm"]
        for name in ("mu_x", "mu"):
            tm[name] = rng.uniform(0, 1, tm[name].shape).astype(np.float32)
        for name in ("mu_k", "mu_r"):
            cm[name] = rng.uniform(0, 1, cm[name].shape).astype(np.float32)
        # trained RWKV-6 decays spread over channels
        tm["w0"] = rng.uniform(-6, 0, tm["w0"].shape).astype(np.float32)
        for norm in (blk["ln1"], blk["ln2"], tm["ln_x"]):
            norm["scale"] = (1 + 0.1 * rng.standard_normal(
                norm["scale"].shape)).astype(np.float32)
        tm["ln_x"]["bias"] = (0.1 * rng.standard_normal(
            tm["ln_x"]["bias"].shape)).astype(np.float32)
    tree["final_norm"]["scale"] = (1 + 0.1 * rng.standard_normal(
        tree["final_norm"]["scale"].shape)).astype(np.float32)
    return tree


def _bridged(jcfg, seed):
    """(reference params as jnp, port params) from one randomized tree."""
    tree = _randomize(jmodel.init(jax.random.PRNGKey(seed), jcfg), seed)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    tp = bridge.from_jax_params(tree, tcfg, device="cpu")
    return jax.tree_util.tree_map(jnp.asarray, tree), tcfg, tp


@pytest.fixture(scope="module")
def setup():
    jcfg = tiny_rwkv()
    jp, tcfg, tp = _bridged(jcfg, 3)
    prompt = np.random.default_rng(4).integers(0, jcfg.vocab_size,
                                               (B, PROMPT)).astype(np.int32)
    return jcfg, tcfg, jp, tp, prompt


def _tm(setup, layer=0):
    jcfg, tcfg, jp, tp, _ = setup
    return jp["blocks"][layer]["tm"], tp["blocks"][layer]["tm"]


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True])
def test_registered_rwkv6_matches_reference(smoke):
    want = jconfig.get_config("rwkv6-1.6b", smoke=smoke)
    got = tconfig.get_config("rwkv6-1.6b", smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.padded_vocab_size == want.padded_vocab_size


def test_validate_checks_the_rwkv_head_dim():
    with pytest.raises(ValueError, match="rwkv_head_dim"):
        ModelConfig(block_type="rwkv6", mlp_type="rwkv_channel_mix",
                    d_model=96, rwkv_head_dim=64).validate()


# ---------------------------------------------------------------------------
# the wkv scan: plain version vs the reference oracle and Pallas kernel
# ---------------------------------------------------------------------------


SCAN_TOL = {"float32": dict(rtol=2e-4, atol=2e-4),     # test_kernels.py:167
            "bfloat16": dict(rtol=3e-2, atol=3e-2)}


def _scan_inputs(b, s, h, d, seed, *, strong=False):
    r, k, v = (_x((b, s, h, d), seed + i) for i in range(3))
    if strong:
        logw = np.full((b, s, h, d), -8.0, np.float32)  # w = e^-8
    else:
        logw = -np.exp(_x((b, s, h, d), seed + 3) * 0.5 - 1.0)
    u = _x((h, d), seed + 4) * 0.1
    return r, k, v, logw.astype(np.float32), u


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,d,chunk,strong", [
    (1, 16, 1, 16, 16, False),
    (2, 37, 3, 16, 16, False),      # ragged: S % chunk != 0
    (1, 128, 2, 64, 16, False),     # production head_dim
    (2, 64, 2, 32, 32, False),      # larger chunk
    (1, 48, 1, 16, 16, True),       # strong decay (test_kernels.py:173)
])
def test_rwkv6_scan_plain_matches_reference(b, s, h, d, chunk, strong, dtype):
    """The plain version against the reference's sequential oracle (1e-5)
    and its Pallas kernel in interpret mode (the JAX test's tolerance)."""
    r, k, v, logw, u = _scan_inputs(b, s, h, d, 10 * s + d, strong=strong)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jin = [jnp.asarray(t, jdt) for t in (r, k, v)] + [jnp.asarray(logw),
                                                     jnp.asarray(u)]
    tin = [torch.from_numpy(t).to(tdt) for t in (r, k, v)] + [
        torch.from_numpy(logw), torch.from_numpy(u)]
    y, state = ops.rwkv6_scan(*tin, chunk=chunk)
    assert y.dtype == state.dtype == torch.float32
    assert y.shape == (b, s, h, d) and state.shape == (b, h, d, d)
    wy, ws = jref.rwkv6_scan(*jin)
    close(y, wy, rtol=1e-5, atol=1e-5)
    close(state, ws, rtol=1e-5, atol=1e-5)
    py, ps = jops.rwkv6_scan(*jin, chunk=chunk, interpret=True)
    close(y, py, **SCAN_TOL[dtype])
    close(state, ps, **SCAN_TOL[dtype])
    assert torch.isfinite(y).all() and torch.isfinite(state).all()


def test_group_norm_apply():
    x = _x((2, 5, 64), 1)
    p = {"scale": _x((64,), 2), "bias": _x((64,), 3)}
    want = jlayers.group_norm_apply({n: jnp.asarray(a) for n, a in p.items()},
                                    jnp.asarray(x), 2)
    got = tlayers.group_norm_apply({n: torch.tensor(a) for n, a in p.items()},
                                   torch.tensor(x), 2)
    close(got, want)
    # the population variance, eps 1e-5: a constant group maps to the bias
    flat = np.ones((1, 1, 64), np.float32)
    got = tlayers.group_norm_apply({n: torch.tensor(a) for n, a in p.items()},
                                   torch.tensor(flat), 2)
    close(got[0, 0], p["bias"])


# ---------------------------------------------------------------------------
# time mix, channel mix, the block
# ---------------------------------------------------------------------------


def test_rwkv_tm_apply_full(setup):
    jcfg, tcfg = setup[0], setup[1]
    jtm, ttm = _tm(setup)
    x = _x((2, 9, 64), 5)
    want, waux = jrwkv.rwkv_tm_apply(jtm, jcfg, jnp.asarray(x))
    got, aux = trwkv.rwkv_tm_apply(ttm, tcfg, torch.tensor(x))
    close(got, want)
    close(aux["x_last"], waux["x_last"])
    close(aux["state"], waux["state"])


def test_rwkv_tm_apply_cached_per_step_states(setup):
    jcfg, tcfg = setup[0], setup[1]
    jtm, ttm = _tm(setup, 1)
    x, xp = _x((2, K, 64), 6), _x((2, 64), 7)
    s0 = _x((2, 2, 32, 32), 8, scale=0.3)
    want, waux = jrwkv.rwkv_tm_apply(jtm, jcfg, jnp.asarray(x),
                                     x_prev=jnp.asarray(xp),
                                     state0=jnp.asarray(s0),
                                     return_states=True)
    got, aux = trwkv.rwkv_tm_apply(ttm, tcfg, torch.tensor(x),
                                   x_prev=torch.tensor(xp),
                                   state0=torch.tensor(s0),
                                   return_states=True)
    assert aux["state"].shape == (2, K, 2, 32, 32)
    close(got, want)
    close(aux["state"], waux["state"])


def test_prefill_scan_refuses_a_carried_state(setup):
    tcfg = setup[1]
    _, ttm = _tm(setup)
    with pytest.raises(ValueError, match="zero state"):
        trwkv.rwkv_tm_apply(ttm, tcfg, torch.zeros((1, 3, 64)),
                            state0=torch.zeros((1, 2, 32, 32)))


def test_rwkv_cm_apply(setup):
    jcfg, tcfg, jp, tp, _ = setup
    x, xp = _x((2, 7, 64), 9), _x((2, 64), 10)
    jcm, tcm = jp["blocks"][0]["cm"], tp["blocks"][0]["cm"]
    want, waux = jrwkv.rwkv_cm_apply(jcm, jcfg, jnp.asarray(x),
                                     x_prev=jnp.asarray(xp))
    got, aux = trwkv.rwkv_cm_apply(tcm, tcfg, torch.tensor(x),
                                   x_prev=torch.tensor(xp))
    close(got, want)
    close(aux["x_last"], waux["x_last"])


def _prefilled_layer(setup, layer, b=4, s=7):
    """block_full with a cache in both packages, from the same input."""
    jcfg, tcfg, jp, tp, _ = setup
    from repro.models import cache as jcache

    x = _x((b, s, 64), 11 + layer)
    jc = {"tm": jcache.rwkv_cache_init(b, 64, 2, 32, jnp.float32)}
    tc = tblocks.block_cache_init(tcfg, layer, b, 32, K, torch.float32)
    jy, _, jc = jblocks.block_full(jp["blocks"][layer], jcfg, layer,
                                   jnp.asarray(x), cache=jc)
    ty, tc = tblocks.block_full(tp["blocks"][layer], tcfg, layer,
                                torch.tensor(x), cache=tc)
    return jy, ty, jc, tc


def test_block_full_fills_the_recurrent_cache(setup):
    jy, ty, jc, tc = _prefilled_layer(setup, 0)
    close(ty, jy)
    assert set(tc["tm"]) == set(jc["tm"]) == {"shift_tm", "shift_cm", "state"}
    assert tc["tm"]["state"].dtype == torch.float32
    for name in ("shift_tm", "shift_cm", "state"):
        close(tc["tm"][name], jc["tm"][name])


def test_block_cached_stages_and_commit_picks(setup):
    """block_cached stages per-step shifts (the normed inputs) and states;
    commit_cache with per-row k̂ [0, 1, 2, 4] picks step k̂-1, or the old
    entry for k̂ = 0, as the reference's ``pick``."""
    jcfg, tcfg, jp, tp, _ = setup
    layer = 1
    _, _, jc, tc = _prefilled_layer(setup, layer)
    x = _x((4, K, 64), 20)
    jy, jst = jblocks.block_cached(jp["blocks"][layer], jcfg, layer,
                                   jnp.asarray(x), jc, jnp.full((4,), 7))
    ty, tst = tblocks.block_cached(tp["blocks"][layer], tcfg, layer,
                                   torch.tensor(x), tc, torch.full((4,), 7))
    close(ty, jy)
    assert set(tst["tm"]) == set(jst["tm"])
    for name, want in jst["tm"].items():
        close(tst["tm"][name], want)
    khat = np.asarray([0, 1, 2, 4], np.int32)
    jcom = jblocks.commit_cache(jcfg, jst, jnp.asarray(khat))
    tcom = tblocks.commit_cache(tcfg, tst, torch.tensor(khat))
    assert set(tcom["tm"]) == {"shift_tm", "shift_cm", "state"}
    for name, want in jcom["tm"].items():
        close(tcom["tm"][name], want)
        assert tcom["tm"][name].dtype == tc["tm"][name].dtype
    # row 0 (k̂ = 0) keeps its old state; row 3 takes the last step's
    assert torch.equal(tcom["tm"]["state"][0], tc["tm"]["state"][0])
    assert torch.equal(tcom["tm"]["state"][3], tst["tm"]["state_steps"][3, -1])


def test_state_dict_keys_are_reference_paths(setup):
    jcfg, tcfg, jp, tp, _ = setup
    paths = {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
             tuple(np.shape(leaf))
             for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert {k: tuple(v.shape) for k, v in tp.state_dict().items()} == paths
    assert "blocks.1.tm.ln_x.scale" in paths and "blocks.0.tm.mix_B" in paths
    assert "lm_head.w" in paths                         # untied
    meta = tmodel.init(tcfg, device="meta")
    assert {k: tuple(v.shape) for k, v in meta.state_dict().items()} == paths


def test_bridge_checkpoint_round_trip(setup, tmp_path):
    """The reference's checkpoint of an rwkv6 tree (nested tm.ln_x, mu
    (5, d), mix_B (5, 32, d)) loads into the bridged parameters."""
    from repro.checkpoint import save

    jcfg, tcfg, jp, tp, _ = setup
    save(str(tmp_path), 3, jp, extra={"arch": "tiny-rwkv"})
    loaded = bridge.load_checkpoint(str(tmp_path), tcfg, device="cpu")
    want = tp.state_dict()
    got = loaded.state_dict()
    assert list(got) == list(want)
    assert got["blocks.0.tm.mix_B"].shape == (5, 32, 64)
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_untied_vocab_projection(setup):
    """rwkv6 reads the untied row-major lm_head: project_vocab and the
    fused-heads matrix are the reference's."""
    jcfg, tcfg, jp, tp, _ = setup
    h = _x((3, 64), 12)
    close(tmodel.project_vocab(tp, tcfg, torch.tensor(h)),
          jmodel.project_vocab(jp, jcfg, jnp.asarray(h)))
    w = tmodel.vocab_matrix(tp, tcfg)
    assert w.data_ptr() == tp["lm_head"]["w"].data_ptr() and w.is_contiguous()
    want = np.asarray(jnp.argmax(jmodel.all_head_logits(jp, jcfg,
                                                        jnp.asarray(h)), -1))
    got = tmodel.head_topk(tp, tcfg, torch.tensor(h), jcfg.bpd_k - 1)
    np.testing.assert_array_equal(got[:, :, 0].numpy(), want[:, 1:])


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
    np.testing.assert_array_equal(ts["generated"].numpy(), np.asarray(js["generated"]))
    np.testing.assert_allclose(ts["mean_accepted"], float(js["mean_accepted"]),
                               rtol=1e-6)


def _decs(**kw):
    kw = dict(max_new_tokens=MAX_NEW, block_k=K, **POLICY_KW, **kw)
    return JDecodeConfig(**kw), DecodeConfig(**kw)


def _batches(prompt):
    return {"tokens": jnp.asarray(prompt)}, {"tokens": torch.tensor(prompt)}


@pytest.fixture(scope="module")
def greedy(setup):
    """Greedy in both packages; the port's rows are what lossless policies
    emit."""
    jcfg, tcfg, jp, tp, prompt = setup
    jdec, tdec = _decs()
    jb, tb = _batches(prompt)
    jres = jdecode.greedy_decode(jp, jcfg, jdec, jb)
    tres = tdecode.greedy_decode(tp, tcfg, tdec, tb)
    return jres, tres


def test_greedy_decode_matches_reference(greedy):
    _check_same(*greedy)


@pytest.mark.parametrize("policy", ["exact", "topk", "distance", "adaptive"])
def test_bpd_decode_policy_matches_reference(setup, greedy, policy):
    jcfg, tcfg, jp, tp, prompt = setup
    jdec, tdec = _decs(policy=policy)
    jb, tb = _batches(prompt)
    tres = tdecode.bpd_decode(tp, tcfg, tdec, tb)
    _check_same(jdecode.bpd_decode(jp, jcfg, jdec, jb), tres)
    if policy in ("exact", "adaptive"):              # exact acceptance
        assert _rows(*tres) == _rows(*greedy[1])


def test_paged_backend_leaves_recurrent_caches_alone(setup, greedy):
    """--cache-backend paged is a no-op for rwkv6, as in the reference."""
    jcfg, tcfg, jp, tp, prompt = setup
    _, tdec = _decs(cache_backend="paged", page_size=8)
    caches = tmodel.init_caches(tcfg, B, 32, K, device="cpu",
                                backend=tcache.get_backend(tdec))
    assert all(set(c) == {"tm"} for c in caches)
    tres = tdecode.bpd_decode(tp, tcfg, tdec, _batches(prompt)[1])
    assert _rows(*tres) == _rows(*greedy[1])


# ---------------------------------------------------------------------------
# hand-made iterations: multi-token accepts roll the recurrent state back
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("corrupt", [None, 1, 2, 3])
def test_iteration_with_handmade_proposals(setup, greedy, corrupt):
    """From the prefill state, propose greedy's own continuation (k̂ = k),
    or corrupt slot j of it (k̂ = j), then run a second iteration on the
    committed state: both packages agree on tokens, proposals and every
    recurrent cache entry, and the tokens stay greedy's."""
    jcfg, tcfg, jp, tp, prompt = setup
    jdec, tdec = _decs()
    g_rows = _rows(*greedy[1])
    g = np.asarray([r[PROMPT:PROMPT + K] for r in g_rows], np.int32)
    props = g.copy()
    if corrupt is not None:
        props[:, corrupt] = (props[:, corrupt] + 1) % jcfg.vocab_size
    jb, tb = _batches(prompt)
    js, _ = jdecode.bpd_prefill_causal_lm(jp, jcfg, jdec, jb, max_new=MAX_NEW)
    ts, _ = tdecode.bpd_prefill_causal_lm(tp, tcfg, tdec, tb, max_new=MAX_NEW)
    np.testing.assert_array_equal(ts.proposals.numpy(), np.asarray(js.proposals))
    js = js._replace(proposals=jnp.asarray(props))
    ts = ts._replace(proposals=torch.tensor(props))
    for it in range(2):
        js = jdecode.bpd_iteration(jp, jcfg, jdec,
                                   jdecode.causal_lm_backend(jcfg), js,
                                   prefix_offset=0, max_new=MAX_NEW)
        ts = tdecode.bpd_iteration(tp, tcfg, tdec,
                                   tdecode.causal_lm_backend(tcfg), ts,
                                   prefix_offset=0, max_new=MAX_NEW)
        if it == 0:
            khat = K if corrupt is None else corrupt
            assert ts.text_len.tolist() == [PROMPT + khat] * B
        np.testing.assert_array_equal(ts.text_len.numpy(), np.asarray(js.text_len))
        np.testing.assert_array_equal(ts.tokens.numpy(), np.asarray(js.tokens))
        np.testing.assert_array_equal(ts.proposals.numpy(), np.asarray(js.proposals))
        for tc, jc in zip(ts.caches, js.caches):
            assert set(tc["tm"]) == set(jc["tm"])
            for name, want in jc["tm"].items():
                close(tc["tm"][name], want, rtol=1e-4, atol=1e-4)
        n = ts.text_len.tolist()
        assert [r[:n[i]] for i, r in enumerate(ts.tokens.tolist())] == \
            [r[:n[i]] for i, r in enumerate(g_rows)]


def test_topk_tree_raises_before_any_work(setup):
    """Tree verification on a recurrent family raises the reference's
    NotImplementedError, before the iteration embeds or runs anything."""
    jcfg, tcfg, jp, tp, prompt = setup
    jdec, tdec = _decs(policy="topk_tree")
    jb, tb = _batches(prompt)
    with pytest.raises(NotImplementedError) as jerr:
        jdecode.bpd_decode(jp, jcfg, jdec, jb)
    with pytest.raises(NotImplementedError) as terr:
        tdecode.bpd_decode(tp, tcfg, tdec, tb)
    assert str(terr.value) == str(jerr.value)
    assert "pure attention blocks" in str(terr.value)

    def untouchable(*args, **kw):
        raise AssertionError("bpd_iteration did work before refusing")

    state, _ = tdecode.bpd_prefill_causal_lm(tp, tcfg, tdec, tb,
                                             max_new=MAX_NEW)
    be = tdecode.causal_lm_backend(tcfg)._replace(
        embed_tokens=untouchable, decode_block=untouchable)
    with pytest.raises(NotImplementedError, match="pure attention blocks"):
        tdecode.bpd_iteration(tp, tcfg, tdec, be, state, prefix_offset=0,
                              max_new=MAX_NEW)


# ---------------------------------------------------------------------------
# the serve launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_serve_rwkv6_on_cpu(capsys, backend):
    from repro_torch.launch import serve

    out = serve.main(["--arch", "rwkv6-1.6b", "--device", "cpu", "--batch",
                      "2", "--prompt-len", "8", "--max-new", "6",
                      "--cache-backend", backend])
    assert "rwkv6-1.6b" in capsys.readouterr().out
    gt, gs = tdecode.greedy_decode(out["params"], out["cfg"], out["dec"],
                                   out["batch"])
    assert _rows(out["tokens"].numpy(), out["stats"]) == _rows(gt.numpy(), gs)


def test_serve_rwkv6_refuses_topk_tree():
    from repro_torch.launch import serve

    with pytest.raises(NotImplementedError, match="pure attention blocks"):
        serve.main(["--arch", "rwkv6-1.6b", "--device", "cpu", "--batch", "1",
                    "--prompt-len", "4", "--max-new", "2", "--policy",
                    "topk_tree"])


# ---------------------------------------------------------------------------
# the bf16 cast keeps the leaves the reference reads in fp32
# ---------------------------------------------------------------------------


def _bf16_bits_apart(got: torch.Tensor, want) -> np.ndarray:
    """|got - want| in bf16 ulps, elementwise (both bf16, finite)."""
    g = got.view(torch.int16).numpy().astype(np.int64)
    w = torch.from_numpy(np.array(jnp.asarray(want, jnp.float32))).to(
        torch.bfloat16).view(torch.int16).numpy().astype(np.int64)

    def ordered(bits):            # sign-magnitude -> monotone integers
        return np.where(bits < 0, -(bits & 0x7FFF), bits)

    return np.abs(ordered(g) - ordered(w))


NORM_MISMATCH_SHARE = 1e-3      # elements allowed 1 ulp apart (sum order)


@pytest.mark.parametrize("cast", ["cast_for_compute", "whole-tree .to"])
def test_bf16_cast_keeps_fp32_read_leaves(monkeypatch, cast):
    """Weights whose fp32-read leaves (norm scales around 1, trained-like
    w0, the random decay_A / decay_B / u) are not bf16-representable,
    served in bf16.  With ``cast_for_compute`` the port's decay w equals
    the reference's to fp32 tolerance, and its norms give the reference's
    bf16 values on all but NORM_MISMATCH_SHARE of the elements, none more
    than 1 ulp apart.  The whole-tree cast the port used before breaks
    both; that case checks the checks catch it."""
    jcfg = tiny_rwkv(dtype="bfloat16")
    jp, tcfg, tp = _bridged(jcfg, 5)
    if cast == "cast_for_compute":
        tp = tmodel.cast_for_compute(tp, tcfg)
        for key, p in tp.state_dict().items():
            assert p.dtype == (torch.float32 if tmodel.reads_fp32(key)
                               else torch.bfloat16), key
        assert tmodel.reads_fp32("blocks.0.tm.ln_x.bias")
        assert tmodel.reads_fp32("blocks.1.tm.decay_B")
        assert not tmodel.reads_fp32("blocks.0.tm.wk")
    else:
        tp = tp.to(torch.bfloat16)
    jtm, ttm = jp["blocks"][0]["tm"], tp["blocks"][0]["tm"]

    # decay: the reference's own lines from a bf16 x_w, captured at its scan
    xw = _x((2, 9, 64), 30)
    xw_j = jnp.asarray(xw, jnp.bfloat16)
    seen = {}

    def fake_ddlerp(p, x, x_prev):
        return (xw_j,) * 5

    def capture(r, k, v, w, u, state0, *, return_states=False):
        seen["w"] = w
        b, s, h, d = r.shape
        return (jnp.zeros((b, s, h, d), jnp.float32),
                jnp.zeros((b, 1, h, d, d), jnp.float32))

    monkeypatch.setattr(jrwkv, "_ddlerp", fake_ddlerp)
    monkeypatch.setattr(jrwkv, "_wkv_scan", capture)
    jrwkv.rwkv_tm_apply(jtm, jcfg, xw_j)
    want_w = np.asarray(seen["w"])
    got_w = torch.exp(trwkv._log_decay(ttm, torch.from_numpy(xw).to(
        torch.bfloat16))).reshape(want_w.shape)
    assert got_w.dtype == torch.float32
    w_err = float(np.max(np.abs(got_w.numpy() - want_w) / want_w))

    # norms: RMSNorm (ln1, ln2, final_norm) and the group norm (ln_x)
    x = torch.from_numpy(_x((8, 32, 64), 31)).to(torch.bfloat16)
    xj = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    apart = []
    for tn, jn in ((tp["blocks"][0]["ln1"], jp["blocks"][0]["ln1"]),
                   (tp["blocks"][1]["ln2"], jp["blocks"][1]["ln2"]),
                   (tp["final_norm"], jp["final_norm"])):
        apart.append(_bf16_bits_apart(tlayers.norm_apply(tn, x),
                                      jlayers.norm_apply(jn, xj)))
    apart.append(_bf16_bits_apart(
        tlayers.group_norm_apply(ttm["ln_x"], x, 2),
        jlayers.group_norm_apply(jtm["ln_x"], xj, 2)))
    apart = np.concatenate([a.ravel() for a in apart])
    share = float(np.mean(apart > 0))

    print(f"{cast}: max relative error of w {w_err:.3g}, norm elements "
          f"apart {share:.4g} (max {apart.max()} ulp)")
    if cast == "cast_for_compute":
        assert w_err <= 1e-5, w_err
        assert apart.max() <= 1 and share <= NORM_MISMATCH_SHARE, (apart.max(), share)
    else:
        assert w_err > 1e-4, w_err
        assert share > 10 * NORM_MISMATCH_SHARE, share

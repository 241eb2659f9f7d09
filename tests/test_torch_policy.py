"""The port's decode policies against the JAX reference, in fp32 on the CPU
(``conftest.tiny_dense``, weights carried across by ``bridge``): the
acceptors and the adaptive schedule (twins of tests/test_verify.py and
tests/test_policy.py), ``bpd_decode`` under every ported policy on the dense
and paged caches, paged ``greedy_decode``, hand-made tree iterations, and
the serve launcher."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_dense  # noqa: E402
from repro.config import DecodeConfig as JDecodeConfig  # noqa: E402
from repro.core import decode as jdecode  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import DecodeConfig, ModelConfig  # noqa: E402
from repro_torch.core import decode as tdecode  # noqa: E402
from repro_torch.core import policy as P  # noqa: E402

torch.set_num_threads(2)
I32 = torch.int32
B, PROMPT, MAX_NEW, K = 3, 6, 12, 4
POLICY_KW = dict(top_k=2, epsilon=2.0)


@pytest.fixture(scope="module")
def setup():
    jcfg = tiny_dense()
    jp = jmodel.init(jax.random.PRNGKey(3), jcfg)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    tp = bridge.from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                                device="cpu")
    prompt = np.random.default_rng(4).integers(0, jcfg.vocab_size,
                                               (B, PROMPT)).astype(np.int32)
    return jcfg, tcfg, jp, tp, prompt


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
    """The port's greedy rows (dense cache): what lossless policies emit."""
    _, tcfg, _, tp, prompt = setup
    _, tdec = _decs()
    return _rows(*tdecode.greedy_decode(tp, tcfg, tdec, _batches(prompt)[1]))


# ---------------------------------------------------------------------------
# acceptors (test_verify.py:61, :72)
# ---------------------------------------------------------------------------


def _logits_for(greedy_rows, vocab=11, second=None):
    """p1 logits whose argmax per slot is given; optional runner-up."""
    g = np.asarray(greedy_rows)
    b, k = g.shape
    logits = np.zeros((b, k, vocab), np.float32)
    for i in range(b):
        for j in range(k):
            logits[i, j, g[i, j]] = 5.0
            if second is not None:
                logits[i, j, second[i][j]] = 3.0
    return torch.tensor(logits)


def _accepts(props, logits, **dec):
    return P.resolve_policy(DecodeConfig(**dec)).acceptor.accepts(
        torch.tensor(props, dtype=I32), logits)


@pytest.mark.parametrize("fused", [False, True])
def test_topk_accepts_runner_up(fused):
    props = [[7, 2, 2]]
    logits = _logits_for([[4, 4, 4]], second=[[2, 3, 3]])
    exact = _accepts(props, logits, criterion="exact", fused_verify=fused)
    top2 = _accepts(props, logits, criterion="topk", top_k=2,
                    fused_verify=fused)
    assert not bool(exact[0, 1])
    assert bool(top2[0, 1])       # 2 is the runner-up at slot 0
    assert not bool(top2[0, 2])   # but not at slot 1


@pytest.mark.parametrize("fused", [False, True])
def test_distance_criterion_ordinal(fused):
    props = [[7, 100, 120]]
    logits = _logits_for([[98, 110, 0]], vocab=130)
    d2 = _accepts(props, logits, criterion="distance", epsilon=2.0,
                  fused_verify=fused)
    d10 = _accepts(props, logits, criterion="distance", epsilon=10.0,
                   fused_verify=fused)
    np.testing.assert_array_equal(d2.numpy(), [[True, True, False]])
    np.testing.assert_array_equal(d10.numpy(), [[True, True, True]])


def test_topk_acceptor_breaks_ties_by_lowest_id():
    """Equal logits rank by id, as lax.top_k: with ids 3, 5 and 8 tied,
    top-2 holds 3 and 5 and never 8."""
    logits = torch.zeros((1, 2, 11))
    logits[0, 0, [3, 5, 8]] = 1.0
    for fused in (False, True):
        acc = _accepts([[0, 8]], logits, criterion="topk", top_k=2,
                       fused_verify=fused)
        assert not bool(acc[0, 1])
        acc = _accepts([[0, 5]], logits, criterion="topk", top_k=2,
                       fused_verify=fused)
        assert bool(acc[0, 1])


# ---------------------------------------------------------------------------
# adaptive schedule (test_policy.py:84, :105)
# ---------------------------------------------------------------------------


def test_adaptive_schedule_cap_tracks_acceptance():
    sched = P.AdaptiveSchedule(decay=0.5, grow=0.8, shrink=0.4)
    b, k = 2, 6
    state = sched.init_state(b)
    assert state["cap"].dtype == I32 and state["rate"].dtype == torch.float32
    rem = torch.full((b,), 99, dtype=I32)
    none = torch.zeros((b, k), dtype=torch.bool)
    none[:, 0] = True                              # accept nothing extra
    allacc = torch.ones((b, k), dtype=torch.bool)
    for _ in range(12):
        khat, state = sched.block_size(none, rem, state)
        assert bool((khat >= 1).all()) and bool((khat <= k).all())
    assert int(state["cap"].max()) <= 2
    for _ in range(30):
        khat, state = sched.block_size(allacc, rem, state)
    assert int(state["cap"].min()) == k
    khat, _ = sched.block_size(allacc, rem, state)
    assert bool((khat == k).all())


def test_adaptive_cap_shrinks_then_recovers_stepwise():
    """Each step against an independent float32 replica of the controller
    (EMA of accepted/cap; cap +1 above ``grow``, -1 below ``shrink``)."""
    k, rem = 4, torch.full((1,), 99, dtype=I32)
    sched = P.AdaptiveSchedule(min_block=1, decay=0.5, grow=0.8, shrink=0.45)
    state = sched.init_state(1)
    reject = torch.zeros((1, k), dtype=torch.bool)
    reject[:, 0] = True                                   # prefix = 1
    accept = torch.ones((1, k), dtype=torch.bool)         # prefix = k
    rate, cap = np.float32(1.0), k
    caps, khats = [], []
    for accepts, steps, prefix in ((reject, 8, 1), (accept, 10, k)):
        for _ in range(steps):
            khat, state = sched.block_size(accepts, rem, state)
            cap = min(max(cap, 1), k)
            accepted = min(max(prefix, 1), cap)
            rate = np.float32(rate * np.float32(0.5) + np.float32(0.5)
                              * np.float32(accepted) / np.float32(cap))
            if rate >= np.float32(0.8):
                cap = min(cap + 1, k)
            elif rate <= np.float32(0.45):
                cap = max(cap - 1, 1)
            assert int(khat[0]) == min(accepted, 99)
            assert int(state["cap"][0]) == cap
            assert np.float32(state["rate"][0]) == pytest.approx(rate, abs=1e-6)
            caps.append(cap)
            khats.append(int(khat[0]))
    assert min(caps[:8]) <= 2 and caps[-1] == k and khats[-1] == k
    recovery = khats[8:]
    assert recovery == sorted(recovery) and recovery[0] < k


def test_adaptive_matches_reference_schedule():
    """The port's AdaptiveSchedule against the reference's on the same
    random accept masks and budgets: k̂, rate and cap at every step."""
    from repro.core import policy as jpolicy

    rng = np.random.default_rng(9)
    jsched = jpolicy.AdaptiveSchedule(min_block=2, decay=0.6)
    tsched = P.AdaptiveSchedule(min_block=2, decay=0.6)
    js, ts = jsched.init_state(4), tsched.init_state(4)
    for _ in range(25):
        acc = rng.random((4, 6)) < 0.7
        rem = rng.integers(1, 9, 4).astype(np.int32)
        jk, js = jsched.block_size(jnp.asarray(acc), jnp.asarray(rem), js)
        tk, ts = tsched.block_size(torch.tensor(acc), torch.tensor(rem), ts)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(ts["cap"].numpy(), np.asarray(js["cap"]))
        np.testing.assert_array_equal(ts["rate"].numpy(), np.asarray(js["rate"]))


# ---------------------------------------------------------------------------
# decode under every policy, dense and paged, against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["dense", "paged"])
@pytest.mark.parametrize("policy", ["exact", "topk", "distance", "adaptive",
                                    "topk_tree"])
def test_bpd_decode_policy_matches_reference(setup, greedy, policy, backend):
    jcfg, tcfg, jp, tp, prompt = setup
    jdec, tdec = _decs(policy=policy, cache_backend=backend, page_size=8)
    jb, tb = _batches(prompt)
    jres = jdecode.bpd_decode(jp, jcfg, jdec, jb)
    tres = tdecode.bpd_decode(tp, tcfg, tdec, tb)
    _check_same(jres, tres)
    if policy in ("exact", "adaptive", "topk_tree"):   # exact acceptance
        assert _rows(*tres) == greedy


@pytest.mark.parametrize("policy", ["topk", "topk_tree"])
def test_fused_accept_path_matches_reference(setup, policy):
    """The fused-verify plain version (the kernel's arithmetic) decides the
    same blocks, on the paged cache, tree permutation included."""
    jcfg, tcfg, jp, tp, prompt = setup
    jdec, tdec = _decs(policy=policy, cache_backend="paged", page_size=8,
                       fused_verify=True)
    jb, tb = _batches(prompt)
    _check_same(jdecode.bpd_decode(jp, jcfg, jdec, jb),
                tdecode.bpd_decode(tp, tcfg, tdec, tb))


def test_greedy_decode_paged_matches_reference(setup, greedy):
    jcfg, tcfg, jp, tp, prompt = setup
    jdec, tdec = _decs(cache_backend="paged", page_size=8)
    jb, tb = _batches(prompt)
    tres = tdecode.greedy_decode(tp, tcfg, tdec, tb)
    _check_same(jdecode.greedy_decode(jp, jcfg, jdec, jb), tres)
    assert _rows(*tres) == greedy


@pytest.mark.parametrize("block_k,fanout", [(2, 2), (5, 3), (8, 2), (8, 4)])
def test_topk_tree_is_lossless(block_k, fanout):
    """Any tree shape: exact acceptance over the tree emits greedy's tokens,
    on both caches."""
    cfg = ModelConfig(name="t", num_layers=2, d_model=64, num_heads=4,
                      num_kv_heads=2, d_ff=128, vocab_size=97, bpd_k=8,
                      dtype="float32")
    from repro_torch.models import model as tmodel

    params = tmodel.init(cfg, seed=block_k, device="cpu")
    prompt = torch.randint(0, 97, (4, 5), dtype=I32,
                           generator=torch.Generator().manual_seed(fanout))
    g = _rows(*tdecode.greedy_decode(params, cfg, DecodeConfig(max_new_tokens=10),
                                     {"tokens": prompt}))
    for backend in ("dense", "paged"):
        dec = DecodeConfig(max_new_tokens=10, block_k=block_k, top_k=fanout,
                           policy="topk_tree", cache_backend=backend)
        toks, stats = tdecode.bpd_decode(params, cfg, dec, {"tokens": prompt})
        assert _rows(toks.numpy(), stats) == g
        assert stats["iterations"] <= 10


def test_tree_refuses_min_block(setup):
    jcfg, tcfg, jp, tp, prompt = setup
    _, tdec = _decs(policy="topk_tree", min_block=2)
    with pytest.raises(NotImplementedError, match="min_block"):
        tdecode.bpd_decode(tp, tcfg, tdec, _batches(prompt)[1])


# ---------------------------------------------------------------------------
# hand-made tree iterations: a sibling accepted, a full chain accepted
# ---------------------------------------------------------------------------


def _tree_iteration(setup, greedy, backend, node_tokens):
    """From the prefill state, run one topk_tree iteration on hand-made
    node tokens in both packages, then a second one on the drafted
    proposals; everything is compared after each."""
    jcfg, tcfg, jp, tp, prompt = setup
    jdec, tdec = _decs(policy="topk_tree", cache_backend=backend, page_size=8)
    jb, tb = _batches(prompt)
    js, _ = jdecode.bpd_prefill_causal_lm(jp, jcfg, jdec, jb, max_new=MAX_NEW)
    ts, _ = tdecode.bpd_prefill_causal_lm(tp, tcfg, tdec, tb, max_new=MAX_NEW)
    np.testing.assert_array_equal(ts.proposals.numpy(), np.asarray(js.proposals))
    js = js._replace(proposals=jnp.asarray(node_tokens))
    ts = ts._replace(proposals=torch.tensor(node_tokens))
    khats = []
    for _ in range(2):
        js = jdecode.bpd_iteration(jp, jcfg, jdec,
                                   jdecode.causal_lm_backend(jcfg), js,
                                   prefix_offset=0, max_new=MAX_NEW)
        ts = tdecode.bpd_iteration(tp, tcfg, tdec,
                                   tdecode.causal_lm_backend(tcfg), ts,
                                   prefix_offset=0, max_new=MAX_NEW)
        np.testing.assert_array_equal(ts.text_len.numpy(), np.asarray(js.text_len))
        np.testing.assert_array_equal(ts.tokens.numpy(), np.asarray(js.tokens))
        np.testing.assert_array_equal(ts.proposals.numpy(), np.asarray(js.proposals))
        for tc, jc in zip(ts.caches, js.caches):
            for name, want in jc["attn"].items():
                got = tc["attn"][name].numpy()
                if name in ("pos", "tbl"):
                    np.testing.assert_array_equal(got, np.asarray(want))
                else:
                    np.testing.assert_allclose(got, np.asarray(want),
                                               rtol=2e-5, atol=2e-5)
        khats.append((ts.text_len - PROMPT).tolist())
        n = ts.text_len.tolist()
        assert [r[:n[i]] for i, r in enumerate(ts.tokens.tolist())] == \
            [g[:n[i]] for i, g in enumerate(greedy)]
    return khats


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_tree_iteration_accepts_a_sibling(setup, greedy, backend):
    """Node 1 wrong and node 2 (its sibling) = greedy's next token: k̂ = 2
    in every row, and tree_commit_attn moves node 2's K/V into chain slot 1,
    so the next iteration still gives greedy's tokens."""
    g = np.asarray([r[PROMPT:PROMPT + K] for r in greedy], np.int32)
    nodes = np.zeros((B, K), np.int32)               # default_tree(4, 2)
    nodes[:, 0] = g[:, 0]
    nodes[:, 1] = (g[:, 1] + 1) % 97
    nodes[:, 2] = g[:, 1]
    nodes[:, 3] = g[:, 2]
    khats = _tree_iteration(setup, greedy, backend, nodes)
    assert khats[0] == [2] * B


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_tree_iteration_accepts_the_chain(setup, greedy, backend):
    """Node 1's chain all correct: k̂ = k - fanout + 1 = 3 in every row."""
    g = np.asarray([r[PROMPT:PROMPT + K] for r in greedy], np.int32)
    nodes = np.zeros((B, K), np.int32)               # parents (-1, 0, 0, 1)
    nodes[:, 0], nodes[:, 1], nodes[:, 3] = g[:, 0], g[:, 1], g[:, 2]
    nodes[:, 2] = (g[:, 1] + 3) % 97
    khats = _tree_iteration(setup, greedy, backend, nodes)
    assert khats[0] == [K - 2 + 1] * B


# ---------------------------------------------------------------------------
# registry and the serve launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("criterion", ["exact", "topk", "distance"])
def test_criterion_strings_alias_policy_objects(setup, criterion):
    """dec.criterion strings, dec.policy names and hand-built policy objects
    decode token-identically (test_policy.py:153)."""
    _, tcfg, _, tp, prompt = setup
    acceptors = {"exact": P.ExactAcceptor(), "topk": P.TopKAcceptor(top_k=2),
                 "distance": P.DistanceAcceptor(epsilon=2.0)}
    _, dec = _decs(criterion=criterion)
    tb = _batches(prompt)[1]
    ref_t, ref_s = tdecode.bpd_decode(tp, tcfg, dec, tb)
    by_name = tdecode.bpd_decode(tp, tcfg, dec.replace(criterion="exact",
                                                       policy=criterion), tb)
    obj = P.DecodePolicy(P.HeadsDrafter(), acceptors[criterion],
                         P.StaticSchedule(), name="hand-built")
    by_obj = tdecode.bpd_decode(tp, tcfg, dec, tb, policy=obj)
    for t, s in (by_name, by_obj):
        assert torch.equal(t, ref_t)
        assert torch.equal(s["generated"], ref_s["generated"])
        assert s["iterations"] == ref_s["iterations"]


def test_registry_matches_reference_builders():
    from repro.core import policy as jpolicy

    dec = dict(top_k=3, epsilon=1.5, min_block=2, image_height=4,
               image_width=4, locality_stride=2)
    for name in P.list_policies():
        got = P.resolve_policy(DecodeConfig(policy=name, **dec))
        want = jpolicy.resolve_policy(JDecodeConfig(policy=name, **dec))
        assert got.name == want.name == name
        for part in ("drafter", "acceptor", "schedule"):
            g, w = getattr(got, part), getattr(want, part)
            assert type(g).__name__ == type(w).__name__
            assert dataclasses.asdict(g) == dataclasses.asdict(w)
    assert P.resolve_policy(DecodeConfig(policy="topk_tree", top_k=1)).drafter.fanout == 2
    with pytest.raises(ValueError, match="unknown decode policy"):
        P.resolve_policy(DecodeConfig(policy="nonesuch"))


def test_serve_topk_tree_paged_equals_greedy(capsys):
    from repro_torch.launch import serve

    out = serve.main(["--arch", "granite-3-8b", "--device", "cpu", "--batch",
                      "2", "--prompt-len", "8", "--max-new", "6", "--policy",
                      "topk_tree", "--cache-backend", "paged", "--page-size",
                      "8"])
    printed = capsys.readouterr().out
    assert "policy=topk_tree, paged cache" in printed
    assert out["dec"].cache_backend == "paged" and out["dec"].top_k == 2
    gt, gs = tdecode.greedy_decode(out["params"], out["cfg"],
                                   out["dec"].replace(cache_backend="dense"),
                                   out["batch"])
    assert _rows(out["tokens"].numpy(), out["stats"]) == _rows(gt.numpy(), gs)

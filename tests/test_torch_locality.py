"""The ``locality`` image policy and its ordinal data against the JAX
reference, on the CPU: ``locality_plan`` / ``locality_order`` /
``OrdinalField`` / ``OrdinalCurves`` arrays equal to the reference's,
``_locality_tables`` equal, twins of
tests/test_policy_equivalence.py:249-297 (geometry required, lossless
against exact, the engine token-identical to the static decode), and
whole decodes on bridged ``tiny_dense`` weights equal to the reference's
``DecodeSession``: tokens, iterations and k̂."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_dense  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.config import DecodeConfig as JDecodeConfig  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.config import DecodeConfig, ModelConfig  # noqa: E402
from repro_torch.core import decode as tdecode  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

torch.set_num_threads(2)
GEOMETRIES = [(8, 8, 2), (16, 12, 4), (5, 7, 4)]   # square, wide, ragged
GRID = dict(image_height=4, image_width=4, locality_stride=2)


# ---------------------------------------------------------------------------
# the ordinal data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,w,stride", GEOMETRIES)
def test_locality_plan_and_order_equal_reference(h, w, stride):
    for got, want in zip(tsyn.locality_plan(h, w, stride),
                         jsyn.locality_plan(h, w, stride)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype == np.int32
    for got, want in zip(tsyn.locality_order(h, w, stride),
                         jsyn.locality_order(h, w, stride)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("stride", [0, 3, 6])
def test_locality_plan_refuses_other_strides(stride):
    with pytest.raises(ValueError, match="power of two"):
        tsyn.locality_plan(8, 8, stride)


@pytest.mark.parametrize("bilinear", [False, True])
@pytest.mark.parametrize("order", ["raster", "locality"])
@pytest.mark.parametrize("h,w,stride", GEOMETRIES)
def test_ordinal_field_equals_reference(h, w, stride, order, bilinear):
    """The same seed draws the same grids, streams and batches; to_grid
    inverts serialize; coarse_len and the index maps are the reference's."""
    kw = dict(levels=16, height=h, width=w, n_waves=2, stride=stride,
              order=order, bilinear=bilinear)
    tf, jf = tsyn.OrdinalField(**kw), jsyn.OrdinalField(**kw)
    assert tf.coarse_len == jf.coarse_len
    np.testing.assert_array_equal(tf.gen_index, jf.gen_index)
    np.testing.assert_array_equal(tf.raster_index, jf.raster_index)
    grids = tf.sample_grid(np.random.default_rng(5), 3)
    np.testing.assert_array_equal(grids,
                                  jf.sample_grid(np.random.default_rng(5), 3))
    stream = tf.serialize(grids)
    np.testing.assert_array_equal(stream, jf.serialize(grids))
    np.testing.assert_array_equal(tf.to_grid(stream), grids)
    np.testing.assert_array_equal(
        tf.sample(np.random.default_rng(6), 2, seq_len=10),
        jf.sample(np.random.default_rng(6), 2, seq_len=10))
    tb, jb = tf.batches(batch=2, seed=4), jf.batches(batch=2, seed=4)
    for _ in range(2):
        np.testing.assert_array_equal(next(tb)["tokens"], next(jb)["tokens"])


def test_ordinal_field_refuses_unknown_order():
    with pytest.raises(ValueError, match="raster' or 'locality"):
        tsyn.OrdinalField(order="zigzag")


def test_ordinal_curves_equal_reference():
    tc, jc = tsyn.OrdinalCurves(levels=64), jsyn.OrdinalCurves(levels=64)
    np.testing.assert_array_equal(tc.sample(np.random.default_rng(1), 3, 40),
                                  jc.sample(np.random.default_rng(1), 3, 40))
    tb, jb = tc.batches(batch=2, seq_len=17, seed=2), jc.batches(batch=2,
                                                                 seq_len=17,
                                                                 seed=2)
    np.testing.assert_array_equal(next(tb)["tokens"], next(jb)["tokens"])


@pytest.mark.parametrize("h,w,stride", GEOMETRIES)
def test_locality_tables_equal_reference(h, w, stride):
    got = tpolicy._locality_tables(h, w, stride)
    want = jpolicy._locality_tables(h, w, stride)
    assert got._fields == want._fields
    for name in got._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


# ---------------------------------------------------------------------------
# the policy on bridged tiny_dense weights
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stack():
    jcfg = tiny_dense()
    jp = jmodel.init(jax.random.PRNGKey(0), jcfg)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    tp = bridge.from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                                device="cpu")
    return jcfg, jp, tcfg, tp


def test_locality_requires_grid_geometry():
    with pytest.raises(ValueError, match="image_height"):
        tpolicy.resolve_policy(DecodeConfig(max_new_tokens=12, block_k=4),
                               "locality")
    pol = tpolicy.resolve_policy(DecodeConfig(**GRID), "locality")
    assert pol.name == "locality" and pol.schedule.start == 4
    assert "locality" in tpolicy.list_policies()


def test_locality_policy_lossless(stack):
    """Under exact acceptance the locality drafter moves iteration counts,
    never tokens: its stream equals the heads-drafted exact stream."""
    _, _, tcfg, tp = stack
    dec = DecodeConfig(max_new_tokens=12, block_k=4, **GRID)
    rng = np.random.default_rng(67)
    batch = {"tokens": torch.tensor(rng.integers(0, tcfg.vocab_size,
                                                 size=(2, 4)))}
    outs = {pol: tserving.DecodeSession(tp, tcfg, dec, policy=pol).decode(batch)[0]
            for pol in ("exact", "locality")}
    assert torch.equal(outs["locality"], outs["exact"])


@pytest.mark.parametrize("prompt_len,grid,backend", [
    (4, GRID, "dense"), (4, GRID, "paged"), (7, GRID, "dense"),
    (16, dict(image_height=8, image_width=8, locality_stride=2), "dense"),
    (16, dict(image_height=8, image_width=8, locality_stride=4), "paged")])
def test_locality_decode_equals_reference(stack, prompt_len, grid, backend):
    """Tokens, iterations, generated counts and k̂ equal the reference's
    DecodeSession's, at the coarse prompt length and off it, on both
    caches; the locality stream is exact's."""
    jcfg, jp, tcfg, tp = stack
    kw = dict(max_new_tokens=12, block_k=4, cache_backend=backend,
              page_size=8, **grid)
    prompts = np.random.default_rng(prompt_len).integers(
        0, tcfg.vocab_size, (3, prompt_len)).astype(np.int32)
    jt, js = jserving.DecodeSession(jp, jcfg, JDecodeConfig(**kw),
                                    policy="locality").decode(
        {"tokens": jnp.asarray(prompts)})
    tt, ts = tdecode.bpd_decode(tp, tcfg, DecodeConfig(**kw),
                                {"tokens": torch.tensor(prompts)},
                                policy="locality")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert ts["iterations"] == int(js["iterations"])
    np.testing.assert_array_equal(ts["generated"].numpy(),
                                  np.asarray(js["generated"]))
    assert ts["mean_accepted"] == pytest.approx(float(js["mean_accepted"]),
                                                rel=1e-6)
    exact, _ = tdecode.bpd_decode(tp, tcfg, DecodeConfig(**kw),
                                  {"tokens": torch.tensor(prompts)})
    assert torch.equal(tt, exact)


def test_locality_drafts_equal_reference(stack):
    """One drafting step alone, on logits made to accept long blocks: the
    committed grid and the proposals (interpolation re-ranked in the ±1
    window by each slot's head) are the reference's."""
    jcfg, jp, tcfg, tp = stack
    dec = DecodeConfig(max_new_tokens=12, block_k=4, **GRID)
    b, k, n = 3, 4, 16
    rng = np.random.default_rng(2)
    hidden = rng.standard_normal((b, k, tcfg.d_model)).astype(np.float32)
    buf = rng.integers(0, 97, (b, n + k)).astype(np.int32)
    khat = np.array([1, 3, 4], np.int32)
    text_len = np.array([5, 9, 12], np.int32)
    old = rng.integers(0, 97, (b, k)).astype(np.int32)
    prev = old[np.arange(b), khat - 1]
    jlogits = jmodel.all_head_logits(jp, jcfg, jnp.asarray(hidden))[:, :, :k]
    jprops, jstate = jpolicy.resolve_policy(JDecodeConfig(**dataclasses.asdict(
        dec)), "locality").drafter.draft(jpolicy.DraftInputs(
            logits=jlogits, khat=jnp.asarray(khat),
            slot=jnp.asarray(khat - 1), text_len=jnp.asarray(text_len),
            old_proposals=jnp.asarray(old), prev_token=jnp.asarray(prev)),
        {"grid": jnp.asarray(buf)})
    th = torch.tensor(hidden)
    din = tpolicy.DraftInputs(
        hidden=th, p1_logits=tmodel.base_logits(tp, tcfg, th),
        khat=torch.tensor(khat), slot=torch.tensor(khat - 1),
        text_len=torch.tensor(text_len), old_proposals=torch.tensor(old),
        prev_token=torch.tensor(prev), head_topk=None,
        head_logits=lambda h: tmodel.all_head_logits(tp, tcfg, h))
    tprops, tstate = tpolicy.resolve_policy(dec, "locality").drafter.draft(
        din, {"grid": torch.tensor(buf)})
    np.testing.assert_array_equal(tprops.numpy(), np.asarray(jprops))
    np.testing.assert_array_equal(tstate["grid"].numpy(),
                                  np.asarray(jstate["grid"]))


def test_other_policies_never_compute_head_logits(stack, monkeypatch):
    """Only a drafter that asks gets the heads' full logits: exact,
    topk_tree and the engine never call Backend.head_logits, locality
    does (at the accepted slot, (B, K, V))."""
    _, _, tcfg, tp = stack
    calls = []
    real = tmodel.all_head_logits

    def counted(params, cfg, hidden):
        calls.append(tuple(hidden.shape))
        return real(params, cfg, hidden)

    monkeypatch.setattr(tmodel, "all_head_logits", counted)
    batch = {"tokens": torch.tensor(np.random.default_rng(1).integers(
        0, 97, (2, 6)))}
    for pol in ("exact", "topk_tree", "adaptive"):
        tdecode.bpd_decode(tp, tcfg, DecodeConfig(max_new_tokens=8, block_k=4,
                                                  top_k=2, **GRID), batch,
                           policy=pol)
    assert calls == []
    _, stats = tdecode.bpd_decode(tp, tcfg, DecodeConfig(
        max_new_tokens=8, block_k=4, **GRID), batch, policy="locality")
    assert len(calls) == stats["iterations"] + 1          # and the prefill
    assert set(calls) == {(2, tcfg.d_model)}


def _engine_run(side, stack):
    """tests/test_policy_equivalence.py::test_locality_engine_token_identical
    on one package: a locality and an exact group of one slot each, six
    requests of 3-6 tokens, budgets 4-12."""
    mod, params, cfg, dcls = side
    dec = dcls(max_new_tokens=12, block_k=4, top_k=2, **GRID)
    ecfg = mod.EngineConfig(num_slots=2, max_prompt_len=6, max_new_cap=12)
    eng = mod.ContinuousBatchingEngine(params, cfg, dec, ecfg,
                                       policies={"locality": 1, "exact": 1})
    sched = mod.Scheduler(eng)
    rng = np.random.default_rng(61)
    reqs = [mod.Request(rid=i, policy=pol,
                        prompt=rng.integers(0, cfg.vocab_size,
                                            size=int(rng.integers(3, 7))),
                        max_new=int(rng.integers(4, 13)))
            for i, pol in enumerate(["locality", "exact"] * 3)]
    for r in reqs:
        sched.submit(r)
    return eng, sched.run(), reqs


def test_locality_engine_token_identical(stack):
    """The locality group in a mixed engine, admissions and evictions
    interleaved with an exact group, serves each request as the static
    decode of that request alone (tokens and generated counts) and as the
    reference's engine (tokens, generated, invocations); every serving
    function is built once."""
    jcfg, jp, tcfg, tp = stack
    jeng, jdone, _ = _engine_run((jserving, jp, jcfg, JDecodeConfig), stack)
    teng, tdone, reqs = _engine_run((tserving, tp, tcfg, DecodeConfig), stack)
    rec = lambda f: (f.rid, f.policy, f.tokens.tolist(), f.generated,  # noqa: E731
                     f.invocations)
    assert sorted(map(rec, tdone)) == sorted(map(rec, jdone))
    by_rid = {f.rid: f for f in tdone}
    for r in reqs:
        dec = DecodeConfig(max_new_tokens=r.max_new, block_k=4, **GRID)
        toks, stats = tdecode.bpd_decode(
            tp, tcfg, dec, {"tokens": torch.tensor(r.prompt)[None]},
            policy=r.policy)
        want = toks[0, len(r.prompt):int(stats["text_len"][0])].tolist()
        assert by_rid[r.rid].tokens.tolist() == want, r.rid
        assert by_rid[r.rid].generated == int(stats["generated"][0])
    assert all(v == 1 for v in teng.compile_counts().values())
    assert teng.compile_counts() == jeng.compile_counts()


def test_evict_resets_locality_state(stack):
    """Eviction gives a retired slot the fresh grid and cursor, so no slot
    leaks drafter or schedule history into its next request."""
    _, _, tcfg, tp = stack
    dec = DecodeConfig(max_new_tokens=8, block_k=4, **GRID)
    eng = tserving.ContinuousBatchingEngine(
        tp, tcfg, dec, tserving.EngineConfig(num_slots=2, max_prompt_len=6,
                                             max_new_cap=8),
        policies={"locality": 2})
    sched = tserving.Scheduler(eng)
    sched.submit(tserving.Request(rid=0, prompt=np.arange(1, 6), max_new=8,
                                  policy="locality"))
    sched.run()
    state = eng.groups[0].state.policy_state
    assert bool((state.drafter["grid"] == 0).all())
    assert bool((state.schedule["pos"] == 4).all())


def test_serve_launcher_locality(capsys):
    """launch/serve.py --policy locality with the grid flags serves on the
    CPU, statically and through an engine group."""
    from repro_torch.launch import serve

    out = serve.main(["--arch", "granite-3-8b", "--device", "cpu", "--batch",
                      "2", "--prompt-len", "8", "--max-new", "6", "--policy",
                      "locality", "--image-height", "8", "--image-width", "8",
                      "--locality-stride", "2"])
    assert "policy=locality" in capsys.readouterr().out
    assert out["dec"].image_height == 8 and out["dec"].locality_stride == 2
    gt, _ = tdecode.greedy_decode(out["params"], out["cfg"], out["dec"],
                                  out["batch"])
    n = 8 + 6
    assert torch.equal(out["tokens"][:, :n], gt[:, :n])
    out = serve.main(["--arch", "granite-3-8b", "--device", "cpu", "--batch",
                      "2", "--prompt-len", "8", "--max-new", "6", "--engine",
                      "--policies", "locality=1,exact=1", "--image-height",
                      "8", "--image-width", "8", "--locality-stride", "2"])
    assert {f.policy for f in out["finished"]} <= {"locality", "exact"}

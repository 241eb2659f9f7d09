"""The port's continuous-batching engine against the reference's
(twins of tests/test_serving.py), in fp32 on the CPU on bridged
``tiny_dense`` weights: the same ``Request`` stream at the same virtual
``now=`` times through both engines gives the same per-request tokens,
``generated`` and invocations, the same finish order, and the same
``num_steps`` / ``num_admits`` / ``num_host_syncs``; each request's tokens
are also the port's own ``bpd_decode`` of that request alone, and every
serving function is built once."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from conftest import tiny_dense, tiny_rwkv, tiny_seq2seq  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.config import DecodeConfig as JDecodeConfig  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.config import DecodeConfig, ModelConfig  # noqa: E402
from repro_torch.core import decode as tdecode  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

torch.set_num_threads(2)
pytestmark = pytest.mark.serving


@pytest.fixture(scope="module")
def stack():
    jcfg = tiny_dense()
    jp = jmodel.init(jax.random.PRNGKey(0), jcfg)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    tp = bridge.from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                                device="cpu")
    return {"jax": (jserving, jp, jcfg, JDecodeConfig),
            "torch": (tserving, tp, tcfg, DecodeConfig)}


def _engine(side, ecfg_kw, dec_kw, **kw):
    mod, params, cfg, dcls = side
    return mod.ContinuousBatchingEngine(params, cfg, dcls(**dec_kw),
                                        mod.EngineConfig(**ecfg_kw), **kw)


def _drive(sched, start=0.0, max_steps=500):
    """Virtual clock: one scheduler step per second."""
    now, fin = start, []
    while not sched.drained():
        assert now < start + max_steps, "scheduler did not drain"
        fin += sched.step(now=now)
        now += 1.0
    return fin


def _record(f):
    return (f.rid, f.prompt_len, f.tokens.tolist(), f.generated,
            f.invocations, round(f.mean_accepted, 6), f.policy,
            f.admit_time, f.finish_time, f.preempted)


def _counts(eng):
    return (eng.num_steps, eng.num_admits, eng.num_host_syncs,
            eng.num_stream_syncs, eng.num_prefill_batches,
            eng.num_attach_backpressure, eng.num_overlap_harvests)


def _assert_same_run(jres, tres):
    (jeng, jfin), (teng, tfin) = jres, tres
    assert [_record(f) for f in tfin] == [_record(f) for f in jfin]
    assert _counts(teng) == _counts(jeng)
    assert teng.compile_counts() == jeng.compile_counts()
    assert all(v == 1 for v in teng.compile_counts().values())


def _alone(side, prompt, max_new, **dec_kw):
    """The port's own bpd_decode of one request."""
    _, params, cfg, dcls = side
    dec = dcls(**{**dec_kw, "max_new_tokens": max_new})
    toks, stats = tdecode.bpd_decode(params, cfg, dec,
                                     {"tokens": torch.tensor(prompt)[None]})
    return toks[0, len(prompt):int(stats["text_len"][0])].tolist()


# ---------------------------------------------------------------------------
# the served fixture of tests/test_serving.py: 7 requests through 3 slots
# ---------------------------------------------------------------------------

SERVED_DEC = dict(max_new_tokens=24, block_k=4, eos_id=3)


def _serve7(side, **dec_kw):
    mod = side[0]
    eng = _engine(side, dict(num_slots=3, max_prompt_len=10, max_new_cap=24),
                  {**SERVED_DEC, **dec_kw})
    sched = mod.Scheduler(eng)
    rng = np.random.default_rng(0)
    reqs = {}
    for i in range(7):
        p = rng.integers(0, 97, size=int(rng.integers(3, 11)))
        reqs[i] = mod.Request(rid=i, prompt=p, arrival=0.0,
                              max_new=int(rng.integers(4, 25)))
        sched.submit(reqs[i])
    return eng, _drive(sched), reqs


@pytest.fixture(scope="module", params=["dense", "paged"])
def served(stack, request):
    kw = {} if request.param == "dense" else dict(cache_backend="paged",
                                                  page_size=8)
    return {name: _serve7(side, **kw) for name, side in stack.items()}, kw


def test_engine_equals_reference(served):
    runs, _ = served
    _assert_same_run(runs["jax"][:2], runs["torch"][:2])
    assert len(runs["torch"][1]) == 7


def test_engine_matches_own_bpd_decode_per_request(stack, served):
    runs, kw = served
    _, finished, reqs = runs["torch"]
    for f in finished:
        want = _alone(stack["torch"], reqs[f.rid].prompt,
                      min(reqs[f.rid].max_new, 24), **SERVED_DEC, **kw)
        assert f.tokens.tolist() == want, f.rid
        assert f.generated == len(want)


def test_slots_fully_recycled(served):
    """After draining every slot is free and holds no visible KV entry:
    each position is -1 or inside the frozen block [text_len, text_len+k)."""
    runs, _ = served
    eng = runs["torch"][0]
    assert eng.free_slots() == [0, 1, 2]
    text_len = eng.state.text_len[:, None]
    for layer in eng.state.caches:
        pos = layer["attn"]["pos"]
        ok = (pos == -1) | ((pos >= text_len) & (pos < text_len + eng.block_k))
        assert bool(ok.all())
    # managed tables of retired rows point at the trash page
    if "tbl" in eng.state.caches[0]["attn"]:
        assert bool((eng.state.caches[0]["attn"]["tbl"] == 0).all())


def test_per_request_stats(served):
    runs, _ = served
    finished = runs["torch"][1]
    stats = tserving.aggregate_stats(finished, wall_seconds=1.0)
    jstats = jserving.aggregate_stats(runs["jax"][1], wall_seconds=1.0)
    assert stats == jstats
    for f in finished:
        assert f.invocations >= 2 and 0 < f.generated <= 24


# ---------------------------------------------------------------------------
# mid-flight admission, policy groups, host-sync accounting
# ---------------------------------------------------------------------------


def _midflight(side):
    mod = side[0]
    eng = _engine(side, dict(num_slots=2, max_prompt_len=8, max_new_cap=16),
                  dict(max_new_tokens=16, block_k=4))
    rng = np.random.default_rng(3)
    p0 = rng.integers(0, 97, size=8)
    p1 = rng.integers(0, 97, size=5)
    eng.admit(mod.Request(rid=0, prompt=p0, max_new=16), now=0.0)
    done = []
    for t in range(3):
        done += eng.step(now=float(t))
    eng.admit(mod.Request(rid=1, prompt=p1, max_new=10), now=3.0)
    t = 3.0
    while eng.has_active():
        done += eng.step(now=t)
        t += 1.0
    return eng, done, (p0, p1)


def test_midflight_admission_equals_reference_and_alone(stack):
    jres, tres = _midflight(stack["jax"]), _midflight(stack["torch"])
    _assert_same_run(jres[:2], tres[:2])
    by_rid = {f.rid: f for f in tres[1]}
    p0, p1 = tres[2]
    dec = dict(block_k=4)
    assert by_rid[0].tokens.tolist() == _alone(stack["torch"], p0, 16, **dec)
    assert by_rid[1].tokens.tolist() == _alone(stack["torch"], p1, 10, **dec)


def _host_sync_trace(side, groups, **dec_kw):
    """tests/test_serving.py::test_host_syncs_count_group_steps_not_members,
    returning the sync counts at each checkpoint and the finished records."""
    mod = side[0]
    eng = _engine(side, dict(num_slots=sum(groups.values()), max_prompt_len=6,
                             max_new_cap=24),
                  dict(max_new_tokens=24, block_k=4, **dec_kw),
                  policies=groups)
    rng = np.random.default_rng(13)

    def mk(rid, pol):
        return mod.Request(rid=rid, policy=pol, max_new=24,
                           prompt=rng.integers(0, 97, size=6))

    trace, t = [], 0.0
    eng.admit(mk(0, "adaptive"), now=t)
    eng.admit(mk(1, "adaptive"), now=t)
    for _ in range(2):
        assert not eng.step(now=t)
        t += 1.0
    trace.append(eng.num_host_syncs)
    for i, name in enumerate(n for n in groups if n != "adaptive"):
        eng.admit(mk(2 + i, name), now=t)
    for _ in range(2):
        assert not eng.step(now=t)
        t += 1.0
    trace.append(eng.num_host_syncs)
    before, steps, pulls, finished = eng.num_host_syncs, 0, 0, []
    while eng.has_active():
        active = sum(1 for g in eng.groups if np.any(g.status & 1))
        done = eng.step(now=t)
        t += 1.0
        steps += active
        pulls += len({f.policy for f in done})
        finished += done
    assert eng.num_host_syncs - before == steps + pulls
    trace.append(eng.num_host_syncs)
    return eng, finished, trace


@pytest.mark.parametrize("groups", [
    {"exact": 1, "adaptive": 2},
    {"exact": 1, "topk": 1, "adaptive": 2},
])
def test_host_syncs_count_group_steps_not_members(stack, groups):
    jeng, jfin, jtrace = _host_sync_trace(stack["jax"], groups)
    teng, tfin, ttrace = _host_sync_trace(stack["torch"], groups)
    assert ttrace == jtrace
    assert ttrace[0] == 2 and ttrace[1] - ttrace[0] == 2 * len(groups)
    _assert_same_run((jeng, jfin), (teng, tfin))
    for g in teng.groups:                  # one forward per group step here
        assert g.num_forwards == g.num_steps


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_tree_group_equals_reference(stack, backend):
    """A ``topk_tree`` slot group beside an exact one, on the dense slab
    and on the managed page pool (tree commits through the table)."""
    kw = dict(top_k=2) if backend == "dense" else dict(
        top_k=2, cache_backend="paged", page_size=8)
    runs = {}
    for name, side in stack.items():
        mod = side[0]
        eng = _engine(side, dict(num_slots=3, max_prompt_len=10,
                                 max_new_cap=20),
                      dict(max_new_tokens=20, block_k=4, **kw),
                      policies={"exact": 1, "topk_tree": 2})
        sched = mod.Scheduler(eng)
        rng = np.random.default_rng(21)
        for i in range(6):
            sched.submit(mod.Request(
                rid=i, arrival=float(i // 2),
                policy=("exact", "topk_tree", "topk_tree")[i % 3],
                prompt=rng.integers(0, 97, size=int(rng.integers(3, 11))),
                max_new=int(rng.integers(6, 21))))
        runs[name] = (eng, _drive(sched))
    _assert_same_run(runs["jax"], runs["torch"])
    for f in runs["torch"][1]:             # lossless: the chain's tokens
        assert f.policy in ("exact", "topk_tree")


@pytest.mark.parametrize("policy", ["exact", "topk_tree"])
def test_cow_prefix_pages_equal_reference(stack, policy):
    """Two requests that share a prompt prefix on the managed page pool:
    both engines map the same physical pages (the second admission's
    prefix pages are CoW hits, left unwritten) and decode the same tokens,
    and no decode write, chain or tree commit, touches a shared page."""
    out = {}
    rng = np.random.default_rng(5)
    base = rng.integers(0, 97, size=20)
    prompts = [base, np.concatenate([base[:16], rng.integers(0, 97, 3)])]
    for name, side in stack.items():
        mod = side[0]
        eng = _engine(side, dict(num_slots=2, max_prompt_len=20,
                                 max_new_cap=12),
                      dict(max_new_tokens=12, block_k=4, top_k=2,
                           cache_backend="paged", page_size=8),
                      policies={policy: 2})
        for i, p in enumerate(prompts):
            eng.admit(mod.Request(rid=i, prompt=p, max_new=12,
                                  policy=policy), now=0.0)
        caches = eng.groups[0].state.caches
        tbl = np.array(caches[0]["attn"]["tbl"])   # a copy
        shared = None
        if name == "torch":
            pages = torch.tensor(tbl[0, :2]).long()
            shared = [(c["attn"]["kp"][pages].clone(),
                       c["attn"]["vp"][pages].clone()) for c in caches]
        alloc = eng.groups[0].pages
        refcount = dict(alloc.refcount)
        done, t = [], 0.0
        while eng.has_active():
            done += eng.step(now=t)
            t += 1.0
        if shared is not None:
            for c, (k, v) in zip(eng.groups[0].state.caches, shared):
                torch.testing.assert_close(c["attn"]["kp"][pages], k,
                                           rtol=0, atol=0)
                torch.testing.assert_close(c["attn"]["vp"][pages], v,
                                           rtol=0, atol=0)
        out[name] = (eng, done, tbl, refcount, alloc)
    (jeng, jdone, jtbl, jref, _), (teng, tdone, ttbl, tref, alloc) = \
        out["jax"], out["torch"]
    np.testing.assert_array_equal(ttbl, jtbl)
    assert tref == jref
    assert ttbl[0, 0] == ttbl[1, 0] and ttbl[0, 1] == ttbl[1, 1]
    assert alloc.cow_hits == 2
    _assert_same_run((jeng, jdone), (teng, tdone))
    for i, p in enumerate(prompts):
        got = [f for f in tdone if f.rid == i][0].tokens.tolist()
        assert got == _alone(stack["torch"], p, 12, block_k=4)


# ---------------------------------------------------------------------------
# steps_per_sync
# ---------------------------------------------------------------------------


def _windowed(side, spd, **dec_kw):
    mod = side[0]
    eng = _engine(side, dict(num_slots=2, max_prompt_len=6, max_new_cap=10,
                             steps_per_sync=spd),
                  dict(max_new_tokens=10, block_k=4, **dec_kw))
    sched = mod.Scheduler(eng)
    rng = np.random.default_rng(11)
    for i in range(8):
        sched.submit(mod.Request(
            rid=i, arrival=0.0, max_new=int(rng.integers(3, 11)),
            prompt=rng.integers(0, 97, size=int(rng.integers(2, 7)))))
    return eng, _drive(sched)


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_steps_per_sync_4_equals_1_and_reference(stack, backend):
    kw = {} if backend == "dense" else dict(cache_backend="paged",
                                            page_size=8)
    one = _windowed(stack["torch"], 1, **kw)
    four = _windowed(stack["torch"], 4, **kw)
    jfour = _windowed(stack["jax"], 4, **kw)
    _assert_same_run(jfour, four)
    assert [(f.rid, f.tokens.tolist(), f.invocations) for f in four[1]] == \
        [(f.rid, f.tokens.tolist(), f.invocations) for f in one[1]]
    eng = four[0]
    # a window dispatches 4 forwards; the iterations that did work are
    # counted as the reference's early-exiting while_loop counts them
    group_steps = eng.num_host_syncs - _finishing_steps(four[1])
    assert eng.num_forwards == 4 * group_steps
    assert eng.num_forwards > eng.num_steps
    assert eng.num_host_syncs < one[0].num_host_syncs


def _finishing_steps(finished):
    """Harvest pulls: one per step in which the (single) group finished
    something (requests finishing together share a pull)."""
    return len({f.finish_time for f in finished})


def test_noop_iteration_leaves_state_unchanged(stack):
    """A window iteration with every row frozen (``go`` False) leaves the
    slot state bit for bit unchanged, except speculative cache entries at
    positions >= text_len, which it rewrites with the values the next
    live iteration writes there before attending."""
    side = stack["torch"]
    mod = side[0]
    eng = _engine(side, dict(num_slots=2, max_prompt_len=6, max_new_cap=10,
                             steps_per_sync=2),
                  dict(max_new_tokens=10, block_k=4,
                       cache_backend="paged", page_size=8))
    rng = np.random.default_rng(2)
    for i in range(2):
        eng.admit(mod.Request(rid=i, prompt=rng.integers(0, 97, 5),
                              max_new=1 + 6 * i), now=0.0)
    g = eng.groups[0]
    state = g.state
    step_fn = g.fns.step.fn
    one, _, _ = _single_steps(eng, state, 1)      # the plain iteration
    two, status, iters = step_fn(eng.params, _clone(state))
    assert int(iters) == 1 and bool((status & 2).any())
    _assert_state_equal(one, two)
    # the next live iteration rewrites the no-op's speculative entries:
    # after it the two caches are equal everywhere but the trash page
    one, _, _ = _single_steps(eng, one, 1)
    two, _, _ = _single_steps(eng, two, 1)
    _assert_state_equal(one, two)
    for la, lb in zip(one.caches, two.caches):
        torch.testing.assert_close(la["attn"]["pos"], lb["attn"]["pos"],
                                   rtol=0, atol=0)
        for name in ("kp", "vp"):
            torch.testing.assert_close(la["attn"][name][1:],
                                       lb["attn"][name][1:], rtol=0, atol=0)


def _clone(state):
    return jax.tree_util.tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x, state)


def _single_steps(eng, state, n):
    """``n`` one-iteration steps through a steps_per_sync=1 build of the
    same group geometry."""
    sess = eng.session
    ecfg = dataclasses.replace(eng.ecfg, steps_per_sync=1)
    fns = sess.serving_fns(ecfg)
    st = _clone(state)
    for _ in range(n):
        st, status, iters = fns.step.fn(eng.params, st)
    return st, status, iters


def _assert_state_equal(a, b):
    for name in ("tokens", "text_len", "proposals", "finished", "generated",
                 "invocations", "active", "max_new"):
        torch.testing.assert_close(getattr(a, name), getattr(b, name),
                                   rtol=0, atol=0)
    for la, lb in zip(a.caches, b.caches):
        ca, cb = la["attn"], lb["attn"]
        torch.testing.assert_close(ca["tbl"], cb["tbl"], rtol=0, atol=0)
        # committed positions (columns < text_len): same positions and,
        # through the same tables, the same K/V bytes
        cols = torch.arange(ca["pos"].shape[1])[None, :]
        committed = cols < a.text_len[:, None]
        torch.testing.assert_close(ca["pos"][committed], cb["pos"][committed],
                                   rtol=0, atol=0)
        ps = ca["kp"].shape[1]
        for r in range(a.text_len.shape[0]):
            n = int(a.text_len[r])
            pages = ca["tbl"][r, :(n + ps - 1) // ps].long()
            for name in ("kp", "vp"):
                got = cb[name][pages].reshape(-1, *cb[name].shape[2:])[:n]
                want = ca[name][pages].reshape(-1, *ca[name].shape[2:])[:n]
                torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# guards and refusals
# ---------------------------------------------------------------------------


def test_admission_guards(stack):
    side = stack["torch"]
    mod = side[0]
    eng = _engine(side, dict(num_slots=1, max_prompt_len=4, max_new_cap=8),
                  dict(max_new_tokens=8, block_k=4))
    with pytest.raises(ValueError):
        eng.admit(mod.Request(rid=0, prompt=np.zeros(9, np.int32), max_new=4))
    sched = mod.Scheduler(eng)
    with pytest.raises(ValueError):
        sched.submit(mod.Request(rid=3, prompt=np.zeros(9, np.int32),
                                 max_new=4))
    assert not sched.queue
    eng.admit(mod.Request(rid=1, prompt=np.zeros(3, np.int32), max_new=4))
    with pytest.raises(RuntimeError, match="no free slot"):
        eng.admit(mod.Request(rid=2, prompt=np.zeros(3, np.int32), max_new=4))
    with pytest.raises(ValueError, match="no slot group"):
        eng.group_for("topk")
    with pytest.raises(ValueError, match="unknown decode policy"):
        eng.group_for("no-such-policy")


@pytest.mark.parametrize("groups,match", [
    ({"exact": 1, "topk": 1}, "cover 2 slots"),
    ({"exact": 0, "topk": 3}, "at least one"),
    ([], "at least one slot group"),
])
def test_group_partition_errors(stack, groups, match):
    with pytest.raises(ValueError, match=match):
        _engine(stack["torch"], dict(num_slots=3), dict(), policies=groups)


@pytest.mark.parametrize("make", [tiny_rwkv, tiny_seq2seq])
def test_recurrent_and_encoder_decoder_are_refused(make):
    """Padded prefill is unsound for recurrent state, and the engine is
    decoder-only: both raise at construction, as the reference does."""
    tcfg = ModelConfig(**dataclasses.asdict(make()))
    params = tmodel.init(tcfg, device="meta")
    with pytest.raises(NotImplementedError):
        tserving.ContinuousBatchingEngine(params, tcfg, DecodeConfig(),
                                          tserving.EngineConfig())


def test_mesh_bundles_and_unported_policies_are_refused(stack):
    """Auxiliary bundles now serve under a mesh (a self-draft's bundle is
    the primary's sharded tree); draft_model without its bundle is
    refused, by the session and by an engine group alike."""
    from repro_torch.core.bundle import ModelBundle
    from repro_torch.launch.mesh import make_mesh

    _, params, cfg, _ = stack["torch"]
    eng = tserving.ContinuousBatchingEngine(
        params, cfg, DecodeConfig(), tserving.EngineConfig(),
        mesh=make_mesh(1, 1, device="cpu"),
        bundles={"draft": ModelBundle(params, cfg)})
    assert eng.session.aux_params["draft"] is eng.session.params
    # draft_model is ported: without its draft bundle it is refused at
    # construction, by the session and by an engine group alike
    with pytest.raises(ValueError, match="ModelBundle"):
        tserving.DecodeSession(params, cfg, DecodeConfig(),
                               policy="draft_model")
    for name in ("draft_model",):
        with pytest.raises(ValueError, match="ModelBundle"):
            tserving.ContinuousBatchingEngine(
                params, cfg, DecodeConfig(max_new_tokens=8),
                tserving.EngineConfig(num_slots=1, max_new_cap=8),
                policies={name: 1})


def test_policy_cache_key_shares_builds(stack):
    """Groups with equal policies at one geometry share one build; topk
    with another top_k keys apart."""
    _, params, cfg, _ = stack["torch"]
    sess = tserving.DecodeSession(params, cfg, DecodeConfig(max_new_tokens=8))
    ecfg = tserving.EngineConfig(num_slots=1, max_new_cap=8)
    a = sess.serving_fns(ecfg, policy="topk")
    assert sess.serving_fns(ecfg, policy="topk") is a
    from repro_torch.core.policy import resolve_policy
    other = resolve_policy(DecodeConfig(top_k=3), "topk")
    assert sess.serving_fns(ecfg, policy=other) is not a
    assert set(sess.builds.values()) == {1} and len(sess.builds) == 2
    hash(a.key)                            # keys are plain hashable tuples


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_serve_launcher_engine_and_http_demo(capsys):
    """``launch.serve --engine`` (policy groups, paged pool, disaggregated
    prefill, windows) and ``--http --http-demo`` on the CPU smoke config."""
    from repro_torch.launch import serve

    base = ["--arch", "granite-3-8b", "--device", "cpu", "--batch", "4",
            "--prompt-len", "8", "--max-new", "10"]
    out = serve.main(base + ["--engine", "--policies", "exact=2,topk_tree=2",
                             "--cache-backend", "paged", "--prefill-slots",
                             "2", "--steps-per-sync", "2"])
    assert len(out["finished"]) == 8
    assert all(v == 1 for v in out["engine"].compile_counts().values())
    assert "tok/s" in capsys.readouterr().out
    out = serve.main(base + ["--http", "--port", "0", "--http-demo"])
    assert out["demo"]["generated"] == 10
    assert "demo ok" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="--engine"):
        serve.main(base + ["--policies", "exact=4"])
    with pytest.raises(SystemExit, match="unknown policy"):
        serve.main(base + ["--engine", "--policies", "nope=4"])

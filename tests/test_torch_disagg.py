"""The port's disaggregated prefill/decode against the reference's and
against its own unified engine (twins of tests/test_disagg.py): dedicated
prefill batches, the bounded KV-handoff queue and attach into freed slots
give per-request streams equal to the unified engine under any interleaving
of queue / prefill / attach / step, with back-pressure on both bounds, one
fused device→host read per group step, and ``steps_per_sync`` windows
(fp32, CPU, bridged ``tiny_dense`` weights)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _hyp import given, settings, st  # noqa: E402
from conftest import tiny_dense  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.config import DecodeConfig as JDecodeConfig  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.config import DecodeConfig, ModelConfig  # noqa: E402

torch.set_num_threads(2)
pytestmark = pytest.mark.serving

ECFG = dict(num_slots=2, max_prompt_len=6, max_new_cap=10, prefill_slots=2,
            handoff_cap=3)


@pytest.fixture(scope="module")
def stack():
    jcfg = tiny_dense()
    jp = jmodel.init(jax.random.PRNGKey(0), jcfg)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    tp = bridge.from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                                device="cpu")
    return {"jax": (jserving, jp, jcfg, JDecodeConfig(max_new_tokens=10,
                                                      block_k=4)),
            "torch": (tserving, tp, tcfg, DecodeConfig(max_new_tokens=10,
                                                       block_k=4))}


def _engine(side, dec_kw=None, **ecfg_kw):
    mod, params, cfg, dec = side
    return mod.ContinuousBatchingEngine(
        params, cfg, dec.replace(**(dec_kw or {})),
        mod.EngineConfig(**{**ECFG, **ecfg_kw}))


@pytest.fixture(scope="module")
def disagg(stack):
    return _engine(stack["torch"])


@pytest.fixture(scope="module")
def unified(stack):
    return _engine(stack["torch"], prefill_slots=0, handoff_cap=0)


def _workload(mod, seed, n=6):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i, arrival=0.0,
                        prompt=rng.integers(0, 97, size=int(rng.integers(2, 7))),
                        max_new=int(rng.integers(3, 11)))
            for i in range(n)]


def _drive_unified(eng, reqs):
    todo, done = list(reqs), []
    while todo or eng.has_active():
        while todo and eng.free_slots():
            eng.admit(todo.pop(0), now=0.0)
        done += eng.step(now=0.0)
    return {f.rid: f for f in done}


_REF = {}


def _reference(unified_eng, seed):
    if seed not in _REF:
        _REF[seed] = _drive_unified(unified_eng, _workload(tserving, seed))
    return _REF[seed]


def _check_identical(done, ref):
    assert sorted(f.rid for f in done) == sorted(ref)
    for f in done:
        r = ref[f.rid]
        assert f.tokens.tolist() == r.tokens.tolist(), f.rid
        assert (f.generated, f.invocations) == (r.generated, r.invocations)


def _drain(eng, todo, done, now=None):
    while todo or eng.handoff_backlog() or eng.has_active():
        while todo and eng.handoff_free() > 0:
            eng.queue_prefill(todo.pop(0), now=now)
        eng.run_prefills(now=now)
        eng.attach_ready(now=now)
        if eng.has_active():
            done += eng.step(now=now)
    return done


def _interleave(eng, reqs, ops):
    todo, done = list(reqs), []
    for op in ops:
        if op == "q" and todo:
            if eng.handoff_free() <= 0:
                with pytest.raises(RuntimeError, match="handoff"):
                    eng.queue_prefill(todo[0])
            else:
                eng.queue_prefill(todo.pop(0))
        elif op == "p":
            eng.run_prefills()
        elif op == "a":
            eng.attach_ready()
        elif op == "s" and eng.has_active():
            done += eng.step()
    return _drain(eng, todo, done)


@pytest.mark.parametrize("seed", range(4))
def test_seeded_interleaving_token_identical(stack, disagg, unified, seed):
    """A seeded op sequence — (q)ueue, (p)refill, (a)ttach, (s)tep — then a
    drain: every stream equals the unified engine's."""
    ops = np.random.default_rng(100 + seed).choice(list("qqpas"), size=30)
    done = _interleave(disagg, _workload(tserving, seed), ops)
    _check_identical(done, _reference(unified, seed))
    assert all(v == 1 for v in disagg.compile_counts().values())


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 2**16),
       ops=st.lists(st.sampled_from("qqpas"), min_size=4, max_size=40))
def test_any_interleaving_token_identical(stack, disagg, unified, seed, ops):
    done = _interleave(disagg, _workload(tserving, seed), ops)
    _check_identical(done, _reference(unified, seed))
    assert all(v == 1 for v in disagg.compile_counts().values())


def _disagg_run(side, seed=3, n=4, **ecfg_kw):
    """A fixed disaggregated drive (virtual time) for the port/reference
    comparison, with its per-step host-sync accounting."""
    eng = _engine(side, **ecfg_kw)
    mod = side[0]
    todo, done = _workload(mod, seed, n), []
    before = eng.num_host_syncs
    while todo and eng.handoff_free() > 0:
        eng.queue_prefill(todo.pop(0), now=0.0)
    eng.run_prefills(now=0.0)
    eng.attach_ready(now=0.0)
    assert eng.num_host_syncs == before       # admission path is read-free
    steps = pulls = 0
    t = 0.0
    while todo or eng.handoff_backlog() or eng.has_active():
        while todo and eng.handoff_free() > 0:
            eng.queue_prefill(todo.pop(0), now=t)
        eng.run_prefills(now=t)
        eng.attach_ready(now=t)
        if eng.has_active():
            got = eng.step(now=t)
            steps += 1
            pulls += 1 if got else 0
            done += got
        t += 1.0
    assert eng.num_host_syncs - before == steps + pulls
    return eng, done


@pytest.mark.parametrize("spd", [1, 4])
def test_disagg_equals_reference(stack, spd):
    """The same drive through the reference's disaggregated engine and the
    port's: records, prefill batches, steps, admits and host reads equal."""
    jeng, jdone = _disagg_run(stack["jax"], steps_per_sync=spd)
    teng, tdone = _disagg_run(stack["torch"], steps_per_sync=spd)

    def rec(f):
        return (f.rid, f.tokens.tolist(), f.generated, f.invocations,
                f.admit_time, f.finish_time)

    assert [rec(f) for f in tdone] == [rec(f) for f in jdone]
    for name in ("num_steps", "num_admits", "num_host_syncs",
                 "num_prefill_batches", "num_attach_backpressure"):
        assert getattr(teng, name) == getattr(jeng, name), name
    assert teng.compile_counts() == jeng.compile_counts()


def test_handoff_queue_full_rejects(stack, disagg):
    reqs = _workload(tserving, seed=99, n=ECFG["handoff_cap"] + 1)
    for r in reqs[:-1]:
        disagg.queue_prefill(r)
    assert disagg.handoff_free() == 0
    with pytest.raises(RuntimeError, match="handoff"):
        disagg.queue_prefill(reqs[-1])
    disagg.run_prefills()
    assert disagg.handoff_free() == 0
    with pytest.raises(RuntimeError, match="handoff"):
        disagg.queue_prefill(reqs[-1])
    disagg.attach_ready()
    _drain(disagg, [], [])
    assert disagg.handoff_free() == ECFG["handoff_cap"]


def _attach_backpressure(side):
    mod, params, cfg, dec = side
    decp = dict(cache_backend="paged", page_size=8)
    eng = _engine(side, decp, page_pool_pages=4)
    reqs = [mod.Request(rid=i, arrival=0.0, max_new=6,
                        prompt=np.full((4,), 7 + i, np.int32))
            for i in range(2)]
    for r in reqs:
        eng.queue_prefill(r, now=0.0)
    eng.run_prefills(now=0.0)
    assert eng.attach_ready(now=0.0) == 1     # the second does not fit
    before = eng.num_attach_backpressure
    assert eng.attach_ready(now=0.0) == 0     # head-of-line wait
    assert eng.num_attach_backpressure > before
    done = []
    while eng.handoff_backlog() or eng.has_active():
        eng.attach_ready(now=0.0)
        if eng.has_active():
            done += eng.step(now=0.0)
    uref = _engine(side, decp, page_pool_pages=4, prefill_slots=0,
                   handoff_cap=0)
    sched = mod.Scheduler(uref)
    for r in reqs:
        sched.submit(dataclasses.replace(r))
    fin = []
    while not sched.drained():
        fin += sched.step(now=0.0)
    return eng, done, {f.rid: f for f in fin}


def test_attach_backpressure_page_pool(stack):
    """A page pool that fits one request: the second record waits at the
    head of the handoff queue until the first retires, and both streams
    equal the unified engine's under the same pool — and the reference's."""
    teng, tdone, tref = _attach_backpressure(stack["torch"])
    jeng, jdone, _ = _attach_backpressure(stack["jax"])
    assert sorted(f.rid for f in tdone) == [0, 1]
    _check_identical(tdone, tref)
    assert [(f.rid, f.tokens.tolist()) for f in tdone] == \
        [(f.rid, f.tokens.tolist()) for f in jdone]
    assert teng.num_attach_backpressure == jeng.num_attach_backpressure


def test_phase_timers_and_overlap(stack):
    """Host phase timers attribute wall time, and with two active groups a
    step harvests one group while the other's status is still unread."""
    _, params, cfg, dec = stack["torch"]
    eng = tserving.ContinuousBatchingEngine(
        params, cfg, dec, tserving.EngineConfig(**{**ECFG, "handoff_cap": 8}),
        policies={"exact": 1, "topk": 1})
    sched = tserving.Scheduler(eng)
    rng = np.random.default_rng(5)
    for i in range(6):
        sched.submit(tserving.Request(
            rid=i, arrival=0.0, policy=("exact", "topk")[i % 2],
            prompt=rng.integers(0, 97, size=int(rng.integers(2, 7))),
            max_new=int(rng.integers(3, 11))))
    finished = sched.run()
    assert len(finished) == 6
    assert eng.time_in_prefill > 0.0
    assert eng.time_in_decode_dispatch > 0.0
    assert eng.time_in_harvest > 0.0
    assert 0 < eng.num_overlap_harvests <= eng.num_steps


def test_windowed_decode_token_identical(stack, unified):
    """``steps_per_sync`` 3, unified and disaggregated: every stream and
    invocation count equals per-step syncing; the unified window reads the
    host less often than one iteration per read, and dispatches 3 forwards
    per group step."""
    reqs = _workload(tserving, 11, n=8)
    uref = _drive_unified(unified, [dataclasses.replace(r) for r in reqs])
    engines = {}
    for name, kw in (("one", dict(prefill_slots=0, handoff_cap=0)),
                     ("unified", dict(prefill_slots=0, handoff_cap=0,
                                      steps_per_sync=3)),
                     ("disagg", dict(steps_per_sync=3))):
        eng = _engine(stack["torch"], **kw)
        sched = tserving.Scheduler(eng)
        for r in reqs:
            sched.submit(dataclasses.replace(r))
        _check_identical(sched.run(), uref)
        assert all(v == 1 for v in eng.compile_counts().values())
        engines[name] = eng
    assert engines["unified"].num_host_syncs < engines["one"].num_host_syncs
    for name in ("unified", "disagg"):
        eng = engines[name]
        assert eng.num_forwards % 3 == 0
        assert eng.num_forwards > eng.num_steps


def test_queue_prefill_requires_disagg_mode(unified):
    with pytest.raises(RuntimeError, match="disaggregated"):
        unified.queue_prefill(tserving.Request(rid=0, max_new=4,
                                               prompt=np.ones(3, np.int32)))

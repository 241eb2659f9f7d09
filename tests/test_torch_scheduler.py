"""The port's scheduler against the reference's (twins of
tests/test_scheduler.py): deterministic fcfs / sjf / priority /
back-pressure ordering, deadline preemption whose stitched continuations
keep the uninterrupted tokens, and page-pool back-pressure requeues, all
with the same virtual ``now=`` times through both stacks on bridged
``tiny_dense`` weights (fp32, CPU)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from conftest import tiny_dense  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.config import DecodeConfig as JDecodeConfig  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.config import DecodeConfig, ModelConfig  # noqa: E402
from repro_torch.core import decode as tdecode  # noqa: E402
from repro_torch.models import cache as tcache  # noqa: E402

torch.set_num_threads(2)
pytestmark = pytest.mark.serving

# ---------------------------------------------------------------------------
# pure queue ordering (no device work)
# ---------------------------------------------------------------------------


class _OneGroupEngine:
    class _G:
        name = "exact"

    ecfg = tserving.EngineConfig(num_slots=2, max_prompt_len=32,
                                 max_new_cap=16)

    def group_for(self, policy):
        return self._G


def _mk(rid, max_new, arrival, **kw):
    return tserving.Request(rid=rid, prompt=np.arange(1, 4), max_new=max_new,
                            arrival=arrival, **kw)


def _drain_order(sched, now=100.0):
    order = []
    while True:
        r = sched._pop_next(now, group="exact")
        if r is None:
            return order
        order.append(r.rid)


def _reqs():
    return [_mk(3, 8, 0.0), _mk(1, 8, 0.0), _mk(2, 8, 1.0),
            _mk(0, 4, 2.0), _mk(4, 12, 0.0), _mk(5, 4, 2.0)]


def test_sjf_tie_break_deterministic():
    rng = np.random.default_rng(0)
    reqs = _reqs()
    for _ in range(4):
        sched = tserving.Scheduler(_OneGroupEngine(), policy="sjf")
        for i in rng.permutation(len(reqs)):
            sched.submit(reqs[int(i)])
        assert _drain_order(sched) == [0, 5, 1, 3, 2, 4]


def test_fcfs_order():
    sched = tserving.Scheduler(_OneGroupEngine(), policy="fcfs")
    for r in _reqs():
        sched.submit(r)
    assert _drain_order(sched) == [1, 3, 4, 2, 0, 5]


def test_priority_then_backpressure_beat_sjf_size():
    a = _mk(0, 4, 0.0)
    b = _mk(1, 16, 5.0)
    b.backpressured = 1
    c = _mk(2, 2, 6.0, priority=1)
    sched = tserving.Scheduler(_OneGroupEngine(), policy="sjf")
    for r in (a, b, c):
        sched.submit(r)
    assert _drain_order(sched) == [2, 1, 0]


def test_future_arrivals_invisible():
    sched = tserving.Scheduler(_OneGroupEngine(), policy="fcfs")
    sched.submit(_mk(0, 4, 10.0))
    sched.submit(_mk(1, 4, 0.0))
    assert sched._pop_next(5.0, group="exact").rid == 1
    assert sched._pop_next(5.0, group="exact") is None
    assert sched._pop_next(10.0, group="exact").rid == 0


def test_submit_rejects_bad_requests():
    sched = tserving.Scheduler(_OneGroupEngine())
    with pytest.raises(ValueError, match="outside"):
        sched.submit(tserving.Request(rid=0, prompt=np.zeros((0,), np.int32),
                                      max_new=4))
    with pytest.raises(ValueError, match="outside"):
        sched.submit(tserving.Request(rid=1, prompt=np.arange(33), max_new=4))
    with pytest.raises(ValueError, match="not in"):
        tserving.Scheduler(_OneGroupEngine(), policy="priority")


# ---------------------------------------------------------------------------
# engine-backed: preemption and back-pressure, the port against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stack():
    jcfg = tiny_dense()
    jp = jmodel.init(jax.random.PRNGKey(0), jcfg)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    tp = bridge.from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                                device="cpu")
    return {"jax": (jserving, jp, jcfg, JDecodeConfig(max_new_tokens=16,
                                                      block_k=4)),
            "torch": (tserving, tp, tcfg, DecodeConfig(max_new_tokens=16,
                                                       block_k=4))}


def _drive(sched, start, step_s=1.0, max_steps=200):
    now, fin = start, []
    while not sched.drained():
        assert now < start + max_steps * step_s, "scheduler did not drain"
        fin += sched.step(now=now)
        now += step_s
    return fin


def _record(f):
    return (f.rid, f.prompt_len, f.tokens.tolist(), f.generated,
            f.invocations, round(f.mean_accepted, 6), f.admit_time,
            f.finish_time, f.preempted)


def _alone(stack, prompt, max_new):
    _, params, cfg, dec = stack["torch"]
    toks, stats = tdecode.bpd_decode(
        params, cfg, dec.replace(max_new_tokens=max_new),
        {"tokens": torch.tensor(prompt)[None]})
    return toks[0, len(prompt):int(stats["text_len"][0])].tolist()


def _preempt_run(side, seed, priority, deadline):
    mod, params, cfg, dec = side
    eng = mod.ContinuousBatchingEngine(
        params, cfg, dec, mod.EngineConfig(num_slots=2, max_prompt_len=24,
                                           max_new_cap=16))
    sched = mod.Scheduler(eng)
    rng = np.random.default_rng(seed)
    prompts = {i: rng.integers(0, 97, size=n) for i, n in enumerate((6, 5, 4))}
    sched.submit(mod.Request(rid=0, prompt=prompts[0], max_new=16,
                             arrival=0.0))
    sched.submit(mod.Request(rid=1, prompt=prompts[1], max_new=16,
                             arrival=0.0))
    sched.submit(mod.Request(rid=2, prompt=prompts[2], max_new=4, arrival=5.0,
                             priority=priority, deadline=deadline))
    sched.step(now=0.0)
    sched.step(now=1.0)
    fin = _drive(sched, start=5.0)
    return sched, eng, fin, prompts


@pytest.mark.parametrize("case", ["preempt", "equal_priority", "not_at_risk"])
def test_preemption_equals_reference(stack, case):
    """An urgent past-deadline request evicts a strictly-lower-priority
    victim, which re-admits as a continuation and retires with the tokens
    of an uninterrupted decode; an equal-priority or far-deadline request
    waits.  Records, preemptions and counts equal the reference's."""
    seed, priority, deadline = {"preempt": (7, 1, 5.0),
                                "equal_priority": (11, 0, 5.0),
                                "not_at_risk": (13, 1, 1e9)}[case]
    jsched, jeng, jfin, _ = _preempt_run(stack["jax"], seed, priority,
                                         deadline)
    tsched, teng, tfin, prompts = _preempt_run(stack["torch"], seed, priority,
                                               deadline)
    assert [_record(f) for f in tfin] == [_record(f) for f in jfin]
    assert tsched.preemptions == jsched.preemptions
    assert (teng.num_steps, teng.num_admits, teng.num_host_syncs) == \
        (jeng.num_steps, jeng.num_admits, jeng.num_host_syncs)
    assert teng.compile_counts() == jeng.compile_counts()
    assert tsched.preemptions == (1 if case == "preempt" else 0)
    for f in tfin:
        want = _alone(stack, prompts[f.rid], 4 if f.rid == 2 else 16)
        assert f.tokens.tolist() == want, f.rid
        assert f.prompt_len == len(prompts[f.rid])


def _backpressure_run(side):
    mod, params, cfg, dec = side
    decp = dec.replace(cache_backend="paged", page_size=8)
    ecfg = mod.EngineConfig(num_slots=2, max_prompt_len=16, max_new_cap=16)
    context_len = cfg.num_meta_tokens + ecfg.max_prompt_len + ecfg.max_new_cap
    pool = 1 + tcache.pages_per_row(context_len, decp.block_k, decp.page_size)
    eng = mod.ContinuousBatchingEngine(
        params, cfg, decp, dataclasses.replace(ecfg, page_pool_pages=pool))
    sched = mod.Scheduler(eng, policy="sjf")
    rng = np.random.default_rng(17)
    prompts = {i: rng.integers(0, 97, size=8) for i in range(4)}
    for rid, mn, t in ((0, 16, 0.0), (1, 14, 0.0), (2, 12, 1.0),
                       (3, 12, 1.0)):
        sched.submit(mod.Request(rid=rid, prompt=prompts[rid], max_new=mn,
                                 arrival=t))
    return sched, eng, _drive(sched, start=0.0), prompts


def test_backpressure_requeue_order_equals_reference(stack):
    """A tight paged pool bounces the large request; its backpressured flag
    keeps later small sjf requests from leapfrogging it; everyone finishes
    with the tokens of the dense run-to-completion decode."""
    jsched, jeng, jfin, _ = _backpressure_run(stack["jax"])
    tsched, teng, tfin, prompts = _backpressure_run(stack["torch"])
    assert [_record(f) for f in tfin] == [_record(f) for f in jfin]
    assert tsched.backpressure_events == jsched.backpressure_events >= 2
    by_rid = {f.rid: f for f in tfin}
    assert by_rid[1].admit_time == 0.0 and by_rid[0].queue_delay > 0
    assert by_rid[0].admit_time < min(by_rid[2].admit_time,
                                      by_rid[3].admit_time)
    budgets = {0: 16, 1: 14, 2: 12, 3: 12}
    for f in tfin:
        assert f.tokens.tolist() == _alone(stack, prompts[f.rid],
                                           budgets[f.rid])


def test_aggregate_stats_equal_reference(stack):
    _, _, jfin, _ = _preempt_run(stack["jax"], 7, 1, 5.0)
    _, _, tfin, _ = _preempt_run(stack["torch"], 7, 1, 5.0)
    assert tserving.aggregate_stats(tfin, 2.0) == \
        jserving.aggregate_stats(jfin, 2.0)

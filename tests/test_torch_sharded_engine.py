"""The serving engine, its scheduler and the HTTP server on process meshes
of CPU ranks against the reference's single-device engine, in fp32 on
bridged weights (``conftest.tiny_dense`` and granite-3-8b's smoke config).
The reference's own mesh engine does not run under this JAX (its sharded
tests fail on Explicit mesh axes), so the sharded port is held against:

  * the reference's ``ContinuousBatchingEngine(mesh=None)`` under its
    ``Scheduler``, on the same requests at the same virtual ``now=`` times:
    every rank's finish records (tokens, ``generated``, invocations,
    policy, admit and finish times) and the iteration, admission,
    host-read and prefill-batch counters equal the reference's, and the
    forwards and copy-on-write hits the port's single-device engine's;
  * the reference's single-device, single-policy decode of each request
    (``tests/test_policy_equivalence.py::_check_all``).

The ranks (gloo processes, ``launch.mesh.spawn``) are spawned once for the
module (``_torch_engine_ranks.run``), on (1, 2), (2, 1), (2, 2) and the pod
meshes (2, 1, 2) and (2, 2, 1); the references run in this process
meanwhile.  Cases: the unified engine on the dense cache with requests
admitted mid-decode, on the paged cache (copy-on-write hits, allocator
state equal on every rank) and on a pool too small for every admission
(back-pressure, the followers' replays finding it full with rank 0's),
the disaggregated engine on the pod meshes
(the prefill→decode handoff over ``pod``), windows of 4 iterations at (2,
1) (the window's ``go`` is mesh-wide), followers whose clocks are skewed
(records are rank 0's: plans, not clocks), the HTTP server at (1, 2)
against the reference's server, the ``divisible`` refusal, and a rank that
raises mid-serve.  The HTTP case idles first, its rank 0 sending
heartbeats.
"""
import asyncio
import dataclasses
import json
import multiprocessing
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_engine_ranks as ranks  # noqa: E402
from conftest import tiny_dense  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.config import DecodeConfig as JDecodeConfig  # noqa: E402
from repro.config import get_config as jget_config  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serving.session import DecodeSession as JDecodeSession  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.config import DecodeConfig, ModelConfig  # noqa: E402
from repro_torch.launch.mesh import Mesh, spawn  # noqa: E402

SPAWN_TIMEOUT = 400.0
CONFIGS = {"tiny_dense": lambda: tiny_dense(),
           "granite_smoke": lambda: jget_config(
               "granite-3-8b", smoke=True).replace(dtype="float32")}
REFERENCES = {      # reference run -> the cases held against it
    "unified dense tiny": ["unified dense tiny (1, 2)",
                           "unified dense tiny (2, 1)",
                           "unified dense tiny (2, 2)"],
    "unified dense granite": ["unified dense granite (1, 2)",
                              "unified dense granite (2, 1)"],
    "windowed tiny": ["windowed tiny (2, 1)"],
    "unified paged tiny": ["unified paged tiny (2, 2)"],
    "paged back-pressure tiny": ["paged back-pressure tiny (1, 2)"],
    "disaggregated tiny": ["disaggregated tiny (2, 1, 2)",
                           "disaggregated tiny (2, 2, 1)"],
}
CASE_REF = {case: ref for ref, cases in REFERENCES.items() for case in cases}


def _counters(engine):
    return {"steps": engine.num_steps, "admits": engine.num_admits,
            "prefill_batches": engine.num_prefill_batches,
            "host_syncs": engine.num_host_syncs}


def _reference_run(weights, case):
    """The reference's and the port's single-device engines on ``case``'s
    configs: (records, counters) each."""
    name = ranks.CASES[case][0]
    dec_kw, ecfg_kw = ranks.configs(case)
    out = {}
    for side, (mod, params, cfg, dcls) in weights[name].items():
        engine = mod.ContinuousBatchingEngine(
            params, cfg, dcls(**dec_kw), mod.EngineConfig(**ecfg_kw),
            policies=ranks.GROUPS)
        sched = mod.Scheduler(engine)
        done = ranks.drive(sched, ranks.workload(), mod.Request)
        out[side + " backpressure"] = sched.backpressure_events
        counts = _counters(engine)
        if side == "torch":     # the reference counts neither
            counts = dict(counts, forwards=engine.num_forwards, cow_hits={
                g.name: g.pages.cow_hits for g in engine.groups
                if g.pages is not None})
        out[side] = ([ranks.record(f) for f in done], counts)
    return out


def _single_policy(weights):
    """The reference's single-device, single-policy decode of each request
    of the workload: {rid: (tokens, generated)}.  Requests of one policy
    and prompt length decode as one batch under per-row budgets (rows never
    mix), so each (policy, length) compiles once."""
    _, jp, jcfg, _ = weights["tiny_dense"]["jax"]
    dec = JDecodeConfig(max_new_tokens=ranks.MAX_NEW, block_k=ranks.BLOCK_K)
    batches = {}
    for rid, prompt, max_new, _, policy in ranks.workload():
        batches.setdefault((policy, len(prompt)), []).append(
            (rid, prompt, min(max_new, ranks.MAX_NEW)))
    sessions = {pol: JDecodeSession(jp, jcfg, dec, policy=pol)
                for pol, _ in batches}
    out = {}
    for (policy, plen), reqs in batches.items():
        toks, st = sessions[policy].decode(
            {"tokens": jnp.asarray(np.stack([r[1] for r in reqs]))},
            max_new_rows=jnp.asarray([r[2] for r in reqs], jnp.int32))
        for i, (rid, _, _) in enumerate(reqs):
            n = int(st["text_len"][i])
            out[rid] = (np.asarray(toks[i, plen:n]).tolist(),
                        int(st["generated"][i]))
    return out


class _Live:
    """The reference's HTTP server, its event loop in a thread."""

    def __init__(self, weights):
        mod, params, cfg, dcls = weights["tiny_dense"]["jax"]
        engine = mod.ContinuousBatchingEngine(
            params, cfg, dcls(**ranks.HTTP_DEC),
            mod.EngineConfig(**ranks.HTTP_ENGINE))
        self.srv = mod.HTTPServer(mod.Frontend(mod.Scheduler(engine),
                                               max_queue=4), port=0)
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        self._call(self.srv.start())

    def _call(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout=300)

    def answers(self):
        try:
            return [ranks._fetch(self.srv.port, b) for b in ranks.HTTP_REQUESTS]
        finally:
            self._call(self.srv.stop())
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(timeout=10)


@pytest.fixture(scope="module")
def runs():
    """(references, per-rank results [{case: summary}])."""
    payload = {"configs": {}}
    weights = {}
    for name, make in CONFIGS.items():
        jcfg = make()
        jp = jmodel.init(jax.random.PRNGKey(7), jcfg)
        np_params = jax.tree_util.tree_map(np.asarray, jp)
        payload["configs"][name] = (dataclasses.asdict(jcfg), np_params)
        tcfg = ModelConfig(**dataclasses.asdict(jcfg))
        weights[name] = {
            "jax": (jserving, jp, jcfg, JDecodeConfig),
            "torch": (tserving, bridge.from_jax_params(np_params, tcfg,
                                                       device="cpu"),
                      tcfg, DecodeConfig)}
    sharded = {}

    def run_ranks():
        try:
            sharded["ranks"] = spawn(ranks.run, 2, 2, args=(payload,),
                                     device="cpu", timeout=SPAWN_TIMEOUT)
        except BaseException as exc:            # raised in the test thread
            sharded["error"] = exc

    worker = threading.Thread(target=run_ranks, name="mesh-ranks")
    worker.start()
    try:
        ref = {r: _reference_run(weights, cases[0])
               for r, cases in REFERENCES.items()}
        ref["single policy"] = _single_policy(weights)
        ref["http"] = _Live(weights).answers()
    finally:
        worker.join(timeout=SPAWN_TIMEOUT + 30)
    assert not worker.is_alive(), "the spawned ranks outlived their time limit"
    if "error" in sharded:
        raise sharded["error"]
    return ref, sharded["ranks"]


def _ranks_of(runs, case):
    _, per_rank = runs
    return [r[case] for r in per_rank if case in r]


def _size(case):
    p, d, m = ranks.CASES[case][1]
    return p * d * m


@pytest.mark.parametrize("case", list(ranks.CASES))
def test_records_equal_the_reference_engine(runs, case):
    """Every rank's finish records equal the reference single-device
    engine's, record for record, in finish order."""
    ref, _ = runs
    want, _ = ref[CASE_REF[case]]["jax"]
    got = _ranks_of(runs, case)
    assert len(got) == _size(case)
    assert len(want) == len(ranks.workload())
    for res in got:
        assert res["records"] == want


@pytest.mark.parametrize("case", list(ranks.CASES))
def test_counters_equal_the_reference_engine(runs, case):
    """Iterations, admissions, host reads and prefill batches equal the
    reference's on every rank, forwards and copy-on-write hits the port's
    single-device engine's, and every serving function is built once."""
    ref, _ = runs
    _, jcounts = ref[CASE_REF[case]]["jax"]
    _, tcounts = ref[CASE_REF[case]]["torch"]
    for res in _ranks_of(runs, case):
        counts = dict(res["counters"])
        assert counts.pop("forwards") == tcounts["forwards"]
        assert counts.pop("cow_hits") == tcounts["cow_hits"]
        builds = counts.pop("builds")
        assert builds and set(builds.values()) == {1}
        assert counts == jcounts


def test_requests_equal_their_single_policy_decodes(runs):
    """Each request served at (2, 2) decodes as the reference's
    single-device, single-policy session decodes it alone."""
    ref, _ = runs
    alone = ref["single policy"]
    for res in _ranks_of(runs, "unified dense tiny (2, 2)"):
        for rid, tokens, generated, *_ in res["records"]:
            assert (tokens, generated) == alone[rid]


def test_paged_pool_hits_and_allocators_agree(runs):
    """The paged engine makes copy-on-write hits, and every rank's
    allocators hold their invariants and one state, drained."""
    got = _ranks_of(runs, "unified paged tiny (2, 2)")
    hits = got[0]["counters"]["cow_hits"]
    assert hits and all(n > 0 for n in hits.values())
    for res in got:
        assert res["pages"] == got[0]["pages"]
        assert all(state[-1] == 0 for state in res["pages"].values())


def test_a_full_pool_backpressures_as_on_one_device(runs):
    """With 7 pages a group, admissions find the pool full: rank 0's
    scheduler backs off as the reference's does, the follower's replays
    find it full with rank 0's, and both ranks' allocators end in one
    state."""
    ref, _ = runs
    want = ref["paged back-pressure tiny"]["jax backpressure"]
    assert want > 0
    assert ref["paged back-pressure tiny"]["torch backpressure"] == want
    got = _ranks_of(runs, "paged back-pressure tiny (1, 2)")
    assert got[0]["backpressure"] == want
    assert got[1]["pages"] == got[0]["pages"]
    assert got[1]["plans"] == got[0]["plans"]


@pytest.mark.parametrize("case", ["disaggregated tiny (2, 1, 2)",
                                  "disaggregated tiny (2, 2, 1)"])
def test_pod_meshes_hand_prefills_over_pod(runs, case):
    """The disaggregated engine prefills in batches, each pod its rows,
    and hands them to every rank over ``pod``.  At (2, 1, 2) the groups of
    2 slots shard over pod×data; at (2, 2, 1) they do not divide it and
    shard over ``data`` alone, replicated over ``pod``."""
    got = _ranks_of(runs, case)
    for res in got:
        assert res["counters"]["prefill_batches"] > 0
        handoffs, nbytes = res["handoff"]
        assert handoffs == res["counters"]["prefill_batches"] and nbytes > 0
    # each rank keeps one slot of each group of 2: slot 0 on pod 0 or data
    # 0, slot 1 on the other
    slots = [tuple((s.start, s.stop) for s in res["local"]) for res in got]
    assert len(got) == 4 and set(slots) == {((0, 1), (0, 1)),
                                            ((1, 2), (1, 2))}


def test_windows_count_the_iterations_of_one_device(runs):
    """With 4 iterations a step at (2, 1), the iterations that did work are
    one device's: the window stops on a row harvestable on any rank."""
    ref, _ = runs
    _, jcounts = ref["windowed tiny"]["jax"]
    _, tcounts = ref["windowed tiny"]["torch"]
    for res in _ranks_of(runs, "windowed tiny (2, 1)"):
        assert res["counters"]["steps"] == jcounts["steps"]
        assert res["counters"]["forwards"] == tcounts["forwards"]
        assert res["counters"]["forwards"] > res["counters"]["steps"]


def test_followers_replay_plans_not_clocks(runs):
    """Followers whose clocks run 1000 s ahead and whose steps sleep make
    rank 0's records, times included, under a scheduler on a real clock."""
    got = _ranks_of(runs, "skewed clock (2, 1)")
    assert len(got) == 2 and len(got[0]) == len(ranks.workload())
    assert got[1] == got[0]


def test_http_over_a_model_mesh_equals_the_reference_server(runs):
    """An SSE stream and a JSON response of the HTTP server at (1, 2) equal
    the reference server's; the stream's tokens are its done payload's, and
    the follower's records are rank 0's."""
    ref, _ = runs
    got = _ranks_of(runs, "http (1, 2)")
    leader, follower = got
    (s_status, s_body), (j_status, j_body) = leader["answers"]
    (rs_status, rs_body), (rj_status, rj_body) = ref["http"]
    assert s_status == j_status == rs_status == rj_status == 200
    events = [(blk.split("\n")[0][7:], json.loads(blk.split("\n")[1][6:]))
              for blk in s_body.strip().split("\n\n")]
    ref_events = [(blk.split("\n")[0][7:], json.loads(blk.split("\n")[1][6:]))
                  for blk in rs_body.strip().split("\n\n")]
    toks = [t for ev, d in events if ev == "token" for t in d["tokens"]]
    done = events[-1][1]
    ref_done = ref_events[-1][1]
    assert events[-1][0] == "done" and toks == done["tokens"]
    assert done["tokens"] == ref_done["tokens"]
    assert done["generated"] == ref_done["generated"]
    answer, ref_answer = json.loads(j_body), json.loads(rj_body)
    assert answer["tokens"] == ref_answer["tokens"]
    assert answer["invocations"] == ref_answer["invocations"]
    assert follower["records"] == leader["records"]
    assert len(leader["records"]) == 2
    # an idle half second at a heartbeat every 0.05 s; every plan replayed
    assert leader["idle_plans"] >= 3
    assert follower["plans"] == leader["plans"]


def test_slots_that_do_not_divide_the_data_axis_are_refused():
    cfg = ModelConfig(**dataclasses.asdict(tiny_dense()))
    from repro_torch.models import model as tmodel

    params = tmodel.init(cfg, seed=0, device="cpu")
    layout = Mesh(2, 1, device="cpu")        # a layout: nothing communicated
    with pytest.raises(ValueError, match="divisible"):
        tserving.ContinuousBatchingEngine(
            params, cfg, DecodeConfig(max_new_tokens=8),
            tserving.EngineConfig(num_slots=3, max_new_cap=8), mesh=layout)
    with pytest.raises(ValueError, match="divisible"):
        tserving.ContinuousBatchingEngine(
            params, cfg, DecodeConfig(max_new_tokens=8),
            tserving.EngineConfig(num_slots=4, max_new_cap=8), mesh=layout,
            policies={"exact": 3, "topk_tree": 1})


def test_a_rank_failing_mid_serve_fails_the_spawn():
    """A follower that raises in its third step fails the spawn with its
    traceback, and no rank is left running."""
    payload = {"configs": {"tiny_dense": (
        dataclasses.asdict(tiny_dense()),
        jax.tree_util.tree_map(np.asarray, jmodel.init(
            jax.random.PRNGKey(7), tiny_dense())))}}
    with pytest.raises(RuntimeError, match="rank 1 failed") as err:
        spawn(ranks.fail_mid_serve, 1, 2, args=(payload,), device="cpu",
              timeout=120)
    assert "told to fail mid-serve" in str(err.value)
    assert not [p for p in multiprocessing.active_children()
                if p.name.startswith("mesh-rank")]

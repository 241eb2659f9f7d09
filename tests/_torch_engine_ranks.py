"""What each spawned rank of ``test_torch_sharded_engine.py`` runs.  A
module of its own (torch and the port only, no JAX), so that a rank
imports nothing of the reference.

``run`` is spawned once on a (2, 2) mesh of 4 CPU ranks.  Every rank makes
every mesh of the module, in one order: the (1, 2) pair of ranks 0, 1, the
(2, 1) pair of ranks 2, 3, and the pod meshes (2, 1, 2) and (2, 2, 1) over
all four.  The pairs run side by side, then the (2, 2) and the pod meshes
take all four.  On each mesh the ranks bridge the reference's weights into
their blocks and serve ``workload``'s requests through the sharded engine:
rank 0 runs the scheduler on a virtual clock, the others replay its plans
(``ContinuousBatchingEngine.follow``).  ``run`` returns {case: this rank's
``summary``} for every case of the meshes it belongs to.
"""
import asyncio
import http.client
import json
import threading
import time

import numpy as np
import torch

from repro_torch import bridge, serving
from repro_torch.config import DecodeConfig, ModelConfig
from repro_torch.launch.mesh import make_mesh

MAX_NEW, BLOCK_K, PROMPT_CAP = 12, 4, 12
GROUPS = {"exact": 2, "topk_tree": 2}
# case -> (config, mesh (P, D, M), DecodeConfig keywords, EngineConfig
# keywords); the meshes of one pair run side by side
CASES = {
    "unified dense tiny (1, 2)": ("tiny_dense", (1, 1, 2), {}, {}),
    "unified dense granite (1, 2)": ("granite_smoke", (1, 1, 2), {}, {}),
    "paged back-pressure tiny (1, 2)": ("tiny_dense", (1, 1, 2),
                                        {"cache_backend": "paged",
                                         "page_size": 8},
                                        {"page_pool_pages": 7}),
    "unified dense tiny (2, 1)": ("tiny_dense", (1, 2, 1), {}, {}),
    "unified dense granite (2, 1)": ("granite_smoke", (1, 2, 1), {}, {}),
    "windowed tiny (2, 1)": ("tiny_dense", (1, 2, 1), {},
                             {"steps_per_sync": 4}),
    "unified dense tiny (2, 2)": ("tiny_dense", (1, 2, 2), {}, {}),
    "unified paged tiny (2, 2)": ("tiny_dense", (1, 2, 2),
                                  {"cache_backend": "paged", "page_size": 8},
                                  {}),
    "disaggregated tiny (2, 1, 2)": ("tiny_dense", (2, 1, 2), {},
                                     {"prefill_slots": 2, "handoff_cap": 4}),
    "disaggregated tiny (2, 2, 1)": ("tiny_dense", (2, 2, 1), {},
                                     {"prefill_slots": 2, "handoff_cap": 4}),
}
HTTP_REQUESTS = ({"prompt": [5, 6, 7, 8, 9], "max_new": 12, "stream": True},
                 {"prompt": [11, 12, 13], "max_new": 10, "stream": False})
HTTP_ENGINE = dict(num_slots=2, max_prompt_len=24, max_new_cap=16)
HTTP_DEC = dict(max_new_tokens=16, block_k=BLOCK_K)


def workload():
    """The module's 10 requests: (rid, prompt, max_new, arrival, policy).
    Six arrive at virtual time 0, four later, mid-flight; requests 6-9
    repeat the first 9 tokens of an earlier prompt of their group, so on
    pages of 8 their first page is a copy-on-write hit.  Prompts are 9 or
    12 tokens long (few shapes for the reference to compile)."""
    rng = np.random.default_rng(31)
    out = []
    for rid in range(10):
        policy = ("exact", "topk_tree")[rid % 2]
        if rid < 6:
            prompt = rng.integers(0, 97, size=(9, 12)[rid // 2 % 2])
        else:
            prompt = np.concatenate([out[rid - 6][1][:9],
                                     rng.integers(0, 97, size=3)])
        arrival = 0.0 if rid < 6 else float(rid - 3)
        out.append((rid, prompt.astype(np.int32),
                    int(rng.integers(4, MAX_NEW + 1)), arrival, policy))
    return out


def configs(case: str):
    """(DecodeConfig keywords, EngineConfig keywords) of ``case``."""
    _, _, dec_kw, ecfg_kw = CASES[case]
    return (dict(max_new_tokens=MAX_NEW, block_k=BLOCK_K, **dec_kw),
            dict(num_slots=sum(GROUPS.values()), max_prompt_len=PROMPT_CAP,
                 max_new_cap=MAX_NEW, **ecfg_kw))


def drive(sched, requests, make_request):
    """Submit ``requests`` and step ``sched`` on a virtual clock, one
    scheduler step a second, until it drains: the finished records."""
    for rid, prompt, max_new, arrival, policy in requests:
        sched.submit(make_request(rid=rid, prompt=prompt, max_new=max_new,
                                  arrival=arrival, policy=policy))
    now, done = 0.0, []
    while not sched.drained():
        assert now < 500, "the scheduler did not drain"
        done += sched.step(now=now)
        now += 1.0
    return done


def record(f):
    return (f.rid, f.tokens.tolist(), f.generated, f.invocations, f.policy,
            f.admit_time, f.finish_time)


def counters(engine):
    """The counters a sharded engine must share with one device's."""
    return {"steps": engine.num_steps, "forwards": engine.num_forwards,
            "admits": engine.num_admits,
            "prefill_batches": engine.num_prefill_batches,
            "host_syncs": engine.num_host_syncs,
            "cow_hits": {g.name: g.pages.cow_hits for g in engine.groups
                         if g.pages is not None},
            "builds": engine.compile_counts()}


def allocators(engine):
    """Each paged group's allocator state, and whether its invariants
    hold."""
    out = {}
    for g in engine.groups:
        if g.pages is None:
            continue
        a = g.pages
        a.check_invariants()
        out[g.name] = (list(a.free), sorted(a.refcount.items()),
                       sorted(a.prefix_map.items()), list(a.reclaimable),
                       sorted(a.slot_pages.items()), a.live_pages())
    return out


def engine_for(mesh, payload, name, dec_kw, ecfg_kw):
    cfg_dict, np_params = payload["configs"][name]
    cfg = ModelConfig(**cfg_dict)
    params = bridge.from_jax_params(np_params, cfg, device="cpu", mesh=mesh)
    return serving.ContinuousBatchingEngine(
        params, cfg, DecodeConfig(**dec_kw), serving.EngineConfig(**ecfg_kw),
        mesh=mesh, policies=GROUPS)


def serve_case(mesh, payload, case):
    """One case on ``mesh``: rank 0 schedules, the others follow; this
    rank's records, counters, allocator states and handoff counts."""
    name = CASES[case][0]
    dec_kw, ecfg_kw = configs(case)
    engine = engine_for(mesh, payload, name, dec_kw, ecfg_kw)
    backpressure = None
    if mesh.index == 0:
        sched = serving.Scheduler(engine)
        done = drive(sched, workload(), serving.Request)
        engine.release_followers()
        backpressure = sched.backpressure_events
    else:
        done = engine.follow()
    sess = engine.session
    return {"records": [record(f) for f in done],
            "counters": counters(engine), "pages": allocators(engine),
            "handoff": (sess.handoffs, sess.handoff_bytes),
            "local": [g.fns.local for g in engine.groups],
            "plans": engine.num_plans, "backpressure": backpressure}


def skewed_clock(mesh, payload):
    """Rank 0 schedules on its real clock (``Scheduler.run``, arrivals in
    the near future); every other rank's clock is 1000 s ahead and each of
    its replays sleeps first.  Returns this rank's records."""
    dec_kw, ecfg_kw = configs("unified dense tiny (2, 1)")
    engine = engine_for(mesh, payload, "tiny_dense", dec_kw, ecfg_kw)
    if mesh.index == 0:
        sched = serving.Scheduler(engine)
        t0 = time.monotonic()
        for rid, prompt, max_new, arrival, policy in workload():
            sched.submit(serving.Request(rid=rid, prompt=prompt,
                                         max_new=max_new,
                                         arrival=t0 + 0.05 * arrival,
                                         policy=policy))
        done = sched.run()
        engine.release_followers()
    else:
        real, step = time.monotonic, engine.step
        time.monotonic = lambda: real() + 1000.0

        def slow_step(*args, **kwargs):
            time.sleep(0.01)
            return step(*args, **kwargs)

        engine.step = slow_step
        try:
            done = engine.follow()
        finally:
            time.monotonic = real
    return [record(f) for f in done]


def _fetch(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request("POST", "/v1/generate", body=json.dumps(body))
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    return resp.status, raw.decode()


def http_case(mesh, payload):
    """The HTTP server over ``mesh``: rank 0 idles for half a second with
    a heartbeat every 0.05 s, then serves ``HTTP_REQUESTS`` on 127.0.0.1
    (an SSE stream, then a JSON response) and returns their (status,
    body) and the plans it sent while idle; the others replay its
    plans."""
    cfg_dict, np_params = payload["configs"]["tiny_dense"]
    cfg = ModelConfig(**cfg_dict)
    params = bridge.from_jax_params(np_params, cfg, device="cpu", mesh=mesh)
    engine = serving.ContinuousBatchingEngine(
        params, cfg, DecodeConfig(**HTTP_DEC),
        serving.EngineConfig(**HTTP_ENGINE), mesh=mesh)
    if mesh.index:
        return {"records": [record(f) for f in engine.follow()],
                "plans": engine.num_plans}
    heartbeat = serving.engine.HEARTBEAT_S
    serving.engine.HEARTBEAT_S = 0.05
    srv = serving.HTTPServer(serving.Frontend(serving.Scheduler(engine),
                                              max_queue=4), port=0)
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def call(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout=300)

    call(srv.start())
    try:
        before = engine.num_plans
        time.sleep(0.5)
        idle_plans = engine.num_plans - before
        answers = [_fetch(srv.port, body) for body in HTTP_REQUESTS]
    finally:
        call(srv.stop())
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=30)
        serving.engine.HEARTBEAT_S = heartbeat
    engine.release_followers()
    return {"answers": answers, "idle_plans": idle_plans,
            "plans": engine.num_plans,
            "records": [record(f) for f in srv.frontend.scheduler.finished]}


@torch.no_grad()
def run(mesh22, payload):
    """Every case on every mesh this rank belongs to (the meshes are made
    first, by every rank, in one order)."""
    meshes = {(1, 1, 2): make_mesh(1, 2, device="cpu", ranks=(0, 1)),
              (1, 2, 1): make_mesh(2, 1, device="cpu", ranks=(2, 3)),
              (1, 2, 2): mesh22,
              (2, 1, 2): make_mesh(1, 2, pod=2, device="cpu"),
              (2, 2, 1): make_mesh(2, 1, pod=2, device="cpu")}
    out = {}
    side = meshes[(1, 1, 2)] or meshes[(1, 2, 1)]
    for case, (_, shape, _, _) in CASES.items():
        if shape[2] * shape[1] * shape[0] == 2 and meshes[shape] is side:
            out[case] = serve_case(side, payload, case)
    if side is meshes[(1, 1, 2)]:
        out["http (1, 2)"] = http_case(side, payload)
    else:
        out["skewed clock (2, 1)"] = skewed_clock(side, payload)
    for case, (_, shape, _, _) in CASES.items():
        if shape[0] * shape[1] * shape[2] == 4:
            out[case] = serve_case(meshes[shape], payload, case)
    return out


def fail_mid_serve(mesh, payload):
    """Rank 1 raises in its third replayed step; rank 0 schedules."""
    dec_kw, ecfg_kw = configs("unified dense tiny (1, 2)")
    engine = engine_for(mesh, payload, "tiny_dense", dec_kw, ecfg_kw)
    if mesh.index == 0:
        drive(serving.Scheduler(engine), workload(), serving.Request)
        engine.release_followers()
        return 0
    step, calls = engine.step, []

    def failing_step(*args, **kwargs):
        calls.append(1)
        if len(calls) == 3:
            raise ValueError("rank 1 was told to fail mid-serve")
        return step(*args, **kwargs)

    engine.step = failing_step
    engine.follow()
    return 1

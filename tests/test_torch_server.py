"""The port's HTTP/SSE server over a real socket on 127.0.0.1, on the CPU
(twins of tests/test_server.py): streamed and non-streamed tokens equal the
reference server's for the same requests (and the port's own decode),
health / readiness / metrics, validation errors, deterministic 429
back-pressure with Retry-After, priority preemption over the wire, and a
graceful drain."""
import asyncio
import dataclasses
import http.client
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor

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

torch.set_num_threads(2)
pytestmark = pytest.mark.serving

MAX_NEW = 16


@pytest.fixture(scope="module")
def weights():
    jcfg = tiny_dense()
    jp = jmodel.init(jax.random.PRNGKey(0), jcfg)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    tp = bridge.from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                                device="cpu")
    return {"jax": (jserving, jp, jcfg, JDecodeConfig),
            "torch": (tserving, tp, tcfg, DecodeConfig)}


class _Live:
    """A server whose event loop runs in a background thread."""

    def __init__(self, side, **ecfg_kw):
        mod, params, cfg, dcls = side
        eng = mod.ContinuousBatchingEngine(
            params, cfg, dcls(max_new_tokens=MAX_NEW, block_k=4),
            mod.EngineConfig(num_slots=2, max_prompt_len=24,
                             max_new_cap=MAX_NEW, **ecfg_kw))
        self.frontend = mod.Frontend(mod.Scheduler(eng), max_queue=2)
        self.srv = mod.HTTPServer(self.frontend, port=0)
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        self._call(self.srv.start(), 300)

    def _call(self, coro, timeout):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout=timeout)

    @property
    def port(self):
        return self.srv.port

    def close(self):
        self._call(self.srv.stop(), 60)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)


@pytest.fixture(scope="module")
def servers(weights):
    live = {name: _Live(side) for name, side in weights.items()}
    yield live
    for s in live.values():
        s.close()


def _request(srv, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=300)
    if body is not None and not isinstance(body, (str, bytes)):
        body = json.dumps(body)
    conn.request(method, path, body=body)
    resp = conn.getresponse()
    raw = resp.read()
    headers = dict(resp.getheaders())
    conn.close()
    return resp.status, headers, raw


def _sse_events(raw):
    events = []
    for block in raw.decode().split("\n\n"):
        ev = data = None
        for ln in block.split("\n"):
            if ln.startswith("event: "):
                ev = ln[len("event: "):]
            elif ln.startswith("data: "):
                data = json.loads(ln[len("data: "):])
        if ev is not None:
            events.append((ev, data))
    return events


def _metrics_map(srv):
    _, _, raw = _request(srv, "GET", "/metrics")
    out = {}
    for ln in raw.decode().splitlines():
        k, v = ln.rsplit(" ", 1)
        out[k.removeprefix("repro_serving_")] = float(v)
    return out


def _alone(weights, prompt, max_new):
    _, params, cfg, dcls = weights["torch"]
    toks, stats = tdecode.bpd_decode(
        params, cfg, dcls(max_new_tokens=max_new, block_k=4),
        {"tokens": torch.tensor(prompt)[None]})
    return toks[0, len(prompt):int(stats["text_len"][0])].tolist()


def _streamed(raw):
    events = _sse_events(raw)
    toks = [t for ev, d in events if ev == "token" for t in d["tokens"]]
    dones = [d for ev, d in events if ev == "done"]
    assert len(dones) == 1 and events[-1][0] == "done"
    return toks, dones[0]


def test_health_ready_metrics(servers):
    srv = servers["torch"]
    status, _, raw = _request(srv, "GET", "/healthz")
    assert status == 200 and raw == b"ok\n"
    status, _, raw = _request(srv, "GET", "/readyz")
    assert status == 200 and raw == b"ready\n"
    m = _metrics_map(srv)
    assert m["num_slots"] == 2
    assert set(m) == set(_metrics_map(servers["jax"]))


def test_stream_equals_reference_server(weights, servers):
    """The SSE token events of the same request concatenate to the same
    tokens on both servers, equal to the done payload and to the port's
    own decode of the request alone."""
    prompt = np.random.default_rng(19).integers(0, 97, size=6)
    body = {"prompt": prompt.tolist(), "max_new": MAX_NEW}
    out = {}
    for name, srv in servers.items():
        status, headers, raw = _request(srv, "POST", "/v1/generate", body)
        assert status == 200
        assert headers["Content-Type"] == "text/event-stream"
        out[name] = _streamed(raw)
    toks, done = out["torch"]
    jtoks, jdone = out["jax"]
    assert toks == done["tokens"] == jtoks == jdone["tokens"]
    assert toks == _alone(weights, prompt, MAX_NEW)
    for key in ("generated", "preempted", "invocations", "policy"):
        assert done[key] == jdone[key], key
    assert done["latency_s"] >= done["queue_delay_s"] >= 0


def test_nonstream_json_equals_reference_server(weights, servers):
    prompt = np.random.default_rng(20).integers(0, 97, size=5)
    body = {"prompt": prompt.tolist(), "max_new": 8, "stream": False}
    got = {}
    for name, srv in servers.items():
        status, headers, raw = _request(srv, "POST", "/v1/generate", body)
        assert status == 200
        assert headers["Content-Type"] == "application/json"
        got[name] = json.loads(raw)["tokens"]
    assert got["torch"] == got["jax"] == _alone(weights, prompt, 8)


@pytest.mark.parametrize("method,path,body", [
    ("POST", "/v1/generate", "{not json"),
    ("POST", "/v1/generate", {"prompt": [1, 2]}),
    ("POST", "/v1/generate", {"prompt": list(range(1, 40)), "max_new": 4}),
    ("POST", "/v1/generate", {"prompt": [1, 2, 3], "max_new": 4,
                              "policy": "no-such-policy"}),
    ("GET", "/v1/generate", None),
    ("GET", "/nope", None),
])
def test_validation_errors_equal_reference(servers, method, path, body):
    status, _, raw = _request(servers["torch"], method, path, body)
    jstatus, _, jraw = _request(servers["jax"], method, path, body)
    assert status == jstatus and status in (400, 404)
    if status == 400 and body != "{not json":
        assert json.loads(raw)["error"].split(";")[0] == \
            json.loads(jraw)["error"].split(";")[0]


def test_backpressure_429_with_retry_after(weights, servers):
    """A 12-request burst against 2 slots + 2 queue spots: some are refused
    with 429 + Retry-After; accepted streams stay token-exact."""
    srv = servers["torch"]
    rng = np.random.default_rng(29)
    prompts = [rng.integers(0, 97, size=5) for _ in range(12)]

    def one(i):
        return _request(srv, "POST", "/v1/generate",
                        {"prompt": prompts[i].tolist(), "max_new": MAX_NEW})

    with ThreadPoolExecutor(max_workers=12) as ex:
        out = list(ex.map(one, range(12)))
    statuses = [s for s, _, _ in out]
    assert statuses.count(200) >= 2
    assert 429 in statuses
    _, hdrs, raw = out[statuses.index(429)]
    assert int(hdrs["Retry-After"]) >= 1
    body = json.loads(raw)
    assert body["retry_after_s"] >= 1 and "retry" in body["error"]
    assert _metrics_map(srv)["rejected_total"] >= statuses.count(429)
    for (status, _, raw), p in zip(out, prompts):
        if status == 200:
            toks, done = _streamed(raw)
            assert toks == done["tokens"] == _alone(weights, p, MAX_NEW)


def test_preemption_over_the_wire(weights, servers):
    """Both slots busy with full-budget requests, then a priority-1
    past-deadline request: a victim is evicted and re-admitted, and every
    stream is still the uninterrupted decode's."""
    srv = servers["torch"]
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, 97, size=6) for _ in range(3)]
    results = {}

    def client(i, payload):
        status, _, raw = _request(srv, "POST", "/v1/generate", payload)
        results[i] = (status, raw)

    base = _metrics_map(srv)
    with ThreadPoolExecutor(max_workers=2) as ex:
        futs = [ex.submit(client, i, {"prompt": prompts[i].tolist(),
                                      "max_new": MAX_NEW}) for i in range(2)]
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            m = _metrics_map(srv)
            if m["active_slots"] >= 2 and m["queue_depth"] == 0:
                break
            time.sleep(0.002)
        else:
            pytest.fail("slots never filled")
        client(2, {"prompt": prompts[2].tolist(), "max_new": 4,
                   "priority": 1, "deadline_s": 0.0})
        for f in futs:
            f.result()
    assert all(results[i][0] == 200 for i in range(3))
    streams = {i: _streamed(results[i][1]) for i in range(3)}
    assert streams[2][1]["preempted"] == 0
    assert sum(streams[i][1]["preempted"] for i in (0, 1)) >= 1
    assert _metrics_map(srv)["preemptions_total"] >= \
        base["preemptions_total"] + 1
    for i, budget in ((0, MAX_NEW), (1, MAX_NEW), (2, 4)):
        toks, done = streams[i]
        assert toks == done["tokens"] == _alone(weights, prompts[i], budget)


def test_graceful_drain_over_the_wire(weights):
    """POST /drain against a live disaggregated server: 202, readiness 503
    "draining", new submissions 503, the in-flight stream finishes
    token-exact, then the listener closes."""
    live = _Live(weights["torch"], prefill_slots=2, handoff_cap=4)
    try:
        prompt = np.random.default_rng(31).integers(0, 97, size=6)
        results = {}

        def client():
            results["r"] = _request(live, "POST", "/v1/generate",
                                    {"prompt": prompt.tolist(),
                                     "max_new": MAX_NEW})

        t = threading.Thread(target=client)
        t.start()
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            if _metrics_map(live)["active_slots"] >= 1:
                break
            time.sleep(0.002)
        else:
            pytest.fail("in-flight request never occupied a slot")
        status, _, raw = _request(live, "POST", "/drain")
        assert status == 202
        body = json.loads(raw)
        assert body["draining"] is True and body["in_flight"] >= 1
        status, _, _ = _request(live, "POST", "/drain")
        assert status == 202
        status, _, raw = _request(live, "GET", "/readyz")
        assert status == 503 and raw == b"draining\n"
        status, _, raw = _request(live, "POST", "/v1/generate",
                                  {"prompt": [1, 2, 3], "max_new": 4})
        assert status == 503 and b"drain" in raw
        t.join(timeout=120)
        assert not t.is_alive(), "in-flight stream did not finish"
        status, _, raw = results["r"]
        assert status == 200
        toks, done = _streamed(raw)
        assert toks == done["tokens"] == _alone(weights, prompt, MAX_NEW)
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            try:
                _request(live, "GET", "/healthz")
                time.sleep(0.01)
            except OSError:
                break
        else:
            pytest.fail("listener never closed after the drain finished")
    finally:
        live.close()


def test_engine_runs_on_one_thread(servers):
    """Every engine call of the serve loop runs on the front end's single
    engine thread."""
    fe = servers["torch"].frontend
    seen = set()
    orig = fe.scheduler.step

    def step(*a, **k):
        seen.add(threading.get_ident())
        return orig(*a, **k)

    fe.scheduler.step = step
    try:
        for i in range(3):
            _request(servers["torch"], "POST", "/v1/generate",
                     {"prompt": [1 + i, 2, 3], "max_new": 4,
                      "stream": False})
    finally:
        fe.scheduler.step = orig
    assert len(seen) == 1 and threading.get_ident() not in seen

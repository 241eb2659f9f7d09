"""Minimal asyncio HTTP/1.1 + SSE server over the serving ``Frontend`` (the
port of ``repro.serving.server``).

Stdlib-only by design: the serving layer must run wherever the engine runs
— no web framework, just ``asyncio.start_server`` and hand-rolled HTTP/1.1
parsing for the five routes the service needs:

  POST /v1/generate   decode a prompt.  JSON body:
                        {"prompt": [int token ids, ...],   required
                         "max_new": int,                   required
                         "policy": str | null,             optional
                         "priority": int,                  optional (higher wins)
                         "deadline_s": float | null,       optional (relative)
                         "stream": bool}                   default true
                      stream=true  → ``text/event-stream`` (SSE):
                        event: token   data: {"rid": R, "tokens": [...]}
                        event: done    data: {"rid": R, "tokens": [all],
                                              "generated": N, "policy": ...,
                                              "preempted": P, "ttft_s": ...,
                                              "latency_s": ...}
                      stream=false → one JSON object (the done payload).
  GET  /healthz       liveness — 200 once the process serves HTTP.
  GET  /readyz        readiness — 200 only after the kernels are built and
                      the decode path has run a tick; 503 before (load
                      balancers gate on this so cold replicas don't take
                      traffic).
  GET  /metrics       Prometheus-style ``name value`` lines from
                      ``Frontend.metrics()``.
  POST /drain         graceful shutdown: 202 immediately, admission stops
                      (new submits get 503, /readyz flips to 503
                      "draining"), in-flight requests finish and flush
                      their SSE tails, then the listener closes and
                      ``serve_forever()`` returns.  SIGTERM takes the
                      same path (wired in launch/serve.py).

Back-pressure: a saturated wait queue (or the page pool behind it —
``PagePoolExhausted`` requeues keep the queue full) rejects with **429**
and a ``Retry-After`` header derived from the observed service rate.
Invalid requests get 400 with the validation message; the connection
stays request-scoped (``Connection: close``) — one request per
connection keeps the parser honest and the failure modes boring.
"""
from __future__ import annotations

import asyncio
import json
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.serving.frontend import Backpressure, Draining, Frontend

__all__ = ["HTTPServer", "sse_event"]

_MAX_BODY = 1 << 20     # 1 MiB request-body cap


def sse_event(event: str, data: dict) -> bytes:
    """One Server-Sent Event frame: ``event:`` + JSON ``data:`` lines."""
    return (f"event: {event}\ndata: {json.dumps(data)}\n\n").encode()


def _response(status: int, reason: str, body: bytes,
              content_type: str = "application/json",
              extra_headers: Optional[Dict[str, str]] = None) -> bytes:
    head = [f"HTTP/1.1 {status} {reason}",
            f"Content-Type: {content_type}",
            f"Content-Length: {len(body)}",
            "Connection: close"]
    for k, v in (extra_headers or {}).items():
        head.append(f"{k}: {v}")
    return ("\r\n".join(head) + "\r\n\r\n").encode() + body


def _json_response(status: int, reason: str, obj: dict,
                   extra_headers: Optional[Dict[str, str]] = None) -> bytes:
    return _response(status, reason, (json.dumps(obj) + "\n").encode(),
                     extra_headers=extra_headers)


async def _read_request(reader: asyncio.StreamReader
                        ) -> Optional[Tuple[str, str, Dict[str, str], bytes]]:
    """Parse one HTTP/1.1 request: (method, path, headers, body) or None
    on EOF/overflow/malformed input."""
    try:
        head = await reader.readuntil(b"\r\n\r\n")
    except (asyncio.IncompleteReadError, asyncio.LimitOverrunError):
        return None
    lines = head.decode("latin-1").split("\r\n")
    parts = lines[0].split(" ")
    if len(parts) != 3:
        return None
    method, path = parts[0], parts[1]
    headers: Dict[str, str] = {}
    for ln in lines[1:]:
        if ":" in ln:
            k, v = ln.split(":", 1)
            headers[k.strip().lower()] = v.strip()
    n = int(headers.get("content-length", "0") or "0")
    if n < 0 or n > _MAX_BODY:
        return None
    body = await reader.readexactly(n) if n else b""
    return method, path, headers, body


class HTTPServer:
    """The serving process: one ``Frontend`` + one asyncio TCP listener."""

    def __init__(self, frontend: Frontend, host: str = "127.0.0.1",
                 port: int = 8000):
        self.frontend = frontend
        self.host = host
        self.port = port            # rebound to the real port on start()
        self._server: Optional[asyncio.base_events.Server] = None
        self._drain_task: Optional[asyncio.Task] = None

    async def start(self) -> None:
        await self.frontend.start()
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        await self.frontend.stop()

    async def serve_forever(self) -> None:
        assert self._server is not None, "start() first"
        try:
            async with self._server:
                await self._server.serve_forever()
        except asyncio.CancelledError:
            # a completed drain closes the listener, which cancels
            # serve_forever — that is the graceful-exit path, not an error
            if self._drain_task is None or not self._drain_task.done():
                raise

    # -- graceful drain ------------------------------------------------------

    def begin_drain(self) -> asyncio.Task:
        """Start a graceful drain exactly once (idempotent): admission
        stops immediately (new submits get 503), every in-flight request
        — queued, parked in the KV handoff, or mid-decode — finishes and
        flushes its SSE tail, then the listener closes so
        ``serve_forever()`` returns.  Wired to SIGTERM and ``POST /drain``
        by ``launch/serve.py``."""
        if self._drain_task is None:
            self._drain_task = asyncio.ensure_future(self._drain_and_close())
        return self._drain_task

    async def _drain_and_close(self) -> None:
        await self.frontend.drain()
        if self._server is not None:
            self._server.close()

    # -- request handling ----------------------------------------------------

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            parsed = await _read_request(reader)
            if parsed is None:
                writer.write(_json_response(400, "Bad Request",
                                            {"error": "malformed request"}))
            else:
                method, path, _headers, body = parsed
                await self._route(method, path, body, writer)
            await writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            pass                    # client went away mid-stream
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass

    async def _route(self, method: str, path: str, body: bytes,
                     writer: asyncio.StreamWriter) -> None:
        if method == "GET" and path == "/healthz":
            writer.write(_response(200, "OK", b"ok\n", "text/plain"))
        elif method == "GET" and path == "/readyz":
            if self.frontend.ready:
                writer.write(_response(200, "OK", b"ready\n", "text/plain"))
            else:
                msg = (b"draining\n" if self.frontend.draining
                       else b"warming up\n")
                writer.write(_response(503, "Service Unavailable",
                                       msg, "text/plain"))
        elif method == "GET" and path == "/metrics":
            lines = "".join(f"repro_serving_{k} {v}\n"
                            for k, v in self.frontend.metrics().items())
            writer.write(_response(200, "OK", lines.encode(), "text/plain"))
        elif method == "POST" and path == "/drain":
            self.begin_drain()
            writer.write(_json_response(202, "Accepted", {
                "draining": True,
                "in_flight": int(self.frontend.metrics()["active_slots"]),
                "queued": self.frontend.queue_depth()}))
        elif method == "POST" and path == "/v1/generate":
            await self._generate(body, writer)
        else:
            writer.write(_json_response(404, "Not Found",
                                        {"error": f"no route {method} {path}"}))

    async def _generate(self, body: bytes,
                        writer: asyncio.StreamWriter) -> None:
        try:
            spec = json.loads(body.decode() or "{}")
            prompt = spec["prompt"]
            max_new = int(spec["max_new"])
        except (json.JSONDecodeError, KeyError, TypeError, ValueError) as e:
            writer.write(_json_response(400, "Bad Request", {
                "error": f"body must be JSON with integer-token 'prompt' "
                         f"and 'max_new': {e!r}"}))
            return
        stream = bool(spec.get("stream", True))
        try:
            rid, q = self.frontend.submit(
                prompt, max_new,
                policy=spec.get("policy"),
                priority=int(spec.get("priority", 0)),
                deadline_s=spec.get("deadline_s"),
                src=spec.get("src"))
        except Draining as e:
            writer.write(_json_response(503, "Service Unavailable",
                                        {"error": str(e)}))
            return
        except Backpressure as e:
            retry = max(1, int(np.ceil(e.retry_after_s)))
            writer.write(_json_response(
                429, "Too Many Requests",
                {"error": str(e), "retry_after_s": retry},
                extra_headers={"Retry-After": str(retry)}))
            return
        except ValueError as e:
            writer.write(_json_response(400, "Bad Request",
                                        {"error": str(e)}))
            return
        if stream:
            await self._stream_sse(rid, q, writer)
        else:
            await self._collect_json(rid, q, writer)

    @staticmethod
    def _done_payload(rid: int, f, tokens) -> dict:
        return {
            "rid": rid,
            "tokens": [int(t) for t in tokens],
            "generated": int(f.generated),
            "policy": f.policy,
            "preempted": int(f.preempted),
            "invocations": int(f.invocations),
            "mean_accepted": float(f.mean_accepted),
            "queue_delay_s": float(f.queue_delay),
            "latency_s": float(f.latency),
        }

    async def _stream_sse(self, rid: int, q: asyncio.Queue,
                          writer: asyncio.StreamWriter) -> None:
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: text/event-stream\r\n"
                     b"Cache-Control: no-cache\r\n"
                     b"Connection: close\r\n\r\n")
        await writer.drain()
        streamed = []
        while True:
            ev = await q.get()
            if ev.kind == "tokens":
                toks = [int(t) for t in ev.data]
                streamed.extend(toks)
                writer.write(sse_event("token", {"rid": rid, "tokens": toks}))
            elif ev.kind == "done":
                writer.write(sse_event(
                    "done", self._done_payload(rid, ev.data, streamed)))
                await writer.drain()
                return
            await writer.drain()

    async def _collect_json(self, rid: int, q: asyncio.Queue,
                            writer: asyncio.StreamWriter) -> None:
        streamed = []
        while True:
            ev = await q.get()
            if ev.kind == "tokens":
                streamed.extend(int(t) for t in ev.data)
            elif ev.kind == "done":
                writer.write(_json_response(
                    200, "OK", self._done_payload(rid, ev.data, streamed)))
                return

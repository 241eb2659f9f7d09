"""Continuous-batching serving for blockwise parallel decoding (the port of
``repro.serving``), on one device or on a ("data", "model") or ("pod",
"data", "model") process mesh: each rank keeps its slots of every group,
rank 0 runs the scheduler and the HTTP server and the other ranks replay
its plans (``ContinuousBatchingEngine.follow``).

Layering:
  types.py     — Request / FinishedRequest / PreemptedRequest /
                 EngineConfig / SlotBatch
  pages.py     — the host page allocator of the managed paged KV pool
                 (copy-on-write prefix sharing)
  session.py   — DecodeSession: owner of the params and of the engine's
                 serving functions, built once per (policy, geometry)
  engine.py    — scheduler + slot-metadata shell over a DecodeSession
  scheduler.py — queue, admission policy, priorities/deadlines/preemption,
                 workload driver, stats
  frontend.py  — asyncio facade: per-request token streams + back-pressure
  server.py    — stdlib HTTP/1.1 + SSE surface over the frontend
"""
from repro_torch.serving.engine import (ContinuousBatchingEngine,
                                        PagePoolExhausted, PolicyGroup)
from repro_torch.serving.frontend import Backpressure, Frontend, StreamEvent
from repro_torch.serving.scheduler import Scheduler, aggregate_stats
from repro_torch.serving.server import HTTPServer
from repro_torch.serving.session import DecodeSession, ServingFns
from repro_torch.serving.types import (EngineConfig, FinishedRequest,
                                       PreemptedRequest, Request, SlotBatch)

__all__ = [
    "Backpressure",
    "ContinuousBatchingEngine",
    "DecodeSession",
    "Frontend",
    "HTTPServer",
    "PagePoolExhausted",
    "PolicyGroup",
    "PreemptedRequest",
    "ServingFns",
    "SlotBatch",
    "StreamEvent",
    "Scheduler",
    "aggregate_stats",
    "EngineConfig",
    "FinishedRequest",
    "Request",
]

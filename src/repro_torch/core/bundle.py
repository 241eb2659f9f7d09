"""ModelBundle: one model's decode identity, as ``repro.core.bundle``.

A session's verifier is its primary model; a drafter backed by a second,
smaller model (the ``draft_model`` policy, ``core.draft``) needs that
model's parameters, config and backend too.  A ``ModelBundle`` packages
them.  ``DecodeSession`` keeps its primary parameters and config as before
plus auxiliary bundles by name: their parameters go on the session's
device and reach the decode functions as ``aux`` ({name: params}), and the
static half (cfg, kv_chunk, backend factory) is bound into the policy
before any decode (``DecodePolicy.bind``), so an incompatible bundle fails
at construction.  On a mesh the session swaps each bundle for one whose
parameters are this rank's sharded ``ParamTree`` (``sharding.
shard_bundles``: the primary's path rules; a self-draft's is the primary's
own tree), and the drafter bound to it keeps its cache at the draft's local
KV heads.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from repro_torch.config import ModelConfig


@dataclasses.dataclass(eq=False)
class ModelBundle:
    """params + config + backend factory of one model in a decode session.

    ``backend_factory`` is ``(cfg, kv_chunk) -> core.decode.Backend``; None
    means the decoder-only ``causal_lm_backend`` (the drafter applies that
    default when the bundle is bound into it).  ``name`` is informational:
    the session keys bundles by the dict key it receives them under.
    """

    params: Any
    cfg: ModelConfig
    kv_chunk: int = 0
    backend_factory: Optional[Callable] = None
    name: str = ""

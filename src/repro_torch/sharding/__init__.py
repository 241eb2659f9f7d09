"""Sharding over a ("data", "model") or ("pod", "data", "model") process
mesh: the policy of which dimension lies over which axis (``policy``), and
the collectives the sharded decode and serving paths issue (``comm``)."""
from repro_torch.sharding.policy import (
    PARAM_RULES,
    batch_axes,
    batch_shard,
    batch_specs,
    cache_specs,
    data_axis_size,
    data_spec,
    local_kv_heads,
    packet_pod,
    packet_specs,
    param_specs,
    prefill_axes,
    shard_params,
    slot_owner,
    slot_specs,
    state_specs,
)

__all__ = [
    "PARAM_RULES",
    "batch_axes",
    "batch_shard",
    "batch_specs",
    "cache_specs",
    "data_axis_size",
    "data_spec",
    "local_kv_heads",
    "packet_pod",
    "packet_specs",
    "param_specs",
    "prefill_axes",
    "shard_params",
    "slot_owner",
    "slot_specs",
    "state_specs",
]

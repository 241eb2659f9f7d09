"""Sharding over a ("data", "model") process mesh: the policy of which
dimension lies over which axis (``policy``), and the collectives the
sharded decode path issues (``comm``)."""
from repro_torch.sharding.policy import (
    PARAM_RULES,
    batch_axes,
    batch_specs,
    cache_specs,
    data_axis_size,
    data_spec,
    local_kv_heads,
    param_specs,
    shard_params,
    state_specs,
)

__all__ = [
    "PARAM_RULES",
    "batch_axes",
    "batch_specs",
    "cache_specs",
    "data_axis_size",
    "data_spec",
    "local_kv_heads",
    "param_specs",
    "shard_params",
    "state_specs",
]

"""Architecture registry: ``--arch <id>`` resolution.

Each module in ``repro_torch.configs`` registers a full config and a reduced
smoke config, as ``repro.config.registry`` does.
"""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.config.base import ModelConfig

_REGISTRY: Dict[str, Dict[str, Callable[[], ModelConfig]]] = {}


def register(name: str, config_fn: Callable[[], ModelConfig],
             smoke_fn: Callable[[], ModelConfig]):
    if name in _REGISTRY:
        raise ValueError(f"duplicate arch registration: {name}")
    _REGISTRY[name] = {"config": config_fn, "smoke": smoke_fn}


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (registers the archs)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(_REGISTRY)}")
    cfg = _REGISTRY[name]["smoke" if smoke else "config"]()
    cfg.validate()
    return cfg

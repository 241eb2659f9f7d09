from repro_torch.config.base import DTYPES, DecodeConfig, ModelConfig
from repro_torch.config.registry import get_config, register

__all__ = ["DTYPES", "DecodeConfig", "ModelConfig", "get_config", "register"]

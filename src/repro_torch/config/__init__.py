from repro_torch.config.base import DTYPES, DecodeConfig, ModelConfig, TrainConfig
from repro_torch.config.registry import get_config, register

__all__ = ["DTYPES", "DecodeConfig", "ModelConfig", "TrainConfig", "get_config",
           "register"]

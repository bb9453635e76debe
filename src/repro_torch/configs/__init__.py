from repro_torch.configs.base import ModelConfig, QuantConfig, TrainConfig
from repro_torch.configs.registry import ARCHS, get_arch, reduced

__all__ = ["ModelConfig", "QuantConfig", "TrainConfig", "ARCHS", "get_arch", "reduced"]

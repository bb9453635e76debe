from repro_torch.configs.base import ModelConfig, QuantConfig
from repro_torch.configs.registry import ARCHS, get_arch, reduced

__all__ = ["ModelConfig", "QuantConfig", "ARCHS", "get_arch", "reduced"]

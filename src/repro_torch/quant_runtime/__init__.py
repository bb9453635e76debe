from repro_torch.quant_runtime.qparams import QuantizedTensor
from repro_torch.quant_runtime import qlinear

__all__ = ["QuantizedTensor", "qlinear"]

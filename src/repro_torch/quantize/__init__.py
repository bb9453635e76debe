"""Public quantization API: one entry point, a pluggable method registry.

    from repro_torch.quantize import quantize
    qtree, report = quantize(params_post, params_base,
                             QuantConfig(method="daq", metric="sign"))
"""
from repro_torch.quantize.api import LeafContext, QuantReport, Quantizer, quantize
from repro_torch.quantize.daq import AbsMaxQuantizer, DAQQuantizer  # noqa: F401
from repro_torch.quantize.registry import available_methods, get_method, register

__all__ = ["LeafContext", "QuantReport", "Quantizer", "quantize",
           "available_methods", "get_method", "register"]

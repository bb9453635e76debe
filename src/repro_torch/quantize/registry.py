"""String-keyed registry of quantization methods.

Port of ``repro/quantize/registry.py``: every method registers a
:class:`~repro_torch.quantize.api.Quantizer` subclass under a short name, and
:func:`repro_torch.quantize.quantize` resolves ``QuantConfig.method`` through
this table.  The built-in methods register when the package imports them.
"""
from __future__ import annotations

_REGISTRY: dict[str, type] = {}


def register(name: str):
    """Class decorator: register a :class:`Quantizer` under ``name``."""
    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def get_method(name: str) -> type:
    """Resolve a method name to its :class:`Quantizer` class."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown quantization method {name!r}; "
                       f"available: {sorted(_REGISTRY)}") from None


def available_methods() -> list[str]:
    return sorted(_REGISTRY)

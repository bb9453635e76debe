"""Bridge from the JAX reference's parameter trees to the port's.

``params_from_jax(tree)`` takes a tree as the reference holds it after a
device-to-host copy (``jax.device_get``): nested dicts whose leaves are
numpy arrays, and quantized leaves that carry ``data``, ``scale``, ``fmt``,
``granularity``, ``block_size``, ``out_dtype`` and ``eq_scale`` attributes
(the reference's ``QuantizedTensor``; ``eq_scale`` is None unless the tensor
was equalized by SmoothQuant / AWQ).  bfloat16 and fp8 arrays are reinterpreted
through ``.view(np.uint16)`` / ``.view(np.uint8)``, so neither JAX nor
``ml_dtypes`` is imported here.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.quant_runtime.qparams import QuantizedTensor

# numpy dtype name (as ml_dtypes registers it) -> (bit-view dtype, torch dtype)
_BIT_VIEWS = {
    "bfloat16": (np.uint16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, torch.float8_e5m2),
}
_TORCH_NAMES = {tdtype: name for name, (_, tdtype) in _BIT_VIEWS.items()}


def tensor_from_numpy(a) -> torch.Tensor:
    """A CPU torch copy of a numpy array, bf16 / fp8 included."""
    a = np.array(a, order="C")          # a copy; a 0-d array stays 0-d
    if a.dtype.name not in _BIT_VIEWS:
        return torch.from_numpy(a)
    return tensor_from_bits(a, a.dtype.name)


def tensor_from_bits(a, name: str) -> torch.Tensor:
    """A CPU torch copy of ``a``'s bytes read as the extended dtype ``name``
    (a key of ``_BIT_VIEWS``): ``a`` may be an ``ml_dtypes`` array or the
    raw void array (``|V2``, ``|V1``) that ``np.load`` returns for one."""
    bits, tdtype = _BIT_VIEWS[name]
    raw = torch.from_numpy(np.array(a, order="C").view(bits))
    if bits is np.uint16:
        raw = raw.view(torch.int16)     # torch views 2-byte ints as bf16
    return raw.view(tdtype)


def numpy_bits(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """(numpy array, dtype name) of a tensor, on the host: a bf16 / fp8
    tensor becomes a raw void array of its bytes (``|V2``, ``|V1``) named by
    the ``ml_dtypes`` name that reads it back (``bfloat16``,
    ``float8_e4m3fn``, ``float8_e5m2``); any other dtype its own array."""
    t = t.detach().cpu().contiguous()
    name = _TORCH_NAMES.get(t.dtype)
    if name is None:
        arr = t.numpy()
        return arr, str(arr.dtype)
    bits = torch.int16 if t.element_size() == 2 else torch.uint8
    return t.view(bits).numpy().view(f"V{t.element_size()}"), name


def params_from_jax(tree: Any) -> Any:
    """The port's parameter tree (``QuantizedTensor`` leaves included, on the
    CPU) for a reference tree fetched to the host."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v) for k, v in tree.items()}
    if hasattr(tree, "granularity") and hasattr(tree, "data"):
        eq = getattr(tree, "eq_scale", None)
        return QuantizedTensor(data=tensor_from_numpy(tree.data),
                               scale=tensor_from_numpy(tree.scale),
                               fmt=tree.fmt, granularity=tree.granularity,
                               block_size=tree.block_size, out_dtype=tree.out_dtype,
                               eq_scale=None if eq is None else tensor_from_numpy(eq))
    return tensor_from_numpy(tree)

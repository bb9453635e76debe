"""The public quantization surface: ``quantize(params_post, params_base, qcfg)``.

Port of ``repro/quantize/api.py``.  One entry point owns the parameter-tree
walk, the skip policy, the exact global delta-metric aggregation (partial
sums combined across leaves) and the storage-vs-dequant emission; the
per-leaf math is a :class:`Quantizer` from the method registry (``"daq"``,
``"absmax"``).  Parameter trees are nested dicts of tensors and are walked
in the reference's order (sorted keys).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from repro_torch.configs.base import QuantConfig
from repro_torch.core import metrics as M
from repro_torch.core.formats import get_format
from repro_torch.core.granularity import dequantize_stored
from repro_torch.core.policy import path_str, should_quantize, tree_leaves_with_path
from repro_torch.core.search import SearchResult
from repro_torch.quant_runtime.qparams import QuantizedTensor
from repro_torch.quantize.registry import get_method

_METRICS = ("mse", "sign_rate", "cosine", "delta_l2")


@dataclass(frozen=True)
class LeafContext:
    """Everything a :class:`Quantizer` sees for one eligible leaf."""
    name: str                    # joined key path, e.g. "stack/L0/attn/wq"
    w_post: torch.Tensor         # post-trained weight (>= 2-D)
    w_base: torch.Tensor         # base weight, same shape
    qcfg: QuantConfig            # method-resolved config


class Quantizer:
    """Base class for registered quantization methods: ``prepare`` quantizes
    one leaf; ``resolve_config`` may normalize the config before the walk."""

    name: str = ""

    def resolve_config(self, qcfg: QuantConfig) -> QuantConfig:
        return qcfg

    def prepare(self, ctx: LeafContext) -> SearchResult:
        raise NotImplementedError


@dataclass
class QuantReport:
    per_leaf: dict[str, dict] = field(default_factory=dict)
    global_chosen: dict[str, float] = field(default_factory=dict)
    global_default: dict[str, float] = field(default_factory=dict)
    n_quantized: int = 0
    n_skipped: int = 0
    quantized_bytes: int = 0
    original_bytes: int = 0
    method: str = ""

    def summary(self) -> str:
        g, d = self.global_chosen, self.global_default
        lines = [
            f"quantized {self.n_quantized} tensors ({self.n_skipped} skipped), "
            f"{self.original_bytes / 1e6:.1f} MB -> {self.quantized_bytes / 1e6:.1f} MB",
            f"  delta_l2   : {d.get('delta_l2', 0):.4g} -> {g.get('delta_l2', 0):.4g}",
            f"  sign_rate  : {d.get('sign_rate', 0):.4f} -> {g.get('sign_rate', 0):.4f}",
            f"  cosine     : {d.get('cosine', 0):.4f} -> {g.get('cosine', 0):.4f}",
            f"  mse        : {d.get('mse', 0):.4g} -> {g.get('mse', 0):.4g}",
        ]
        if self.method:
            lines.insert(0, f"method: {self.method}")
        return "\n".join(lines)


def _rebuild(tree: Any, leaves) -> Any:
    """``tree``'s dict structure with its leaves replaced, in walk order."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    return next(leaves)


def _dequantized(res: SearchResult, qcfg: QuantConfig, dtype: torch.dtype) -> torch.Tensor:
    fmt = get_format(qcfg.fmt)
    deq = lambda q, s: dequantize_stored(q, s, qcfg.granularity, fmt, qcfg.block_size,
                                         dtype)
    if res.w_q.ndim == 2:
        return deq(res.w_q, res.scale)
    return torch.stack([deq(res.w_q[i], res.scale[i]) for i in range(res.w_q.shape[0])])


def quantize(params_post: Any, params_base: Any = None,
             qcfg: QuantConfig | None = None, *, mode: str = "dequant",
             out_dtype: str = "float32",
             method: str | None = None) -> tuple[Any, QuantReport]:
    """Quantize every eligible leaf of ``params_post``.

    Args:
      params_post: nested dict of post-trained weights.
      params_base: matching tree of base weights for the delta-aware
        objectives; ``None`` uses ``params_post`` itself (zero delta).
      qcfg: :class:`QuantConfig`; ``qcfg.method`` selects the algorithm.
      mode: ``"dequant"`` returns float weights; ``"storage"`` returns
        :class:`QuantizedTensor` leaves (serving).
      out_dtype: dtype of emitted weights (dequant) / dequantization target
        (storage).
      method: registry-name override of ``qcfg.method``.

    Returns ``(quantized_tree, QuantReport)``; the work runs on the device
    the weights live on.
    """
    if qcfg is None:
        qcfg = QuantConfig()
    if mode not in ("dequant", "storage"):
        raise ValueError(f"mode must be 'dequant' or 'storage', got {mode!r}")
    name = method or qcfg.method
    quantizer: Quantizer = get_method(name)()
    qcfg = quantizer.resolve_config(qcfg)
    if params_base is None:
        params_base = params_post

    report = QuantReport(method=name)
    post_leaves = list(tree_leaves_with_path(params_post))
    base_leaves = [leaf for _, leaf in tree_leaves_with_path(params_base)]
    if len(post_leaves) != len(base_leaves):
        raise ValueError("post/base parameter trees differ in structure")

    agg_c = dict.fromkeys(M.PARTIAL_KEYS, 0.0)
    agg_d = dict.fromkeys(M.PARTIAL_KEYS, 0.0)
    out_leaves = []
    for (path, w_post), w_base in zip(post_leaves, base_leaves):
        leaf_name = path_str(path)
        if not should_quantize(leaf_name, w_post, qcfg.skip_patterns):
            report.n_skipped += 1
            out_leaves.append(w_post)
            continue
        res = quantizer.prepare(LeafContext(leaf_name, w_post, w_base, qcfg))
        report.n_quantized += 1
        report.original_bytes += w_post.numel() * w_post.element_size()
        for k in M.PARTIAL_KEYS:
            agg_c[k] += float(res.chosen[k].sum())
            agg_d[k] += float(res.default[k].sum())
        report.per_leaf[leaf_name] = {
            "alpha": res.alpha.cpu().numpy(),
            "chosen": {m: float(res.chosen[m].mean()) for m in _METRICS},
            "default": {m: float(res.default[m].mean()) for m in _METRICS},
            "shape": tuple(w_post.shape),
        }
        if mode == "storage":
            qt = QuantizedTensor(data=res.w_q, scale=res.scale, fmt=qcfg.fmt,
                                 granularity=qcfg.granularity,
                                 block_size=qcfg.block_size, out_dtype=out_dtype)
            report.quantized_bytes += qt.nbytes()
            out_leaves.append(qt)
        else:
            report.quantized_bytes += (w_post.numel() * get_format(qcfg.fmt).bits // 8
                                       + res.scale.numel() * 4)
            out_leaves.append(_dequantized(res, qcfg, getattr(torch, out_dtype)))

    def globals_of(agg):
        p = {k: torch.tensor(v, dtype=torch.float32) for k, v in agg.items()}
        return {k: float(v) for k, v in M.metrics_from_partials(p).items()}

    report.global_chosen = globals_of(agg_c)
    report.global_default = globals_of(agg_d)
    return _rebuild(params_post, iter(out_leaves)), report

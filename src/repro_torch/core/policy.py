"""Which parameter leaves get quantized, and the leaf names the policy sees.

Port of ``repro/core/policy.py``.  Parameter trees are nested dicts; a
leaf's name joins its keys with ``/`` exactly as the reference's
``path_str`` joins a JAX key path (``"stack/L0/attn/wq"``).
"""
from __future__ import annotations

from typing import Any, Iterator

DEFAULT_SKIP = ("norm", "bias", "router", "a_log", "dt_bias", "d_skip", "conv", "embed")


def path_str(path) -> str:
    return "/".join(str(p) for p in path)


def tree_leaves_with_path(tree: Any, prefix: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """(key path, leaf) pairs of a nested dict in the reference's flatten
    order (dict keys sorted, as ``jax.tree_util`` flattens them)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves_with_path(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def tree_map(fn, tree: Any) -> Any:
    """``fn`` applied to every leaf of a nested dict, structure kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# the subtrees whose leaves carry a leading layer axis (``models/lm.py``:
# the period stack, and the MoE family's dense-prefix stack)
STACKED = ("stack/", "prefix/")


def should_quantize(path: str, leaf: Any, skip_patterns=DEFAULT_SKIP,
                    min_dim: int = 16) -> bool:
    """The reference's rule, read per layer for stacked leaves: a layer's
    vector stacked into a matrix (Mamba's ``d_skip``, [n_layers, heads]) is
    a vector, which the reference quantizes as a matrix when both axes
    reach ``min_dim`` and then cannot serve (ROADMAP Queue C 23)."""
    if not hasattr(leaf, "ndim") or leaf.ndim < 2:
        return False
    if path.startswith(STACKED) and leaf.ndim < 3:
        return False
    low = path.lower()
    if any(pat in low for pat in skip_patterns):
        return False
    if min(leaf.shape[-2:]) < min_dim:
        return False
    return True

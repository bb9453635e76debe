"""Atomic checkpoints of nested dicts of tensors, in the reference's format.

Port of ``repro/checkpoint/store.py`` for the port's trees (nested dicts
of tensors); a checkpoint written by either package restores bit-equal in
the other.

* **Layout** — ``<dir>/step_<N:08d>/`` holds one ``.npy`` per leaf, named by
  the leaf's key path joined with ``.`` (``stack.L0.attn.wq.npy``), and a
  ``manifest.json`` with each leaf's dtype name, shape and byte size.  A
  :class:`QuantizedTensor` leaf is its ``data``, ``scale`` and (when set)
  ``eq_scale`` children (``stack.L0.attn.wq.data.npy``), as the reference's
  registered dataclass flattens it.  bf16 and fp8 leaves are written as raw
  void arrays of their bytes (``|V2``, ``|V1``) with the ``ml_dtypes`` name
  (``bfloat16``, ``float8_e4m3fn``) in the manifest, which is how the
  reference reads them back; the port reads the reference's files (void as
  well) through ``compat.tensor_from_bits``, so neither direction needs
  ``ml_dtypes``.
* **Atomicity** — a checkpoint is written to ``step_<N>.tmp-<nonce>/`` and
  renamed into place once every file and the manifest are fsync'd, so
  ``latest()`` only ever sees complete ones.
* **Retention** — the newest ``keep_last`` checkpoints are kept; older ones
  and orphaned ``tmp-`` directories are removed after the new one lands.
* **Integrity** — each leaf file's byte size is checked on restore.
"""
from __future__ import annotations

import json
import os
import shutil
import uuid
from typing import Any

import numpy as np
import torch

from repro_torch.compat import _BIT_VIEWS, numpy_bits, tensor_from_bits
from repro_torch.quant_runtime.qparams import QuantizedTensor

MANIFEST = "manifest.json"
_QT_FIELDS = ("data", "scale", "eq_scale")     # the reference's data_fields


def _leaf_files(tree: Any, prefix: tuple = ()) -> list[tuple[str, torch.Tensor]]:
    """(file name, tensor) of every leaf in the reference's flatten order:
    dict keys sorted, a QuantizedTensor's set children in field order (an
    unset ``eq_scale`` is an empty subtree)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [f for k in sorted(tree) for f in _leaf_files(tree[k], prefix + (str(k),))]
    if isinstance(tree, QuantizedTensor):
        return [f for k in _QT_FIELDS for f in _leaf_files(getattr(tree, k), prefix + (k,))]
    return [(".".join(prefix), tree)]


def save(ckpt_dir: str, step: int, tree: Any, *, keep_last: int = 3,
         extra_meta: dict | None = None) -> str:
    """Atomically save ``tree`` as ``<ckpt_dir>/step_<step>``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + f".tmp-{uuid.uuid4().hex[:8]}"
    os.makedirs(tmp, exist_ok=True)
    manifest: dict = {"step": step, "leaves": {}, "meta": extra_meta or {}}
    for name, leaf in _leaf_files(tree):
        arr, dtype = numpy_bits(leaf)
        fn = os.path.join(tmp, name + ".npy")
        with open(fn, "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
        manifest["leaves"][name] = {"dtype": dtype, "shape": list(arr.shape),
                                    "bytes": os.path.getsize(fn)}
    mf = os.path.join(tmp, MANIFEST)
    with open(mf, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):  # re-save of the same step (a restart past a crash)
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep_last)
    return final


def _gc(ckpt_dir: str, keep_last: int) -> None:
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)
    # sweep orphaned tmp dirs from crashed writers
    for d in os.listdir(ckpt_dir):
        if ".tmp-" in d:
            shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and ".tmp-" not in d \
                and os.path.exists(os.path.join(ckpt_dir, d, MANIFEST)):
            out.append(int(d[len("step_"):]))
    return sorted(out)


def latest(ckpt_dir: str) -> int | None:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _read_leaf(base: str, name: str, info: dict, proto: torch.Tensor) -> torch.Tensor:
    fn = os.path.join(base, name + ".npy")
    if os.path.getsize(fn) != info["bytes"]:
        raise IOError(f"corrupt checkpoint leaf {name} "
                      f"({os.path.getsize(fn)} != {info['bytes']} bytes)")
    arr = np.load(fn)
    if list(arr.shape) != list(proto.shape):
        raise ValueError(f"shape mismatch for {name}: {arr.shape} vs {tuple(proto.shape)}")
    t = (tensor_from_bits(arr, info["dtype"]) if info["dtype"] in _BIT_VIEWS
         else torch.from_numpy(np.array(arr, order="C")))
    if t.dtype != proto.dtype:
        if t.is_floating_point():
            t = t.float()           # float cross-casts bounce through f32, as the reference's
        t = t.to(proto.dtype)
    return t.to(proto.device)


def restore(ckpt_dir: str, step: int, like: Any) -> Any:
    """Restore into the structure of ``like``, a nested dict of tensors
    (QuantizedTensor leaves included): each leaf takes its ``like``
    tensor's shape (checked), dtype (cast) and device."""
    base = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(base, MANIFEST)) as f:
        leaves = json.load(f)["leaves"]
    names = [n for n, _ in _leaf_files(like)]
    missing = [n for n in names if n not in leaves]
    if missing:
        raise ValueError(f"checkpoint {base} missing leaves: {missing[:5]}...")

    def build(tree, prefix):
        if tree is None:
            return None
        if isinstance(tree, dict):
            return {k: build(v, prefix + (str(k),)) for k, v in tree.items()}
        if isinstance(tree, QuantizedTensor):
            return QuantizedTensor(**{k: build(getattr(tree, k), prefix + (k,))
                                      for k in _QT_FIELDS},
                                   fmt=tree.fmt, granularity=tree.granularity,
                                   block_size=tree.block_size, out_dtype=tree.out_dtype)
        name = ".".join(prefix)
        return _read_leaf(base, name, leaves[name], tree)

    return build(like, ())


def meta(ckpt_dir: str, step: int) -> dict:
    base = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(base, MANIFEST)) as f:
        return json.load(f)

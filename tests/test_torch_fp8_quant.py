"""The fp8 block quantizer's CUDA wrapper, seen from the CPU.

``csrc/fp8_quant.cu`` has two instances: one 128 x 128 tile per thread
block held in registers (block 128, w 16-byte aligned) and a general one
(any block, any float32 alignment).  The kernel runs only on the card
(``chip_smoke.py`` holds both instances against the plain version there,
NaN and inf tiles included); here: the instance choice, the operand checks
(pure functions of shapes, strides, dtypes and pointers), the arguments
the wrapper launches with, its refusal of CPU tensors before any build,
and the build cache key.  All checks are exact.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.core.formats import f32_reciprocal
from repro_torch.kernels import _lib
from repro_torch.kernels.fp8_quant import kernel as K
from repro_torch.kernels.fp8_quant.kernel import (INSTANCES, quant_instance,
                                                  quant_operand_error, quantize_fp8_cuda)

F32 = torch.float32


@pytest.mark.parametrize("block,w_ptr,want", [
    (128, 1 << 20, "tile"),              # the main path: every leaf-layer
    (128, (1 << 20) + 16, "tile"),
    (128, (1 << 20) + 4, "general"),     # a view 4 bytes into its storage
    (128, (1 << 20) + 8, "general"),
    (64, 1 << 20, "general"),            # the CPU tests' block
    (66, 1 << 20, "general"),            # a block that is no multiple of 4
    (32, 1 << 20, "general"),
    (256, 1 << 20, "general"),
])
def test_quant_instance(block, w_ptr, want):
    assert quant_instance(block, w_ptr) == want


def _operands(**over):
    """Keyword arguments of ``quant_operand_error`` for a valid [256, 384]
    block-128 quantize, with ``over`` replacing some."""
    args = dict(w_shape=(256, 384), w_strides=(384, 1), w_dtype=F32, alpha_shape=(1,),
                alpha_dtype=F32, block=128)
    args.update(over)
    return args


@pytest.mark.parametrize("over", [
    dict(),
    dict(block=64),
    dict(block=66, w_shape=(396, 330), w_strides=(330, 1)),
    dict(w_shape=(4096, 151552), w_strides=(151552, 1)),
])
def test_quant_operand_checks_accept(over):
    assert quant_operand_error(**_operands(**over)) is None


@pytest.mark.parametrize("over,why", [
    (dict(w_dtype=torch.bfloat16), "float32 w"),
    (dict(w_dtype=torch.float64), "float32 w"),
    (dict(alpha_dtype=torch.float64), "float32 w and alpha"),
    (dict(alpha_shape=()), "alpha of shape (1,)"),
    (dict(alpha_shape=(2,)), "alpha of shape (1,)"),
    (dict(alpha_shape=(1, 1)), "alpha of shape (1,)"),
    (dict(w_shape=(2, 256, 384), w_strides=(98304, 384, 1)), "2-D"),
    (dict(w_shape=(200, 384), w_strides=(384, 1)), "multiples of the block"),
    (dict(w_shape=(256, 320), w_strides=(320, 1)), "multiples of the block"),
    (dict(block=66), "multiples of the block"),
    (dict(block=0), "multiples of the block"),
    (dict(w_strides=(1, 256)), "row-major"),
    (dict(w_strides=(512, 1)), "row-major"),
])
def test_quant_operand_checks_refuse(over, why):
    err = quant_operand_error(**_operands(**over))
    assert err is not None and why in err


class _Recorder:
    """Stands in for ``_lib.FP8_QUANT``: records each launch's arguments."""

    def __init__(self):
        self.calls = []

    def launch(self, fn, *args):
        self.calls.append((fn, args))


@pytest.mark.parametrize("block,offset,instance", [(128, 0, "tile"), (128, 1, "general"),
                                                   (64, 0, "general")])
def test_wrapper_launches_once_with_the_chosen_instance(monkeypatch, block, offset, instance):
    rec = _Recorder()
    monkeypatch.setattr(K, "FP8_QUANT", rec)
    monkeypatch.setattr(K, "require_cuda", lambda *t: None)
    monkeypatch.setattr(K, "stream_of", lambda t: 0)
    I, O = 256, 384
    w = torch.zeros(I * O + offset)[offset:].view(I, O)   # 4 bytes in, for offset 1
    alpha = torch.ones(1)
    q, s = quantize_fp8_cuda(w, alpha, block=block)
    assert q.shape == (I, O) and q.dtype == torch.float8_e4m3fn
    assert s.shape == (I // block, O // block) and s.dtype == F32
    assert len(rec.calls) == 1
    fn, (p_w, p_a, p_q, p_s, i, o, b, inst, qmax, recip, stream) = rec.calls[0]
    assert fn == "quantize_fp8" and (i, o, b, inst) == (I, O, block, INSTANCES[instance])
    assert (p_w, p_a, p_q, p_s) == (w.data_ptr(), alpha.data_ptr(), q.data_ptr(), s.data_ptr())
    assert qmax == 448.0 and recip == f32_reciprocal(448.0) and stream == 0


def test_wrapper_refuses_bad_operands_before_any_launch(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(K, "FP8_QUANT", rec)
    monkeypatch.setattr(K, "require_cuda", lambda *t: None)
    for w, alpha, block in ((torch.zeros(256, 384).double(), torch.ones(1), 128),
                            (torch.zeros(256, 384), torch.ones(2), 128),
                            (torch.zeros(200, 384), torch.ones(1), 128)):
        with pytest.raises(ValueError, match="fp8_quant"):
            quantize_fp8_cuda(w, alpha, block=block)
    assert rec.calls == []


def test_cpu_tensors_are_refused_before_any_build():
    before = {k.name: (k.launches, k._lib) for k in _lib.KERNELS}
    with pytest.raises(ValueError, match="CUDA"):
        quantize_fp8_cuda(torch.zeros(256, 384), torch.ones(1))
    assert {k.name: (k.launches, k._lib) for k in _lib.KERNELS} == before


def test_the_library_is_named_by_its_source_and_every_header(tmp_path, monkeypatch):
    """The quantizer's library changes name when ``fp8_quant.cu`` or any
    header (``common.cuh``, which holds the NaN-propagating max) changes,
    and not when another kernel's source does."""
    for f in _lib.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_lib, "CSRC", tmp_path)
    k = _lib.Kernel("fp8_quant", _lib.FP8_QUANT.functions)
    names = [k.library_path()]
    for f in ("fp8_quant.cu", "common.cuh", "hopper.cuh"):
        (tmp_path / f).write_text((tmp_path / f).read_text() + "\n// changed\n")
        names.append(k.library_path())
    (tmp_path / "scale_search.cu").write_text("// another kernel, changed\n")
    names.append(k.library_path())
    assert len(set(names)) == 4 and names[-1] == names[-2]

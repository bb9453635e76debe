"""The scale-search sweep's candidate chunks, seen from the CPU.

One pass of the CUDA sweep (``csrc/scale_search.cu``) takes at most
``MAX_CAND`` = 16 candidates, one compiled instance per count; a stage with
more runs in the chunks of ``kernel.sweep_plan``, a pass over the weights
each.  The kernel runs only on the card (``chip_smoke.py`` holds it against
its plain version there, at 1, 6, 11 and 20 candidates); here: the plan
covers every candidate once, in order; the main path's stages (6 and 11
candidates) are one pass; the wrapper hands each pass its slice of the
alphas and of the output; and a search with more than 16 candidates a stage
picks the JAX reference's alpha (plain version; storage codes bit-equal).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import QuantConfig as RefQuantConfig
from repro.core.search import search_scale as ref_search_scale
from repro_torch.configs import QuantConfig
from repro_torch.core.search import search_scale
from repro_torch.kernels.scale_search import kernel as K
from repro_torch.kernels.scale_search.kernel import MAX_CAND, sweep_plan
from repro_torch.kernels.scale_search.ref import N_STATS


def _check_plan(n: int) -> None:
    plan = sweep_plan(n)
    covered = [c for start, count in plan for c in range(start, start + count)]
    assert covered == list(range(n))                    # each once, in order
    assert all(1 <= count <= MAX_CAND for _, count in plan)
    assert len(plan) == -(-n // MAX_CAND)               # as few passes as can be
    if plan:
        counts = [count for _, count in plan]
        assert max(counts) - min(counts) <= 1           # near-equal chunks


@pytest.mark.parametrize("n", [1, 2, 6, 11, 15, 16, 17, 20, 31, 32, 33, 100])
def test_sweep_plan_covers_each_candidate_once_in_order(n):
    _check_plan(n)


@pytest.mark.parametrize("n", [1, 6, 11, MAX_CAND])
def test_sweep_plan_is_one_pass_up_to_max_cand(n):
    """The main path's coarse (1 + 5) and fine (1 + 10) stages: one launch each."""
    assert sweep_plan(n) == [(0, n)]


def test_sweep_plan_of_no_candidates_is_empty():
    assert sweep_plan(0) == []


@settings(database=None, derandomize=True, max_examples=101)
@given(st.integers(min_value=0, max_value=100))
def test_sweep_plan_property(n):
    _check_plan(n)


class _Recorder:
    """Stands in for ``_lib.SCALE_SEARCH``: records each launch's arguments."""

    def __init__(self):
        self.calls = []

    def launch(self, fn, *args):
        self.calls.append((fn, args))


@pytest.mark.parametrize("n_cand", [1, 6, 11, 16, 17, 20, 40])
def test_wrapper_launches_each_chunk_on_its_slice(monkeypatch, n_cand):
    """One launch per chunk of ``sweep_plan``; chunk (start, count) gets the
    alphas from ``start`` and the output records from candidate ``start``."""
    rec = _Recorder()
    monkeypatch.setattr(K, "SCALE_SEARCH", rec)
    monkeypatch.setattr(K, "require_cuda", lambda *t: None)
    monkeypatch.setattr(K, "stream_of", lambda t: 0)
    I, O, bs = 256, 384, 128
    wp = torch.zeros(I, O)
    amax = torch.ones(I // bs, O // bs)
    alphas = torch.linspace(0.8, 1.25, n_cand)
    out = K.sweep_partials_cuda(wp, wp, amax, alphas, block_size=bs)
    assert out.shape == (n_cand, I // bs, O // bs, N_STATS)
    plan = sweep_plan(n_cand)
    assert len(rec.calls) == len(plan)
    record = (I // bs) * (O // bs) * N_STATS * 4                     # bytes per candidate
    for (fn, args), (start, count) in zip(rec.calls, plan):
        p_wp, p_wb, p_amax, p_alpha, p_out, i, o, b, n = args[:9]
        assert fn == "sweep_partials" and (i, o, b, n) == (I, O, bs, count)
        assert p_wp == p_wb == wp.data_ptr() and p_amax == amax.data_ptr()
        assert p_alpha == alphas.data_ptr() + 4 * start
        assert p_out == out.data_ptr() + record * start


def test_search_with_more_candidates_than_one_pass_matches_reference():
    """20 coarse and 17 fine candidates (21 and 18 a stage with the
    incumbent: two passes each on the card) pick the reference's alpha."""
    rng = np.random.default_rng(11)
    wb = (rng.standard_normal((256, 128)) * 0.05).astype(np.float32)
    wp = (wb + rng.standard_normal((256, 128)) * 0.003).astype(np.float32)
    kw = dict(metric="sign", granularity="block", block_size=128, use_fused_kernel=True,
              n_coarse=20, n_fine=17)
    port = search_scale(torch.from_numpy(wp), torch.from_numpy(wb), QuantConfig(**kw))
    ref = ref_search_scale(wp, wb, RefQuantConfig(**kw))
    np.testing.assert_array_equal(port.alpha.numpy(), np.asarray(ref.alpha))
    np.testing.assert_array_equal(port.w_q.view(torch.uint8).numpy(),
                                  np.asarray(ref.w_q).view(np.uint8))

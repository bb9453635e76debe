"""repro_torch.data.synthetic (the calibration corpus) vs the JAX reference.

Tolerances: the bigram table, the style permutation and the style table are
bit-equal (numpy's ``RandomState``, the same calls in the same order).
``sample_batch`` draws from a ``torch.Generator``, whose streams are not
``jax.random``'s, so it is held by distribution: shapes, first tokens below
``V - 1``, every transition among the current token's successors, style
markers exactly at ``t % period == period - 1``, and each successor rank's
frequency within 5 binomial standard deviations of its Zipf weight.
``_full_logits`` (a full-sequence forward with no cache) is bf16 in both
frameworks: |diff| <= 2e-2 * max|logit|, as ``tests/test_torch_model.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs import reduced as ref_reduced
from repro.data import synthetic as RS
from repro.models import build_model as ref_build_model
from repro_torch.compat import params_from_jax
from repro_torch.configs import get_arch, reduced
from repro_torch.data import synthetic as TS
from repro_torch.models import build_model

SPECS = [TS.LanguageSpec(vocab=128, seed=7, hard_style=True), TS.LanguageSpec(vocab=512)]


def _ref_spec(spec):
    return RS.LanguageSpec(vocab=spec.vocab, branching=spec.branching,
                           style_period=spec.style_period, seed=spec.seed,
                           hard_style=spec.hard_style)


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: f"V{s.vocab}")
def test_tables_bit_equal_to_reference(spec):
    ref = _ref_spec(spec)
    for port_fn, ref_fn in ((TS.bigram_logits, RS.bigram_logits),
                            (TS.style_permutation, RS.style_permutation),
                            (TS.style_logits, RS.style_logits)):
        p, r = port_fn(spec), np.asarray(ref_fn(ref))
        assert p.shape == r.shape
        np.testing.assert_array_equal(p.numpy(), r)


def _successors(table: torch.Tensor) -> torch.Tensor:
    """[V, K] successor ids of each row, by descending weight (Zipf rank)."""
    K = int((table[0] > -20).sum())
    return torch.topk(table, K, dim=1).indices


@pytest.mark.parametrize("style", [False, True])
@pytest.mark.parametrize("spec", SPECS, ids=lambda s: f"V{s.vocab}")
def test_sample_batch_follows_the_language(spec, style):
    B, S = 64, 64
    gen = torch.Generator().manual_seed(3)
    toks = TS.sample_batch(gen, spec, B, S, style=style, device="cpu")
    assert toks.shape == (B, S + 1) and toks.dtype == torch.int32
    assert bool((toks[:, 0] < spec.vocab - 1).all()) and bool((toks[:, 0] >= 0).all())
    period, marker = spec.style_period, spec.style_marker
    is_marker = torch.tensor([style and t % period == period - 1 for t in range(S + 1)])
    assert bool((toks[:, is_marker] == marker).all())
    assert bool((toks[:, ~is_marker] != marker).all())
    table = TS.style_logits(spec) if (style and spec.hard_style) else TS.bigram_logits(spec)
    succ = _successors(table)
    K = succ.shape[1]
    ranks = []
    for b in range(B):
        cur = int(toks[b, 0])
        for t in range(1, S + 1):
            if is_marker[t]:
                continue            # after a marker the row continues from cur
            nxt = int(toks[b, t])
            hit = (succ[cur] == nxt).nonzero()
            assert hit.numel() == 1, (b, t, cur, nxt)
            ranks.append(int(hit[0, 0]))
            cur = nxt
    n = len(ranks)
    freq = np.bincount(ranks, minlength=K) / n
    zipf = 1.0 / np.arange(1, K + 1)
    p = zipf / zipf.sum()
    sd = np.sqrt(p * (1 - p) / n)
    assert np.all(np.abs(freq - p) <= 5 * sd), (freq, p)


def test_sample_batch_runs_on_the_card_unless_told():
    """The device is the card unless the caller names the CPU; without a
    card, asking for it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.sample_batch(torch.Generator(), SPECS[0], 2, 4)


def test_full_logits_matches_reference():
    cfg = ref_reduced(ref_get_arch("glm4-9b"))
    ref_model = ref_build_model(cfg)
    shapes = jax.eval_shape(ref_model.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def draw(path, s):
        if len(s.shape) >= 2:
            return rng.standard_normal(s.shape) * s.shape[-2] ** -0.5
        if "bias" in jax.tree_util.keystr(path):
            return rng.standard_normal(s.shape) * 0.1
        return 1.0 + 0.1 * rng.standard_normal(s.shape)

    ref_params = jax.tree_util.tree_map_with_path(
        lambda p, s: jnp.asarray(draw(p, s).astype(np.float32)).astype(jnp.bfloat16), shapes)
    model = build_model(reduced(get_arch("glm4-9b")), device="cpu")
    params = params_from_jax(jax.device_get(ref_params))
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (3, 12)).astype(np.int32)
    ref = np.asarray(RS._full_logits(ref_model, ref_params,
                                     {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}))
    port = TS._full_logits(model, params, {"tokens": torch.from_numpy(toks)})
    assert port.shape == ref.shape == (3, 12, cfg.vocab_size) and port.dtype == torch.float32
    assert np.abs(port.numpy() - ref).max() <= 2e-2 * np.abs(ref).max()
    # the last position is what the cached prefill computes
    last, _ = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    assert (port[:, -1] - last.float()).abs().max() <= 2e-2 * np.abs(ref).max()

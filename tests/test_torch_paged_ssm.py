"""The Mamba-2 (SSM) family on repro_torch's paged, chunked, prefix-cached
and speculative engines, against the JAX reference and inside the port, on
the CPU (reduced Mamba2-780M: d_model 64, 2 layers, ``ssm_chunk`` 32).
Inputs are numpy draws from fixed seeds, carried to the port by
``params_from_jax``.

Tolerances, and what sets them:

* ``_causal_conv``'s history as of row ``valid[b]``: bit-equal to the
  reference's (a gather of the same rows).
* ``mamba_prefill_chunk`` and ``mamba_verify_chunk`` on float32 weights
  and inputs: state and output |diff| <= 1e-5 (|ref| + max|ref|), the
  bound of ``mamba_decode`` in ``tests/test_torch_ssm.py`` (the SSD sums in
  another order, ``exp`` an ulp apart); conv histories bit-equal.
* Inside the port, exact: pad rows are no-ops (other pad values, the same
  bits), a ``valid == 0`` slot keeps its state, verify row ``j`` is ``j +
  1`` decode steps, and a chunked prefill on the ``ssm_chunk`` grid gives
  the one-shot prefill's logits and state.
* Greedy tokens of each engine mode equal the reference engine's up to
  each request's first step whose top-2 margin is within 2e-2 of the logit
  scale (the bf16 rule of ``tests/test_torch_ssm_serve.py``), at least
  ``HELD`` of them; inside the port each mode's tokens equal the
  contiguous engine's, token for token.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import QuantConfig as RefQuantConfig
from repro.configs import get_arch as ref_get_arch
from repro.configs import reduced as ref_reduced
from repro.engine import Engine as RefEngine
from repro.models import build_model as ref_build_model
from repro.models import ssm as RS
from repro.quantize import quantize as ref_quantize
from repro_torch.compat import params_from_jax
from repro_torch.configs import get_arch, reduced
from repro_torch.engine import Engine
from repro_torch.models import build_model
from repro_torch.models import lm as TL
from repro_torch.models import ssm as TS

TOL = 2e-2
HELD = 8        # of the 18 greedy tokens defined across frameworks (8 at these draws)
# the reference's pure-SSM chunked case (tests/test_engine_paged.py):
# prompt lengths, chunk_size, cache_len; numpy seeds for the tokens
LENS, CHUNK, CACHE_LEN = [9, 40, 12], 32, 48
PROMPTS = [np.random.default_rng(60 + i).integers(0, 512, L).astype(np.int32)
           for i, L in enumerate(LENS)]
MODES = {"paged": dict(paged=True), "chunked": dict(paged=True, chunk_size=CHUNK),
         "prefix": dict(paged=True, chunk_size=CHUNK, prefix_cache=True),
         "spec": dict(paged=True, n_spec=2),
         "spec-composed": dict(paged=True, n_spec=2, chunk_size=CHUNK, prefix_cache=True)}


def _draw(rng, path, s):
    """Fan-in scaled matrices, conv taps, and the SSM time constants away
    from their inits (``tests/test_torch_ssm.py``'s draw)."""
    name = jax.tree_util.keystr(path)
    if "a_log" in name:
        return 0.5 * rng.standard_normal(s.shape)
    if "dt_bias" in name:
        return -1.0 + 0.5 * rng.standard_normal(s.shape)
    if len(s.shape) >= 2:
        return rng.standard_normal(s.shape) * (0.3 if "conv" in name else s.shape[-2] ** -0.5)
    return 1.0 + 0.1 * rng.standard_normal(s.shape)


def _ref_params(cfg, seed):
    shapes = jax.eval_shape(ref_build_model(cfg).init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: jnp.asarray(_draw(rng, p, s).astype(np.float32)).astype(s.dtype), shapes)


@pytest.fixture(scope="module")
def bf16():
    """(reference model, its bf16 params, its AbsMax draft tree, port model,
    its params, the draft brought across)."""
    cfg = ref_reduced(ref_get_arch("mamba2-780m"))
    rp = _ref_params(cfg, 0)
    ref_draft, _ = ref_quantize(rp, None, RefQuantConfig(method="absmax", granularity="channel"),
                                mode="storage", out_dtype="bfloat16")
    model = build_model(reduced(get_arch("mamba2-780m")), device="cpu")
    return (ref_build_model(cfg), rp, ref_draft, model, params_from_jax(jax.device_get(rp)),
            params_from_jax(jax.device_get(ref_draft)))


@pytest.fixture(scope="module")
def f32():
    """Layer 1 of a float32 tree in both frameworks, and the port's config."""
    cfg = dataclasses.replace(ref_reduced(ref_get_arch("mamba2-780m")), dtype="float32")
    rp = _ref_params(cfg, 1)
    params = params_from_jax(jax.device_get(rp))
    return (cfg, jax.tree.map(lambda a: a[1], rp["stack"]["L0"]["mamba"]),
            TL.layer_view(params["stack"]["L0"]["mamba"], 1),
            dataclasses.replace(reduced(get_arch("mamba2-780m")), dtype="float32"))


@pytest.fixture(scope="module")
def contiguous(bf16):
    """The port's contiguous engine's tokens for ``PROMPTS``, 6 each."""
    model, params = bf16[3], bf16[4]
    return Engine(model, params, slots=2, cache_len=CACHE_LEN, k_steps=3).serve(
        PROMPTS, gen_tokens=6)


@pytest.fixture(scope="module")
def served(bf16):
    """Each mode's serves of ``PROMPTS`` (6 tokens each), once per module:
    ``served(mode)`` -> [(outputs, stats, blocks the index holds after)]
    for one serve, or a cold and a warm one of a prefix-cached engine.  The
    reference comparison reads the first, the in-port one all."""
    model, params, draft = bf16[3], bf16[4], bf16[5]
    done = {}

    def get(mode):
        if mode not in done:
            kw = dict(slots=2, cache_len=CACHE_LEN, k_steps=3, block_size=8,
                      check_invariants=True, **MODES[mode])
            eng = Engine(model, params, draft_params=draft if kw.get("n_spec") else None, **kw)
            done[mode] = [(*eng.serve(PROMPTS, gen_tokens=6, return_stats=True),
                           set(eng._hold_blocks))
                          for _ in range(2 if kw.get("prefix_cache") else 1)]
        return done[mode]

    return get


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(port, ref, rtol):
    p, r = _np(port), _np(ref)
    np.testing.assert_array_less(np.abs(p - r), rtol * (np.abs(r) + np.abs(r).max()) + 1e-30)


def _held(model, params, prompt, continuation) -> int:
    """How many leading greedy steps of ``continuation`` (teacher-forced
    through the port's model) have a top-2 logit gap above ``TOL`` of
    max|logit|: the tokens defined across frameworks."""
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(prompt)[None]})
    for n, tok in enumerate(continuation):
        lf = logits.float()[0]
        top = torch.topk(lf, 2).values
        if float(top[0] - top[1]) <= TOL * float(lf.abs().max()):
            return n
        logits, cache = model.decode_step(params, torch.tensor([[tok]], dtype=torch.int32),
                                          cache)
    return len(continuation)


def _chunk_inputs(cfg, C, valid, seed=7):
    """A random state of ``len(valid)`` slots, a chunk of ``C`` fp32 rows and
    ``valid``."""
    rng = np.random.default_rng(seed)
    B = len(valid)
    cache = {"h": rng.standard_normal((B, cfg.n_ssm_heads, cfg.ssm_head_dim,
                                       cfg.ssm_state)).astype(np.float32),
             "conv_x": rng.standard_normal((B, 3, cfg.resolved_d_inner)).astype(np.float32),
             "conv_bc": rng.standard_normal((B, 3, 2 * cfg.ssm_state)).astype(np.float32)}
    x = rng.standard_normal((B, C, cfg.d_model)).astype(np.float32)
    dtypes = {"h": (jnp.float32, torch.float32), "conv_x": (jnp.bfloat16, torch.bfloat16),
              "conv_bc": (jnp.bfloat16, torch.bfloat16)}
    ref_cache = {k: jnp.asarray(v).astype(dtypes[k][0]) for k, v in cache.items()}
    port_cache = {k: torch.from_numpy(_np(v).copy()).to(dtypes[k][1])
                  for k, v in ref_cache.items()}
    return x, np.asarray(valid, np.int32), ref_cache, port_cache


# ---------------------------------------------------------------------------
# The two chunk forms
# ---------------------------------------------------------------------------

def test_causal_conv_valid_history_matches_reference():
    """The conv history after a right-padded chunk is the K-1 rows before
    row ``valid[b]``: the carried history for ``valid == 0``, the chunk's
    last rows for a full one."""
    rng = np.random.default_rng(2)
    B, S, C, K = 4, 13, 48, 4
    x, w, b, st = (rng.standard_normal(s).astype(np.float32)
                   for s in ((B, S, C), (K, C), (C,), (B, K - 1, C)))
    valid = np.asarray([0, 2, 7, S], np.int32)
    ro, rs = RS._causal_conv(*map(jnp.asarray, (x, w, b, st)), valid=jnp.asarray(valid))
    po, ps = TS._causal_conv(*map(torch.from_numpy, (x, w, b, st)),
                             valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))
    ext = np.concatenate([st, x], axis=1)
    for i, v in enumerate(valid):
        np.testing.assert_array_equal(ps[i].numpy(), ext[i, v:v + K - 1])
    _, full = TS._causal_conv(*map(torch.from_numpy, (x, w, b, st)))
    np.testing.assert_array_equal(ps[3].numpy(), full[3].numpy())
    np.testing.assert_array_equal(po.numpy(), TS._causal_conv(
        *map(torch.from_numpy, (x, w, b, st)))[0].numpy())


@pytest.mark.parametrize("form", ["prefill", "verify"])
def test_chunk_forms_match_reference(f32, form):
    """``mamba_prefill_chunk`` / ``mamba_verify_chunk`` on a chunk of 40 rows
    (crossing the SSD chunk of 32) for three slots at ``valid`` 40, 5 and 0."""
    cfg, rlayer, player, pcfg = f32
    x, valid, ref_cache, port_cache = _chunk_inputs(cfg, 40, [40, 5, 0])
    rfn, pfn = {"prefill": (RS.mamba_prefill_chunk, TS.mamba_prefill_chunk),
                "verify": (RS.mamba_verify_chunk, TS.mamba_verify_chunk)}[form]
    ry, rc = rfn(rlayer, jnp.asarray(x), jnp.asarray(x), cfg, ref_cache, jnp.asarray(valid))
    xt = torch.from_numpy(x)
    py, pc = pfn(player, xt, xt, pcfg, port_cache, torch.from_numpy(valid))
    for b, v in enumerate(valid):       # rows past valid are garbage in both
        if v:
            _close(py[b, :v], ry[b, :v], 1e-5)
    _close(pc["h"], rc["h"], 1e-5)
    for k in ("conv_x", "conv_bc"):
        assert pc[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(pc[k]), _np(rc[k]))
    # a valid == 0 slot keeps its state, bit for bit
    for k in ("h", "conv_x", "conv_bc"):
        np.testing.assert_array_equal(_np(pc[k][2]), _np(port_cache[k][2]))


@pytest.mark.parametrize("form", ["prefill", "verify"])
def test_pad_rows_are_no_ops(f32, form):
    """Other values in the pad rows change no bit of the real rows' output
    or of the state."""
    cfg, _, player, pcfg = f32
    fn = TS.mamba_prefill_chunk if form == "prefill" else TS.mamba_verify_chunk
    x, valid, _, port_cache = _chunk_inputs(cfg, 36, [36, 9, 0])
    x2 = x.copy()
    x2[1, 9:] = np.random.default_rng(3).standard_normal(x2[1, 9:].shape) * 5
    x2[2] = -x2[2]
    outs = [fn(player, torch.from_numpy(a), torch.from_numpy(a), pcfg,
               {k: v.clone() for k, v in port_cache.items()}, torch.from_numpy(valid))
            for a in (x, x2)]
    (y1, c1), (y2, c2) = outs
    np.testing.assert_array_equal(y1[0].numpy(), y2[0].numpy())
    np.testing.assert_array_equal(y1[1, :9].numpy(), y2[1, :9].numpy())
    for k in c1:
        np.testing.assert_array_equal(_np(c1[k]), _np(c2[k]))


def test_verify_rows_are_decode_steps(bf16):
    """Row ``j`` of ``mamba_verify_chunk`` and the state after ``valid``
    rows are what ``j + 1`` successive ``mamba_decode`` calls give, bit for
    bit, on the bf16 model's layer 1 and bf16 activations at the engine
    tests' shape (2 slots, ``n_spec + 1 = 3`` rows; PERF.md decision a: the
    CPU's bf16 product may round a row otherwise at other row counts)."""
    model, params = bf16[3], bf16[4]
    pcfg = model.cfg
    player = TL.layer_view(params["stack"]["L0"]["mamba"], 1)
    x, valid, _, port_cache = _chunk_inputs(pcfg, 3, [3, 2], seed=9)
    xt = torch.from_numpy(x).bfloat16()
    vy, vc = TS.mamba_verify_chunk(player, xt, xt, pcfg,
                                   {k: v.clone() for k, v in port_cache.items()},
                                   torch.from_numpy(valid))
    dc = {k: v.clone() for k, v in port_cache.items()}
    for j in range(3):
        keep = torch.from_numpy(j < valid)
        dy, dc = TS.mamba_decode(player, xt[:, j:j + 1], dc, pcfg, keep=keep)
        for b in range(2):
            if j < valid[b]:
                assert torch.equal(vy[b, j], dy[b, 0]), (b, j)
    for k in dc:
        np.testing.assert_array_equal(_np(vc[k]), _np(dc[k]))


def test_chunked_prefill_on_the_grid_equals_one_shot(bf16):
    """``prefill_chunk_paged`` in pieces of ``ssm_chunk`` rows, beside a
    slot that sits every piece out, gives ``Model.prefill``'s logits and
    state bit for bit; the idle slot's state is untouched."""
    model, params = bf16[3], bf16[4]
    prompt = torch.from_numpy(np.random.default_rng(5).integers(0, 512, 77).astype(np.int32))
    logits, one = model.prefill(params, {"tokens": prompt[None]})
    cache = model.init_paged_cache(2, 96, block_size=8, num_blocks=24)
    idle = {k: torch.randn(v.shape).to(v.dtype) for k, v in cache["stack"]["L0"].items()}
    for k, v in idle.items():
        cache["stack"]["L0"][k][:, 1] = v[:, 1]
    Q = model.cfg.ssm_chunk
    for start in range(0, 77, Q):
        n = min(Q, 77 - start)
        toks = torch.zeros((2, Q), dtype=torch.int32)
        toks[0, :n] = prompt[start:start + n]
        out, cache = model.prefill_chunk_paged(params, toks, cache,
                                               torch.tensor([start, 0]), torch.tensor([n, 0]))
    assert torch.equal(out[0], logits[0])
    assert cache["lengths"].tolist() == [77, 0]
    for k, v in cache["stack"]["L0"].items():
        assert torch.equal(v[:, 0], one["stack"]["L0"][k][:, 0]), k
        assert torch.equal(v[:, 1], idle[k][:, 1]), k


# ---------------------------------------------------------------------------
# The engines
# ---------------------------------------------------------------------------

# against the reference, the chunked, prefix-cached engine and the
# speculative one; the one-shot paged and the composed engines meet the
# reference through the contiguous engine (each == it inside the port,
# ``test_engine_modes_equal_contiguous``, which matches the reference's).
# Each reference engine compiles for seconds.
@pytest.mark.parametrize("mode", ["prefix", "spec"])
def test_engine_modes_match_reference_engine(bf16, served, mode):
    """Each paged engine mode's greedy tokens equal the reference engine's
    (the same mode, its AbsMax draft for speculation) up to each request's
    first step whose top-2 margin is within the bf16 rule; the token
    counters agree, and the prefix-cached modes count no hit in either."""
    ref_model, rp, ref_draft, model, params, _ = bf16
    kw = dict(slots=2, cache_len=CACHE_LEN, k_steps=3, block_size=8, **MODES[mode])
    ref_out, rs = RefEngine(ref_model, rp, draft_params=ref_draft if kw.get("n_spec") else None,
                            **kw).serve([jnp.asarray(p) for p in PROMPTS], gen_tokens=6,
                                        return_stats=True)
    outs, stats, _ = served(mode)[0]
    held = 0
    for p, out, ref in zip(PROMPTS, outs, ref_out):
        ref = list(map(int, ref))
        n = _held(model, params, p, ref)
        assert out[:n] == ref[:n]
        held += n
    assert held >= HELD, held
    assert stats["counters"]["tokens"] == rs["counters"]["tokens"]
    if kw.get("prefix_cache"):
        assert stats["prefix_hits"] == rs["prefix_hits"] == 0


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_modes_equal_contiguous(contiguous, served, mode):
    """Inside the port every mode's tokens equal the contiguous engine's,
    token for token, with conservation checked after every admission and
    dispatch; a prefix-cached engine serves twice (cold, then warm from its
    kept cache) with zero hits, every prompt token prefilled both times; a
    speculative one accepts some drafts and counts drafted == accepted +
    rejected."""
    kw = MODES[mode]
    for outs, stats, holds in served(mode):
        assert outs == contiguous
        if kw.get("prefix_cache"):
            assert stats["prefix_hits"] == stats["counters"]["prefix_hit_tokens"] == 0
            assert stats["prefill_tokens"] == sum(LENS) and not holds
    if kw.get("n_spec"):
        c = stats["counters"]
        assert c["drafted"] == c["accepted"] + c["rejected"] and 0 < c["accepted"]


def test_chunk_size_off_the_ssm_grid_raises(bf16):
    """``chunk_size`` (or the prefix cache's default ``4 * block_size``)
    must be a multiple of ``ssm_chunk``, with the reference's message; a
    chunk size without the paged engine is refused first, as before."""
    ref_model, rp, _, model, params, _ = bf16
    for kw in (dict(chunk_size=16), dict(prefix_cache=True, block_size=4),
               dict(chunk_size=48, prefix_cache=True)):
        msgs = []
        for eng, m, p in ((RefEngine, ref_model, rp), (Engine, model, params)):
            with pytest.raises(ValueError, match="multiple of ssm_chunk 32") as e:
                eng(m, p, slots=2, cache_len=64, paged=True, **kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="need paged=True"):
        Engine(model, params, slots=2, cache_len=64, chunk_size=32)

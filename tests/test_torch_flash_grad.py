"""The flash backward of ``repro_torch.models.flash`` against the reference's
custom VJP (``jax.vjp`` of ``repro.models.flash.flash_attention``).

Cases cover several tiles in q and kv, grouped heads (G > 1), causal and
not, a sliding window, a logit softcap, nonzero q offsets and padded kv
rows.  Tolerances: float32 inputs, |dX_port - dX_ref| <= 2e-6 *
max|dX_ref| for the output and each of dq, dk, dv (fp32 sums in another
order; 3e-7 measured); bfloat16 inputs, <= 4e-3 * max|dX_ref|, one bf16
ulp at the largest value (the gradients are rounded to bf16; equal
measured).  The forward's bits are the same with grad and without, and a
float64 ``gradcheck`` holds the backward to the forward's own derivative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.flash import flash_attention as ref_flash
from repro_torch.models.flash import flash_attention

# (name, B, Sq, Skv, Kv, G, hd, cq, ck, causal, window, softcap, q_off, kv_len)
CASES = [
    ("causal", 2, 24, 24, 2, 3, 8, 8, 8, True, 0, 0.0, (0, 0), (24, 24)),
    ("padded", 2, 16, 32, 2, 2, 8, 8, 16, False, 0, 0.0, (0, 0), (32, 19)),
    ("window-softcap", 1, 24, 24, 1, 4, 16, 8, 8, True, 5, 3.0, (0,), (24,)),
    ("offsets", 2, 16, 32, 2, 3, 8, 8, 8, True, 0, 0.0, (8, 3), (24, 19)),
]


def _inputs(case, dtype, seed=0):
    _, B, Sq, Skv, Kv, G, hd, *_rest = case
    q_off, kv_len = case[12], case[13]
    rng = np.random.RandomState(seed)
    q = rng.randn(B, Sq, Kv, G, hd).astype(np.float32)
    k = rng.randn(B, Skv, Kv, hd).astype(np.float32)
    v = rng.randn(B, Skv, Kv, hd).astype(np.float32)
    dout = rng.randn(B, Sq, Kv, G, hd).astype(np.float32)
    mask = (np.arange(Skv)[None] < np.asarray(kv_len)[:, None]).astype(np.float32)
    if dtype == "bfloat16":   # round to bf16 once, so both frameworks see the same values
        q, k, v, dout = (torch.from_numpy(a).bfloat16().float().numpy() for a in (q, k, v, dout))
    return q, k, v, dout, mask, np.asarray(q_off, np.int32), np.zeros(B, np.int32)


def _ref_grads(case, arrays, dtype):
    q, k, v, dout, mask, q_off, kv_off = arrays
    causal, window, softcap, cq, ck = case[9], case[10], case[11], case[7], case[8]
    jdt = jnp.dtype(dtype)
    f = lambda q_, k_, v_: ref_flash(q_, k_, v_, jnp.asarray(mask), jnp.asarray(q_off),
                                     jnp.asarray(kv_off), causal, window, softcap, cq, ck)
    out, vjp = jax.vjp(f, *(jnp.asarray(a, jdt) for a in (q, k, v)))
    grads = vjp(jnp.asarray(dout, jdt))
    return (np.asarray(out, np.float32), *(np.asarray(g, np.float32) for g in grads))


def _port_grads(case, arrays, dtype):
    q, k, v, dout, mask, q_off, kv_off = arrays
    causal, window, softcap, cq, ck = case[9], case[10], case[11], case[7], case[8]
    tdt = getattr(torch, dtype)
    qkv = [torch.from_numpy(a).to(tdt).requires_grad_(True) for a in (q, k, v)]
    out = flash_attention(*qkv, torch.from_numpy(mask), torch.from_numpy(q_off),
                                torch.from_numpy(kv_off), causal, window, softcap, cq, ck)
    grads = torch.autograd.grad(out, qkv, torch.from_numpy(dout).to(tdt))
    assert all(g.dtype == tdt for g in grads)
    return (out.detach().float().numpy(), *(g.float().numpy() for g in grads))


RUNS = [(c, "float32") for c in CASES] + [(CASES[0], "bfloat16"), (CASES[2], "bfloat16")]


@pytest.mark.parametrize("case,dtype", RUNS, ids=lambda r: r if isinstance(r, str) else r[0])
def test_flash_grads_match_reference(case, dtype):
    arrays = _inputs(case, dtype)
    ref, port = _ref_grads(case, arrays, dtype), _port_grads(case, arrays, dtype)
    tol = 2e-6 if dtype == "float32" else 4e-3
    for name, r, p in zip(("out", "dq", "dk", "dv"), ref, port):
        assert np.abs(p - r).max() <= tol * np.abs(r).max(), (name, np.abs(p - r).max())


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_forward_bits_do_not_depend_on_grad(case):
    q, k, v, _, mask, q_off, kv_off = (torch.from_numpy(a) for a in _inputs(case, "float32"))
    args = (mask, q_off, kv_off) + tuple(case[9:12]) + tuple(case[7:9])
    q16, k16, v16 = (t.bfloat16() for t in (q, k, v))
    for qq, kk, vv in ((q, k, v), (q16, k16, v16)):
        with torch.no_grad():
            plain = flash_attention(qq, kk, vv, *args)
        trained = flash_attention(qq.clone().requires_grad_(True), kk, vv, *args)
        assert trained.requires_grad and torch.equal(plain, trained.detach())


def test_flash_backward_gradcheck_float64():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 4, 1, 2, 4, dtype=torch.float64, generator=g, requires_grad=True)
    k = torch.randn(1, 6, 1, 4, dtype=torch.float64, generator=g, requires_grad=True)
    v = torch.randn(1, 6, 1, 4, dtype=torch.float64, generator=g, requires_grad=True)
    mask = torch.tensor([[1.0, 1, 1, 1, 1, 0]])
    off = torch.tensor([2], dtype=torch.int32)
    zero = torch.zeros(1, dtype=torch.int32)
    f = lambda q_, k_, v_: flash_attention(q_, k_, v_, mask, off, zero, True, 0, 2.5, 2, 2)
    assert torch.autograd.gradcheck(f, (q, k, v))

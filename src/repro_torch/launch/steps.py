"""Train, prefill and (deprecated) serve steps.

Port of ``repro/launch/steps.py``.  ``make_train_step`` builds the training
step: loss and gradients (``Model.loss_fn`` under ``tc.remat``, gradients
by ``torch.autograd.grad`` with respect to every parameter leaf, in the
parameters' dtypes), optional microbatch accumulation (fp32 accumulators,
then a multiply by ``1/n``), optional int8 error-feedback gradient
compression, and the AdamW update.  The step writes the new state into the
one it is given (the torch counterpart of the reference's donated state)
and reads nothing back to the host: every metric is a device tensor.

``make_prefill_step`` is the prefill a dry run would time;
``make_serve_step`` is a deprecated greedy shim over the serving engine's
decode step (``repro_torch.engine``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core.policy import tree_leaves_with_path, tree_map
from repro_torch.optim import adamw_update, compress_grads, init_error_state, init_opt_state


def init_train_state(model, tc: TrainConfig, gen: torch.Generator, params=None) -> dict:
    """Parameters (``model.init(gen)``, or ``params`` as given) with their
    optimizer state and, under ``int8_ef`` compression, the error state."""
    params = model.init(gen) if params is None else params
    state = {"params": params, "opt": init_opt_state(params, tc)}
    if tc.grad_compress == "int8_ef":
        state["err"] = init_error_state(params)
    return state


def _unflatten(tree, leaves: list):
    """A tree of ``tree``'s layout holding ``leaves``, given in its flatten
    order (sorted keys, ``tree_leaves_with_path``'s)."""
    it = iter(leaves)
    out = tree_map(lambda _: None, tree)

    def fill(dst, src):
        for k in sorted(src):
            if isinstance(src[k], dict):
                fill(dst[k], src[k])
            else:
                dst[k] = next(it)
    fill(out, tree)
    return out


def _split_microbatches(batch: dict, n: int) -> list[dict]:
    return [{k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i] for k, v in batch.items()}
            for i in range(n)]


def make_train_step(model, tc: TrainConfig):
    n_micro = tc.microbatch if tc.microbatch > 1 else 0

    def grad_fn(params, batch):
        leaves = [p.detach().requires_grad_(True) for _, p in tree_leaves_with_path(params)]
        loss, metrics = model.loss_fn(_unflatten(params, leaves), batch, remat=tc.remat)
        grads = torch.autograd.grad(loss, leaves)
        return _unflatten(params, list(grads)), {k: v.detach() for k, v in metrics.items()}

    def compute_grads(params, batch):
        if not n_micro:
            return grad_fn(params, batch)
        g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                         params)
        m_acc = None
        for mb in _split_microbatches(batch, n_micro):
            g, m = grad_fn(params, mb)
            for (_, a), (_, b) in zip(tree_leaves_with_path(g_acc), tree_leaves_with_path(g)):
                a += b.float()
            m_acc = m if m_acc is None else {k: m_acc[k] + m[k] for k in m}
            del g
        inv = 1.0 / n_micro
        return tree_map(lambda x: x * inv, g_acc), {k: v * inv for k, v in m_acc.items()}

    def train_step(state: dict, batch: dict):
        params = state["params"]
        grads, metrics = compute_grads(params, batch)
        if "err" in state:
            grads, state["err"] = compress_grads(grads, state["err"])
        _, state["opt"], stats = adamw_update(params, grads, state["opt"], tc)
        return state, {**metrics, **stats}

    return train_step


def make_serve_step(model):
    """DEPRECATED: one batched greedy decode step, ``(params, tokens, cache)
    -> (next_tok, logits, cache)``; serve through ``repro_torch.engine``."""
    import warnings
    warnings.warn("make_serve_step is deprecated; use "
                  "repro_torch.engine.scheduler.make_decode_step", DeprecationWarning,
                  stacklevel=2)
    from repro_torch.engine.scheduler import make_decode_step
    step = make_decode_step(model)  # greedy SamplingParams

    def serve_step(params, tokens, cache):
        next_tok, logits, cache = step(params, tokens, cache)
        return next_tok, logits, cache
    return serve_step


def make_prefill_step(model, cache_len: int):
    def prefill_step(params, batch):
        return model.prefill(params, batch, cache_len=cache_len)
    return prefill_step

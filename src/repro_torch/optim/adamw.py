"""AdamW with linear warmup and cosine decay, global-norm clipping, an fp32
master copy for low-precision trees, and optional 8-bit (block-quantized)
moments.

Port of ``repro/optim/adamw.py``.  State layout per parameter leaf:
  float32 / bfloat16 : {"m": <dtype>, "v": <dtype>}
  int8               : {"m": int8 [..., nb, BLOCK], "m_scale": fp32 [..., nb, 1],
                        "v": int8, "v_scale": fp32}   (v stores sqrt(v))
plus ``{"step": int32 0-d}`` and, when any parameter is not float32,
``{"master": fp32 copy of the tree}``.

The update writes its results into the state it is given: the parameter
tensors take the new weights in place, and each leaf's moment (and master)
entry is replaced as soon as that leaf is done, so the old and new state
never coexist (the torch counterpart of the reference's donated step state;
at full width the state is most of the card).  The arithmetic is the
reference's jitted program's, op for op: constant divisors are reciprocal
multiplies (``_q8``'s ``amax / 127``), the compander's square root is
correctly rounded, and nothing is read back to the host.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core.formats import f32_reciprocal
from repro_torch.core.policy import tree_leaves_with_path, tree_map

BLOCK = 256
_INV127 = f32_reciprocal(127.0)


# ---------------------------------------------------------------------------
# int8 moment (de)quantization
# ---------------------------------------------------------------------------

def _q8(x: torch.Tensor):
    """fp32 -> (int8 [..., nb, BLOCK], fp32 scales [..., nb, 1]), blocks along
    the last axis only (the moments keep the parameter's leading layout)."""
    L = x.shape[-1]
    nb = -(-L // BLOCK)
    if nb * BLOCK != L:
        x = torch.nn.functional.pad(x, (0, nb * BLOCK - L))
    xb = x.reshape(*x.shape[:-1], nb, BLOCK)
    scale = xb.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) * _INV127
    q = torch.round(xb / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def _dq8(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    xb = q.float() * scale
    return xb.reshape(*xb.shape[:-2], xb.shape[-2] * BLOCK)[..., : shape[-1]]


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (XLA's; the CPU's float32
    ``torch.sqrt`` is not on every input)."""
    return torch.sqrt(x.double()).float()


# ---------------------------------------------------------------------------
# Schedule
# ---------------------------------------------------------------------------

def lr_schedule(tc: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to 10% of peak (``step`` a 0-d tensor)."""
    step = step.float()
    warm = (step / max(tc.warmup_steps, 1)).clamp_max(1.0)
    prog = ((step - tc.warmup_steps) / max(tc.total_steps - tc.warmup_steps, 1)).clamp(0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return tc.learning_rate * warm * (0.1 + 0.9 * cos)


# ---------------------------------------------------------------------------
# Init / update
# ---------------------------------------------------------------------------

def init_opt_state(params: Any, tc: TrainConfig) -> dict:
    """Zero moments, step 0 and, for a tree with any non-float32 leaf, an
    fp32 master copy that the updates accumulate in (bf16 weights would
    round updates near their resolution away)."""
    int8 = tc.opt_state_dtype == "int8"

    def leaf_state(p):
        if int8:
            qm, sm = _q8(torch.zeros(p.shape, dtype=torch.float32, device=p.device))
            return {"m": qm, "m_scale": sm, "v": qm.clone(), "v_scale": sm.clone()}
        dt = getattr(torch, tc.opt_state_dtype)
        return {"m": torch.zeros(p.shape, dtype=dt, device=p.device),
                "v": torch.zeros(p.shape, dtype=dt, device=p.device)}

    leaves = [p for _, p in tree_leaves_with_path(params)]
    state = {"mu": tree_map(leaf_state, params),
             "step": torch.zeros((), dtype=torch.int32, device=leaves[0].device)}
    if any(p.dtype != torch.float32 for p in leaves):
        state["master"] = tree_map(lambda p: p.float(), params)
    return state


def global_norm(tree: Any) -> torch.Tensor:
    total = 0
    for _, leaf in tree_leaves_with_path(tree):
        total = total + leaf.float().square().sum()
    return torch.sqrt(total)


def _at(tree: dict, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def adamw_update(params: Any, grads: Any, opt_state: dict, tc: TrainConfig):
    """One AdamW step, in place: ``params``' tensors take the new weights and
    ``opt_state``'s entries the new moments, master and step.  Returns
    ``(params, opt_state, stats)`` with ``stats = {"lr", "grad_norm"}``
    (device tensors)."""
    step = opt_state["step"] + 1
    lr = lr_schedule(tc, step)
    gnorm = global_norm(grads)
    if tc.grad_clip > 0:   # a true division (``scalar / tensor`` multiplies by a reciprocal)
        clip = (torch.full_like(gnorm, tc.grad_clip) / gnorm.clamp_min(1e-12)).clamp_max(1.0)
    else:
        clip = torch.ones((), dtype=torch.float32, device=gnorm.device)
    b1, b2 = tc.b1, tc.b2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    int8 = tc.opt_state_dtype == "int8"
    master = opt_state.get("master")

    for path, p in list(tree_leaves_with_path(params)):
        g = _at(grads, path).float() * clip
        s = _at(opt_state["mu"], path)
        if int8:
            m = _dq8(s["m"], s["m_scale"], p.shape)
            v = _dq8(s["v"], s["v_scale"], p.shape) ** 2
        else:
            m, v = s["m"].float(), s["v"].float()
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * g * g
        del g
        upd = (m / bc1) / (torch.sqrt(v / bc2) + 1e-8)
        wd = tc.weight_decay if p.ndim >= 2 else 0.0   # no decay on norms / biases
        base = p.float() if master is None else _at(master, path)
        new_w = base - lr * (upd + wd * base)
        del upd, base
        if int8:
            s["m"], s["m_scale"] = _q8(m)
            s["v"], s["v_scale"] = _q8(_sqrt(v))
        else:
            s["m"], s["v"] = m.to(s["m"].dtype), v.to(s["v"].dtype)
        del m, v
        p.copy_(new_w)
        if master is not None:
            _at(master, path[:-1])[path[-1]] = new_w
        del new_w
    opt_state["step"] = step
    return params, opt_state, {"lr": lr, "grad_norm": gnorm}

"""Row-wise 8-bit Adam (twin of ``repro/optim/adam8bit.py``; the Dettmers
et al., arXiv:2110.02861 regime).

Both moments are int8 with one fp32 scale per last-axis row: about 5 bytes a
parameter with bf16 weights against 10 with fp32 moments.  ``torch.round``
rounds half to even, as ``jnp.round`` does, so the codes match the JAX
package's wherever the scaled moment is not within rounding of a half.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.common.pytree import tree_global_norm, tree_map
from repro_torch.optim.adam import (_device, bias_corrections, clip_by_global_norm,
                                    learning_rate, unzip3)


class Q8(NamedTuple):
    q: torch.Tensor       # int8, the moment's shape
    scale: torch.Tensor   # fp32, shape[:-1] (one a last-axis row)


def _quantize(x: torch.Tensor) -> Q8:
    scale = torch.clamp(torch.amax(torch.abs(x), dim=-1), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127).to(torch.int8)
    return Q8(q, scale.float())


def _dequantize(s: Q8) -> torch.Tensor:
    return s.q.float() * s.scale[..., None]


class Opt8State(NamedTuple):
    step: torch.Tensor
    mu: Any    # pytree of Q8
    nu: Any


def adam8_init(params: Any) -> Opt8State:
    z = lambda p: Q8(torch.zeros(p.shape, dtype=torch.int8, device=p.device),
                     torch.full(p.shape[:-1], 1e-12, dtype=torch.float32, device=p.device))
    return Opt8State(step=torch.zeros((), dtype=torch.int32, device=_device(params)),
                     mu=tree_map(z, params), nu=tree_map(z, params))


def _is_q8(x) -> bool:
    return isinstance(x, Q8)


def adam8_update(grads, state: Opt8State, params, *, lr=1e-3, b1=0.9, b2=0.999,
                 eps=1e-8, weight_decay=0.0, grad_clip: float | None = 1.0,
                 grad_norm: torch.Tensor | None = None):
    """Returns (new_params, new_state, metrics); ``grad_norm`` as in
    ``adam_update``."""
    if grad_clip is not None:
        grads, gnorm = clip_by_global_norm(grads, grad_clip, grad_norm)
    else:
        gnorm = tree_global_norm(grads) if grad_norm is None else grad_norm
    step = state.step + 1
    lr_t = learning_rate(lr, step)
    b1c, b2c = bias_corrections(step, b1, b2)

    def upd(p, g, m8, v8):
        g32 = g.float()
        m = b1 * _dequantize(m8) + (1 - b1) * g32
        v = b2 * _dequantize(v8) + (1 - b2) * g32.square()
        delta = (m / b1c) / (torch.sqrt(v / b2c) + eps)
        if weight_decay:
            delta = delta + weight_decay * p.float()
        new_p = (p.float() - lr_t * delta).to(p.dtype)
        return new_p, _quantize(m), _quantize(v)

    out = tree_map(upd, params, grads, state.mu, state.nu, is_leaf=_is_q8)
    new_p, new_m, new_v = unzip3(
        out, is_leaf=lambda x: isinstance(x, tuple) and len(x) == 3 and not _is_q8(x))
    return new_p, Opt8State(step, new_m, new_v), {"grad_norm": gnorm, "lr": lr_t}

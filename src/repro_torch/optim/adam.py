"""Adam with global-norm gradient clipping on flat dicts of tensors (twin of
``repro/optim/adam.py``; the paper's App. A trainer: lr 3e-3, clip 0.5).

Parameters, gradients and moments are dicts keyed by the JAX leaf names
(``psi/dense/kernel``, ``out``).  The semantics are the JAX package's, not
``torch.optim.Adam``'s: clip scale ``min(1, max_norm / max(norm, 1e-9))``,
bias corrections ``1 - b ** step`` in fp32, ``eps`` outside
``sqrt(vhat)``.  Every quantity stays on the parameters' device, so a step
never waits for the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class OptState(NamedTuple):
    step: torch.Tensor               # () int32
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


def adam_init(params: dict[str, torch.Tensor]) -> OptState:
    dev = next(iter(params.values())).device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    mu={k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
                    nu={k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()})


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the summed squares of every leaf, in fp32, leaves in sorted
    name order (``jax.tree_util``'s order)."""
    return torch.sqrt(sum(tree[k].float().square().sum() for k in sorted(tree)))


def clip_by_global_norm(grads: dict[str, torch.Tensor], max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}, norm


def adam_update(grads, state: OptState, params, *, lr: float = 3e-3,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                grad_clip: float | None = 0.5):
    """Returns (new_params, new_state, metrics)."""
    if grad_clip is not None:
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
    else:
        gnorm = global_norm(grads)
    step = state.step + 1
    stepf = step.float()
    b1c = 1.0 - torch.full_like(stepf, b1) ** stepf
    b2c = 1.0 - torch.full_like(stepf, b2) ** stepf
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g32 = grads[k].float()
        m = b1 * state.mu[k] + (1 - b1) * g32
        v = b2 * state.nu[k] + (1 - b2) * g32.square()
        delta = (m / b1c) / (torch.sqrt(v / b2c) + eps)
        new_p[k] = (p.float() - lr * delta).to(p.dtype)
        new_m[k], new_v[k] = m, v
    return new_p, OptState(step, new_m, new_v), {"grad_norm": gnorm, "lr": lr}

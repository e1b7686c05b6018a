"""Adam / AdamW with global-norm gradient clipping on pytrees of tensors
(twin of ``repro/optim/adam.py``; the paper's App. A trainer: lr 3e-3,
clip 0.5).

Parameters, gradients and moments are pytrees of one structure (nested
dicts keyed by the JAX leaf names; a flat dict such as ``train_phi``'s
``{"psi/dense/kernel": ..., "out": ...}`` is one too).  The semantics are
the JAX package's, not ``torch.optim.Adam``'s: clip scale ``min(1, max_norm
/ max(norm, 1e-9))``, bias corrections ``1 - b ** step`` in fp32, ``eps``
outside ``sqrt(vhat)``, weight decay added to the update.  Every quantity
stays on the parameters' device, so a step never waits for the host.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.common.pytree import tree_global_norm, tree_leaves, tree_map


class OptState(NamedTuple):
    step: torch.Tensor               # () int32
    mu: Any
    nu: Any


def _device(tree) -> torch.device:
    leaves = tree_leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


def adam_init(params: Any, moment_dtype=torch.float32) -> OptState:
    zeros = lambda p: torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
    return OptState(step=torch.zeros((), dtype=torch.int32, device=_device(params)),
                    mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def clip_by_global_norm(grads: Any, max_norm: float, norm: torch.Tensor | None = None):
    """Scale ``grads`` to a global norm of at most ``max_norm``; ``norm``,
    when given, is the norm to use (a mesh form's, taken over every rank's
    blocks)."""
    if norm is None:
        norm = tree_global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def bias_corrections(step: torch.Tensor, b1: float, b2: float):
    """``1 - b ** step`` in fp32 for both moments."""
    stepf = step.float()
    return (1.0 - torch.full_like(stepf, b1) ** stepf,
            1.0 - torch.full_like(stepf, b2) ** stepf)


def learning_rate(lr, step: torch.Tensor):
    """``lr(step)`` for a schedule, else the constant."""
    return lr(step) if callable(lr) else lr


def _is_triple(x) -> bool:
    return isinstance(x, tuple) and len(x) == 3 and not hasattr(x, "_fields")


def unzip3(tree: Any, is_leaf: Callable[[Any], bool] = _is_triple):
    """A pytree of 3-tuples as three pytrees."""
    return tuple(tree_map(lambda t, i=i: t[i], tree, is_leaf=is_leaf) for i in range(3))


def adam_update(grads: Any, state: OptState, params: Any, *,
                lr: float | Callable[[torch.Tensor], torch.Tensor] = 3e-3,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                weight_decay: float = 0.0, grad_clip: float | None = 0.5,
                grad_norm: torch.Tensor | None = None):
    """Returns (new_params, new_state, metrics).  ``grad_norm`` replaces the
    norm of ``grads`` (a mesh form passes the global norm of the blocks)."""
    if grad_clip is not None:
        grads, gnorm = clip_by_global_norm(grads, grad_clip, grad_norm)
    else:
        gnorm = tree_global_norm(grads) if grad_norm is None else grad_norm
    step = state.step + 1
    lr_t = learning_rate(lr, step)
    b1c, b2c = bias_corrections(step, b1, b2)

    def upd(p, g, m, v):
        g32 = g.float()
        m = b1 * m + (1 - b1) * g32
        v = b2 * v + (1 - b2) * g32.square()
        delta = (m / b1c) / (torch.sqrt(v / b2c) + eps)
        if weight_decay:
            delta = delta + weight_decay * p.float()
        return (p.float() - lr_t * delta).to(p.dtype), m, v

    new_p, new_m, new_v = unzip3(tree_map(upd, params, grads, state.mu, state.nu))
    return new_p, OptState(step, new_m, new_v), {"grad_norm": gnorm, "lr": lr_t}


def adamw(**kwargs):
    """``adam_update`` with its keywords bound, weight decay 0.1 unless given."""
    kwargs.setdefault("weight_decay", 0.1)

    def update(grads, state, params):
        return adam_update(grads, state, params, **kwargs)

    return update

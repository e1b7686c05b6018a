"""SQ8 latent scans (twin of ``repro/kernels/mips_sq8.py``; CUDA kernel
``csrc/mips_sq8.cu``, two entry points).

CPU tensors take the plain versions in :mod:`repro_torch.kernels.ref`; CUDA
tensors launch the kernel, whatever the shape (the JAX package sends shapes
past 256 MB to its plain einsum; here the batched entry scores each query
against its own rows only, so no shape needs that).  Both entries count
their launches on ``mips_sq8.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.query_fused import tc_image_floats

_p = ctypes.c_void_p
_i = ctypes.c_int


def _check(q, codes, scales, rows_shape):
    dev = q.device
    B, d = q.shape
    build.expect(q, "q", torch.float32, (B, d), dev, align=4)
    build.expect(codes, "codes", torch.int8, (*rows_shape, d), dev, align=1)
    build.expect(scales, "scales", torch.float32, tuple(rows_shape), dev, align=4)


def mips_sq8(q, codes, scales):
    """All pairs: q (B, d) fp32 x codes (m, d) int8 with scales (m,) fp32 ->
    (B, m) fp32, the fp32 dot with the widened codes times the row scale (on
    the card: the dense scan's tensor-core product, q split in two TF32
    pieces, csrc/tc_scan.cuh)."""
    if q.device.type == "cpu":
        return ref.mips_sq8_ref(q, codes, scales)
    B, d = q.shape
    m = codes.shape[0]
    _check(q, codes, scales, (m,))
    if m >= 2 ** 31 - 1:
        raise ValueError(f"mips_sq8 kernel takes m < 2^31 - 1, got {m}")
    out = torch.empty((B, m), dtype=torch.float32, device=q.device)
    if out.numel() == 0 or d == 0:
        return out.zero_()
    img = torch.empty((tc_image_floats(B, d),), dtype=torch.float32, device=q.device)
    lib = build.library("mips_sq8")
    fn = lib.mips_sq8_pairs
    fn.argtypes = [_p] * 5 + [_i] * 3 + [_p]
    err = fn(q.data_ptr(), codes.data_ptr(), scales.data_ptr(), out.data_ptr(), img.data_ptr(),
             B, m, d, build.stream_ptr(q))
    build.check(lib, err, "mips_sq8")
    mips_sq8.launches += 1
    return out


mips_sq8.launches = 0


def mips_sq8_batched(q, codes, scales, *, chunk: int | None = None):
    """Each query against its own rows: q (B, d) fp32 x codes (B, n, d) int8
    with scales (B, n) fp32 -> (B, n) fp32.  ``chunk`` queries at a time
    bound the plain version's widened copy; the kernel ignores it."""
    if q.device.type == "cpu":
        return ref.mips_sq8_batched_ref(q, codes, scales, chunk=chunk)
    B, d = q.shape
    n = codes.shape[1]
    _check(q, codes, scales, (B, n))
    if B * -(-n // 128) >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"mips_sq8 batched kernel takes B ceil(n / 128) < 2^31, got B={B}, "
                         f"n={n}")
    out = torch.empty((B, n), dtype=torch.float32, device=q.device)
    if out.numel() == 0 or d == 0:
        return out.zero_()
    lib = build.library("mips_sq8")
    fn = lib.mips_sq8_batched
    fn.argtypes = [_p] * 4 + [_i] * 3 + [_p]
    err = fn(q.data_ptr(), codes.data_ptr(), scales.data_ptr(), out.data_ptr(), B, n, d,
             build.stream_ptr(q))
    build.check(lib, err, "mips_sq8_batched")
    mips_sq8.launches += 1
    return out

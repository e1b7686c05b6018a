"""Token-level MaxSim, the build's target generator (twin of
``repro/kernels/maxsim.py``; CUDA kernel ``csrc/token_maxsim.cu``).

CPU tensors take the plain version in :mod:`repro_torch.kernels.ref`; CUDA
tensors launch the kernel.  ``token_maxsim.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_p = ctypes.c_void_p
_i = ctypes.c_int
TC_K = 32   # columns of a chunk of the tensor cores' B image (csrc/tc_common.cuh: kTcK)


def tc_image_floats(groups: int, rows: int, d: int, n: int) -> int:
    """Floats of the split image of ``groups`` groups of ``rows`` rows of
    width ``d`` in tiles of ``n`` rows (csrc/tc_common.cuh: tc_image)."""
    return groups * -(-rows // n) * max(1, -(-d // TC_K)) * 2 * n * TC_K


def token_maxsim(x, doc_tokens, doc_mask, *, chunk: int | None = None):
    """g(x)_l = max over doc l's valid tokens c of <c, x>, NEG for a doc with
    no valid token.  x: (n, d) fp32; doc_tokens: (m, T, d) fp32; doc_mask:
    (m, T) bool, any pattern -> (n, m) fp32.  ``chunk`` docs at a time bound
    the plain version's (n, chunk, T) scores; the kernel needs no chunking
    and ignores it.  On the card the dots are the tensor cores' TF32 split
    (csrc/tc_common.cuh): an fp32 product's up to fp32 rounding."""
    if x.device.type == "cpu":
        return ref.token_maxsim_ref(x, doc_tokens, doc_mask, chunk=chunk)
    n, d = x.shape
    m, T, _ = doc_tokens.shape
    dev = x.device
    if max(n, m, m * T) >= 2 ** 31:
        raise ValueError(f"token_maxsim kernel takes n, m, m T < 2^31 (n={n}, m={m}, T={T})")
    build.expect(x, "x", torch.float32, (n, d), dev, align=4)
    build.expect(doc_tokens, "doc_tokens", torch.float32, (m, T, d), dev, align=4)
    build.expect(doc_mask, "doc_mask", torch.bool, (m, T), dev, align=1)
    out = torch.empty((n, m), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    img = torch.empty((tc_image_floats(1, n, d, 128),), dtype=torch.float32, device=dev)
    lib = build.library("token_maxsim")
    fn = lib.token_maxsim
    fn.argtypes = [_p] * 5 + [_i] * 4 + [_p]
    err = fn(x.data_ptr(), doc_tokens.data_ptr(), doc_mask.data_ptr(), out.data_ptr(),
             img.data_ptr(), n, m, T, d, build.stream_ptr(x))
    build.check(lib, err, "token_maxsim")
    token_maxsim.launches += 1
    return out


token_maxsim.launches = 0

"""The port's SQ8 scan, both entries, held against the JAX package's.

``mips_sq8`` (all pairs, (B, d) x (m, d) int8) and ``mips_sq8_batched``
(each query against its own (n, d) rows) run their plain versions for CPU
tensors; they are compared with the JAX oracles (``mips_sq8_ref``,
``mips_sq8_batched_ref``) and the JAX Pallas kernel in interpret mode,
which the JAX package's batched wrapper runs on the flattened rows at small
shapes.  ``tests/test_torch_cuda.py`` holds the CUDA kernel to the plain
versions on the card.

Tolerances: against the fp32 oracles 1e-5 of the largest score (another
sum order); against the interpret kernel the JAX suite's SQ8 bound, 2^-16 *
4 of the largest score (its hi/lo bf16 split).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.mips_sq8 import mips_sq8 as jax_mips_sq8

from repro_torch.kernels import mips_sq8 as mq
from repro_torch.kernels import ops

SQ8_RTOL = 2 ** -16 * 4


def close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= rtol * scale


@pytest.mark.parametrize("B,m,d", [(1, 7, 16), (5, 37, 20), (9, 1100, 64), (130, 33, 128)])
def test_mips_sq8_matches_jax(B, m, d):
    rng = np.random.default_rng(B * m + d)
    q = rng.standard_normal((B, d)).astype(np.float32)
    codes = rng.integers(-127, 128, (m, d)).astype(np.int8)
    scales = (rng.random(m) + 0.1).astype(np.float32)
    codes[m // 2], scales[m // 2] = codes[0], scales[0]      # an exact tie
    n0 = mq.mips_sq8.launches
    got = ops.mips_sq8(torch.as_tensor(q), torch.as_tensor(codes), torch.as_tensor(scales))
    assert mq.mips_sq8.launches == n0 and got.dtype == torch.float32
    jargs = (jnp.asarray(q), jnp.asarray(codes), jnp.asarray(scales))
    close(got, jax_ref.mips_sq8_ref(*jargs), 1e-5)
    close(got, jax_mips_sq8(*jargs, block_q=8, block_m=128, interpret=True), SQ8_RTOL)
    assert torch.equal(got[:, m // 2], got[:, 0])


@pytest.mark.parametrize("B,n,d", [(1, 5, 16), (4, 70, 20), (3, 300, 128), (6, 1, 8)])
def test_mips_sq8_batched_matches_jax(B, n, d):
    rng = np.random.default_rng(B * n + d)
    q = rng.standard_normal((B, d)).astype(np.float32)
    codes = rng.integers(-127, 128, (B, n, d)).astype(np.int8)
    scales = (rng.random((B, n)) + 0.1).astype(np.float32)
    got = ops.mips_sq8_batched(*map(torch.as_tensor, (q, codes, scales)))
    jargs = (jnp.asarray(q), jnp.asarray(codes), jnp.asarray(scales))
    close(got, jax_ref.mips_sq8_batched_ref(*jargs), 1e-5)
    # the JAX wrapper's kernel path: one all-pairs launch over the flattened
    # rows, each query's own strip kept
    close(got, jax_ops.mips_sq8_batched(*jargs, use_kernel=True, block_q=8,
                                        block_m=128), SQ8_RTOL)
    chunked = ops.mips_sq8_batched(*map(torch.as_tensor, (q, codes, scales)), chunk=2)
    close(chunked, got, 1e-6)


def test_batched_is_the_diagonal_of_all_pairs():
    rng = np.random.default_rng(1)
    q = torch.as_tensor(rng.standard_normal((4, 32)).astype(np.float32))
    codes = torch.as_tensor(rng.integers(-127, 128, (4, 9, 32)).astype(np.int8))
    scales = torch.as_tensor((rng.random((4, 9)) + 0.1).astype(np.float32))
    full = ops.mips_sq8(q, codes.reshape(36, 32), scales.reshape(36))
    strips = torch.stack([full[b, 9 * b:9 * b + 9] for b in range(4)])
    close(ops.mips_sq8_batched(q, codes, scales), strips, 1e-6)

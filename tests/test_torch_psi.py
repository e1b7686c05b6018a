"""The psi kernel's arithmetic on the CPU, held against fp64 and the JAX
package, and the one-launch wrappers fed the pooled latent.

``ref.tf32_split_psi`` emulates what the CUDA kernel (``csrc/psi.cuh``)
computes: x W' on the tensor cores with the 3xTF32 split (x's rows and W''s
columns as TF32 pieces, 64-column sums added in fp32), then bias, GELU and
LayerNorm in fp32 and the masked pool.  It is held against an fp64 psi
within ``ref.PSI_SPLIT_RTOL`` x max(1, max |exact|) (the bound the card
checks hold the kernel to), and against JAX's ``fused_psi`` in interpret
mode (unpooled) and ``jax_ref.psi_pool_ref`` (pooled) on the same numpy
inputs, within twice that bound (both sides round in fp32).  The grid: n
off every tile, Tq 1, 6, 32, 33 and 80 (a query past the kernel's 64-row
tile), d 16, 20 and 128, d' 256, 2,040, 2,044, 2,048 and 4,096, random
masks with a fully masked query, and no mask.

The one-launch wrappers (``query_fused``, ``query_fused_res`` and their
``ops`` routes) take the pooled latent the probe selection computed; given
one they return what they return without it (the plain path: the same
pool, bit for bit).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_psi as jax_fused_psi
from repro.kernels import ref as jax_ref

from repro_torch.anns.quantization import pack_codes, sq8_quant
from repro_torch.core.model import Psi
from repro_torch.kernels import ops, query_fused as qf, ref

# (B, Tq, d, d', mask): n = B Tq rows
CASES = [
    (3, 1, 16, 256, "random"),
    (4, 6, 20, 2044, "random"),
    (2, 32, 128, 2048, "random"),
    (2, 33, 20, 2040, "none"),
    (2, 80, 128, 4096, "random"),
    (5, 6, 128, 2048, "random"),
]


def T(x):
    return torch.as_tensor(np.array(x))


def _case(B, Tq, d, dp, mask):
    rng = np.random.default_rng(B * Tq * d + dp)
    x = rng.standard_normal((B, Tq, d)).astype(np.float32)
    w = ((rng.standard_normal((d, dp)) / np.sqrt(d)).astype(np.float32),
         (0.1 * rng.standard_normal(dp)).astype(np.float32),
         (1 + 0.1 * rng.standard_normal(dp)).astype(np.float32),
         (0.1 * rng.standard_normal(dp)).astype(np.float32))
    qm = None
    if mask == "random":
        qm = rng.random((B, Tq)) > 0.3
        qm[0] = False                                     # a fully masked query
    return x, qm, w


def _err(got, exact):
    return float((got.double() - exact).abs().max()), max(1.0, float(exact.abs().max()))


@pytest.mark.parametrize("B,Tq,d,dp,mask", CASES)
def test_split_psi_against_fp64(B, Tq, d, dp, mask):
    """The kernel's arithmetic, unpooled and pooled, within PSI_SPLIT_RTOL
    of an fp64 psi; a fully masked query pools to 0."""
    x, qm, w = _case(B, Tq, d, dp, mask)
    w32, w64 = [T(a) for a in w], [T(a).double() for a in w]
    m = None if qm is None else T(qm)
    rows = T(x).reshape(B * Tq, d)
    err, scale = _err(ref.tf32_split_psi(rows, *w32), ref.fused_psi_ref(rows.double(), *w64))
    assert err <= ref.PSI_SPLIT_RTOL * scale, (err, scale)
    pooled = ref.tf32_split_psi(T(x), *w32, q_mask=m)
    err, scale = _err(pooled, ref.psi_pool_ref(T(x).double(), m, *w64))
    assert err <= ref.PSI_SPLIT_RTOL * scale, (err, scale)
    if qm is not None:
        assert bool((pooled[0] == 0).all())
    # the plain version (what CPU tensors run) is under the same bound
    err, scale = _err(ref.psi_pool_ref(T(x), m, *w32), ref.psi_pool_ref(T(x).double(), m, *w64))
    assert err <= ref.PSI_SPLIT_RTOL * scale, (err, scale)


@pytest.mark.parametrize("B,Tq,d,dp,mask", CASES)
def test_split_psi_against_jax(B, Tq, d, dp, mask):
    """The kernel's arithmetic against JAX's Pallas psi in interpret mode
    and its pool oracle, on the same inputs."""
    x, qm, w = _case(B, Tq, d, dp, mask)
    w32 = [T(a) for a in w]
    rows = x.reshape(B * Tq, d)
    pallas = np.asarray(jax_fused_psi.fused_psi(jnp.asarray(rows), *map(jnp.asarray, w),
                                                block_n=64, interpret=True))
    got = ref.tf32_split_psi(T(rows), *w32).numpy()
    scale = max(1.0, float(np.abs(pallas).max()))
    assert np.abs(got - pallas).max() <= 2 * ref.PSI_SPLIT_RTOL * scale
    jm = jnp.ones((B, Tq), bool) if qm is None else jnp.asarray(qm)
    want = np.asarray(jax_ref.psi_pool_ref(jnp.asarray(x), jm, *map(jnp.asarray, w)))
    got = ref.tf32_split_psi(T(x), *w32, q_mask=None if qm is None else T(qm)).numpy()
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= 2 * ref.PSI_SPLIT_RTOL * scale


def _lists(rng, nlist, cap, dp):
    ids = rng.permutation(10 ** 5)[:nlist * cap].reshape(nlist, cap).astype(np.int32)
    ids[:, cap - cap // 3:] = -1
    ids[1] = -1                                           # an empty list
    vecs = rng.standard_normal((nlist, cap, dp)).astype(np.float32) * (ids >= 0)[..., None]
    return T(ids), T(vecs)


@pytest.mark.parametrize("kind", ["fp32", "sq8", "residual"])
def test_one_launch_given_latent_equals_pooling(kind):
    """query_fused / query_fused_res (and the ops routes, which pass the
    probe selection's latent) return, given the pooled latent, what they
    return pooling themselves: bit for bit on the plain path."""
    B, Tq, d, dp, nlist, cap, nprobe, kp = 3, 6, 16, 64, 6, 9, 3, 10
    rng = np.random.default_rng(21)
    x, qm, w = _case(B, Tq, d, dp, "random")
    q, m, w = T(x), T(qm), [T(a) for a in w]
    ids, vecs = _lists(rng, nlist, cap, dp)
    centroids = T(rng.standard_normal((nlist, dp)).astype(np.float32))
    probe = T(np.stack([rng.permutation(nlist)[:nprobe] for _ in range(B)]).astype(np.int32))
    latent = ref.psi_pool_ref(q, m, *w)
    psi = Psi.from_arrays(*w, device="cpu")
    if kind == "residual":
        values = T(np.sort(0.05 * rng.standard_normal((dp, 16)), 1).astype(np.float32))
        codes = pack_codes(T(rng.integers(0, 16, (nlist, cap, dp))), 4)
        lists = (ids, codes, centroids, values)
        fn, route = qf.query_fused_res, ops.fused_query_res
        route_args = (q, m, psi, centroids, ids, codes, values)
    else:
        lists = (ids, *sq8_quant(vecs)) if kind == "sq8" else (ids, vecs)
        fn, route = qf.query_fused, ops.fused_query
        route_args = (q, m, psi, centroids, *lists)
    want = fn(q, m, *w, probe, *lists, kp=kp)
    got = fn(q, m, *w, probe, *lists, kp=kp, latent=latent)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # the route: the prelude's pool, its probes, then the kernel on its latent
    pr = ref.stable_topk(latent @ centroids.T, nprobe)[1].to(torch.int32)
    want = fn(q, m, *w, pr, *lists, kp=kp)
    got = route(*route_args, nprobe=nprobe, kp=kp)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

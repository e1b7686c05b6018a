"""The port's kernel twins held against the JAX package's, on the same inputs.

For each kernel of the serving path (psi-pool, IVF probe scan, paged
MaxSim rerank) the port's plain version — what the wrappers run for CPU
tensors — is compared with the JAX oracle in ``repro.kernels.ref`` and with
the JAX Pallas kernel in interpret mode, across a grid that includes B=1,
d not a multiple of 128, tiny cluster capacity, -1 pads and k > #valid
candidates.  Inputs are made with numpy from a seed.

Tolerances: the frameworks sum the same fp32 products in different orders,
so values agree to fp32 rounding: rtol 1e-5 / atol 1e-5 on scores of order
one; the rerank sums up to Tq maxima and takes atol 1e-4.  The chunked runs
of the plain versions are bit-identical to the unchunked ones (same ops).

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import model as jax_model
from repro.kernels import fused_psi as jax_fused_psi
from repro.kernels import gather_scan as jax_gs
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.anns.quantization import sq8_quant as jax_sq8

from repro_torch.anns.base import stable_topk
from repro_torch.core.model import Psi, pool_queries
from repro_torch.kernels import fused_psi, gather_scan, ops, ref

SQ8_RTOL = 2 ** -16 * 4   # the JAX suite's SQ8 bound (tests/test_gather_scan.py)


def T(x):
    return torch.as_tensor(np.array(x))


def _psi_params(rng, d, dp):
    return ((rng.standard_normal((d, dp)) / np.sqrt(d)).astype(np.float32),
            0.1 * rng.standard_normal(dp).astype(np.float32),
            1 + 0.1 * rng.standard_normal(dp).astype(np.float32),
            0.1 * rng.standard_normal(dp).astype(np.float32))


# --------------------------------------------------------------------------
# psi and the psi-pool
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,d,dp", [(5, 16, 128), (1, 20, 64), (33, 12, 128)])
def test_fused_psi_ref_matches_jax(n, d, dp):
    rng = np.random.default_rng(n * d + dp)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = _psi_params(rng, d, dp)
    got = fused_psi.fused_psi(T(x), *map(T, w))           # CPU -> plain twin
    want = jax_ref.fused_psi_ref(jnp.asarray(x), *map(jnp.asarray, w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    pallas = jax_fused_psi.fused_psi(jnp.asarray(x), *map(jnp.asarray, w),
                                     block_n=8, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=1e-5, atol=1e-5)
    jparams = {"dense": {"kernel": jnp.asarray(w[0]), "bias": jnp.asarray(w[1])},
               "ln": {"scale": jnp.asarray(w[2]), "bias": jnp.asarray(w[3])}}
    served = jax_model.psi_apply(jparams, jnp.asarray(x))
    np.testing.assert_allclose(Psi.from_arrays(*w, device="cpu")(T(x)).numpy(),
                               np.asarray(served), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,Tq,d,dp", [(4, 6, 16, 128), (1, 3, 20, 64), (7, 32, 12, 128)])
def test_psi_pool_matches_jax(B, Tq, d, dp):
    """Masked tokens add 0 although psi(0) != 0: the mask applies after psi."""
    rng = np.random.default_rng(B * Tq + d)
    q = rng.standard_normal((B, Tq, d)).astype(np.float32)
    qm = rng.random((B, Tq)) > 0.3
    qm[:, 0] = True
    w = _psi_params(rng, d, dp)
    psi = Psi.from_arrays(*w, device="cpu")
    got = pool_queries(psi, T(q), T(qm))
    want = jax_ref.psi_pool_ref(jnp.asarray(q), jnp.asarray(qm), *map(jnp.asarray, w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    jparams = {"dense": {"kernel": jnp.asarray(w[0]), "bias": jnp.asarray(w[1])},
               "ln": {"scale": jnp.asarray(w[2]), "bias": jnp.asarray(w[3])}}
    served = jax_model.pool_queries(jparams, jnp.asarray(q), jnp.asarray(qm))
    np.testing.assert_allclose(got.numpy(), np.asarray(served), rtol=1e-5, atol=1e-5)
    chunked = ref.psi_pool_ref(T(q), T(qm), *map(T, w), chunk=2)
    assert torch.equal(chunked, ref.psi_pool_ref(T(q), T(qm), *map(T, w)))


# --------------------------------------------------------------------------
# IVF probe scan
# --------------------------------------------------------------------------

SCAN_GRID = [
    (4, 8, 5, 12, 3),      # tiny cap, d not a multiple of 128
    (1, 16, 9, 32, 8),     # B=1
    (3, 4, 1, 20, 4),      # cap 1: every probe all pads or one row
]


def _lists(rng, nlist, cap, d):
    ids = rng.integers(-1, 99, (nlist, cap)).astype(np.int32)
    ids[0, :] = -1                                  # an all-pad list
    vecs = (rng.standard_normal((nlist, cap, d)) * (ids >= 0)[..., None]).astype(np.float32)
    return ids, vecs


@pytest.mark.parametrize("B,nlist,cap,d,nprobe", SCAN_GRID)
@pytest.mark.parametrize("sq8", [False, True])
def test_ivf_scan_matches_jax(B, nlist, cap, d, nprobe, sq8):
    rng = np.random.default_rng(B * nlist + cap + sq8)
    ids, vecs = _lists(rng, nlist, cap, d)
    q = rng.standard_normal((B, d)).astype(np.float32)
    probe = rng.integers(0, nlist, (B, nprobe)).astype(np.int32)
    probe[0, 0] = 0
    args = [jnp.asarray(vecs)]
    if sq8:
        args = list(jax_sq8(jnp.asarray(vecs)))
    jargs = (jnp.asarray(q), jnp.asarray(probe), jnp.asarray(ids), *args)
    got = gather_scan.ivf_probe_scan(T(q), T(probe), T(ids), *map(T, args))
    want = np.asarray(jax_ref.ivf_scan_ref(*jargs))
    pallas = np.asarray(jax_gs.ivf_probe_scan(*jargs, interpret=True))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got.numpy()), fin)
    assert np.all(np.isneginf(got.numpy()[~fin]))
    np.testing.assert_allclose(got.numpy()[fin], want[fin], rtol=1e-5, atol=1e-5)
    denom = max(float(np.abs(want[fin]).max(initial=0.0)), 1.0)
    rel = SQ8_RTOL if sq8 else 1e-5   # Pallas SQ8 is the hi/lo-bf16 split
    assert np.abs(got.numpy()[fin] - pallas[fin]).max(initial=0.0) / denom < rel
    chunked = ref.ivf_scan_ref(T(q), T(probe), T(ids), *map(T, args), chunk=1)
    assert torch.equal(chunked, got)


# --------------------------------------------------------------------------
# paged MaxSim rerank
# --------------------------------------------------------------------------

def _paged(rng, C, pmax, d, page=16):
    """A page pool with ragged docs: doc 1 has 0 tokens (page ids -1)."""
    n_tokens = rng.integers(1, pmax * page + 1, C).astype(np.int32)
    n_tokens[1] = 0
    P = C * pmax
    table = rng.permutation(P).reshape(C, pmax).astype(np.int32)
    need = -(-n_tokens // page)
    table[np.arange(pmax)[None, :] >= need[:, None]] = -1
    pages = rng.standard_normal((P, page, d)).astype(np.float32)
    return pages, table, n_tokens


RERANK_GRID = [
    (3, 12, 4, 16, 5, 2),
    (1, 8, 3, 20, 6, 1),      # B=1, d off 128, one page a doc
    (2, 10, 32, 8, 9, 3),     # Tq = 32, as served
]


@pytest.mark.parametrize("B,C,Tq,d,kp,pmax", RERANK_GRID)
def test_rerank_paged_matches_jax(B, C, Tq, d, kp, pmax):
    rng = np.random.default_rng(B * C + Tq)
    pages, table, nt = _paged(rng, C, pmax, d)
    q = rng.standard_normal((B, Tq, d)).astype(np.float32)
    qm = rng.random((B, Tq)) > 0.3
    qm[:, 0] = True
    cand = rng.integers(-1, C, (B, kp)).astype(np.int32)
    cand[0, :2] = [-1, 1]                 # a pad and the zero-token doc
    targs = (T(q), T(qm), T(cand), T(pages), T(table), T(nt))
    jargs = tuple(jnp.asarray(a) for a in (q, qm, cand, pages, table, nt))
    got = gather_scan.rerank_paged_scores(*targs)
    want = np.asarray(jax_ref.rerank_scores_paged_ref(*jargs))
    pallas = np.asarray(jax_gs.rerank_paged_scores(*jargs, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-5, atol=1e-4)
    # a -1 / zero-token candidate scores the finite Tq_valid * NEG
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy()[0, :2], qm[0].sum() * ref.NEG, rtol=1e-6)
    assert torch.equal(ref.rerank_scores_paged_ref(*targs, chunk=1), got)


@pytest.mark.parametrize("k", [4, 9, 15])     # 15 > k' = 9: padded out
def test_fused_rerank_paged_topk_matches_jax(k):
    rng = np.random.default_rng(k)
    B, C, Tq, d, kp, pmax = 3, 12, 5, 16, 9, 2
    pages, table, nt = _paged(rng, C, pmax, d)
    q = rng.standard_normal((B, Tq, d)).astype(np.float32)
    qm = np.ones((B, Tq), bool)
    cand = rng.integers(-1, C, (B, kp)).astype(np.int32)
    cand[2] = -1                                  # a row with no candidates
    got_s, got_i = ops.fused_rerank_paged(T(q), T(qm), T(cand), T(pages),
                                          T(table), T(nt), k)
    want_s, want_i = jax_ops.fused_rerank_paged(
        *(jnp.asarray(a) for a in (q, qm, cand, pages, table, nt)), k,
        use_kernel=False)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5, atol=1e-4)
    assert got_s.shape == (B, k) and (got_i[2] == -1).all()


# --------------------------------------------------------------------------
# top-k tie order
# --------------------------------------------------------------------------

def test_stable_topk_tie_order_matches_jax():
    rng = np.random.default_rng(0)
    s = rng.integers(0, 4, (6, 50)).astype(np.float32)   # many exact ties
    s[0, :] = -np.inf
    for k in (1, 7, 50):
        v, i = stable_topk(T(s), k)
        jv, ji = jax.lax.top_k(jnp.asarray(s), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))

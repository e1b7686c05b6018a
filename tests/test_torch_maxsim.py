"""The port's token MaxSim held against the JAX package's, on the same inputs.

The plain twins (what the wrappers run for CPU tensors, and what
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold the CUDA kernel to)
are compared with the JAX oracles in ``repro.kernels.ref``, with the Pallas
kernel in interpret mode, and with ``repro.core.maxsim``'s blocked
functions.  The grid covers d=20, T=1, a fully masked doc, a mask that is
not a prefix, and m larger than the core functions' doc block.  Inputs are
made with numpy from a seed.

Tolerances: the frameworks sum the same fp32 products in different orders,
so per-token maxima agree to rtol 1e-5 / atol 1e-5 (values of order one);
MaxSim sums up to Tq maxima and takes atol 1e-4.  A doc with no valid
token scores exactly NEG in both.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import maxsim as jax_maxsim
from repro.kernels import maxsim as jax_kernel
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref

from repro_torch.core import maxsim
from repro_torch.kernels import maxsim as kmaxsim
from repro_torch.kernels import ops, ref


def T(x):
    return torch.as_tensor(np.array(x))


def _docs(rng, m, Td, d):
    docs = rng.standard_normal((m, Td, d)).astype(np.float32)
    mask = rng.random((m, Td)) > 0.4          # not a prefix
    mask[0] = False                           # a doc with no valid token
    if m > 2:
        mask[2] = True
    return docs * mask[..., None], mask


CASES = [(7, 5, 3, 20), (9, 4, 1, 16), (33, 17, 7, 20), (16, 40, 12, 32)]


@pytest.mark.parametrize("n,m,Td,d", CASES)
def test_token_maxsim_matches_jax(n, m, Td, d):
    rng = np.random.default_rng(n * m + Td)
    x = rng.standard_normal((n, d)).astype(np.float32)
    docs, mask = _docs(rng, m, Td, d)
    got = kmaxsim.token_maxsim(T(x), T(docs), T(mask)).numpy()   # CPU -> plain twin
    want = np.asarray(jax_ref.token_maxsim_ref(jnp.asarray(x), jnp.asarray(docs),
                                               jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (got[:, 0] == ref.NEG).all() and (want[:, 0] == np.float32(ref.NEG)).all()
    pallas = jax_kernel.token_maxsim(jnp.asarray(x), jnp.asarray(docs), jnp.asarray(mask),
                                     block_n=8, block_m=8, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-5, atol=1e-5)
    chunked = ref.token_maxsim_ref(T(x), T(docs), T(mask), chunk=3)   # other BLAS blocking
    torch.testing.assert_close(chunked, torch.as_tensor(got), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,m,Td,d", CASES)
def test_maxsim_scores_matches_jax(n, m, Td, d):
    rng = np.random.default_rng(n + m * Td)
    B, Tq = 3, 4
    q = rng.standard_normal((B, Tq, d)).astype(np.float32)
    qm = rng.random((B, Tq)) > 0.3
    qm[:, 0] = True
    docs, mask = _docs(rng, m, Td, d)
    jargs = [jnp.asarray(a) for a in (q, qm, docs, mask)]
    want = np.asarray(jax_ref.maxsim_scores_ref(*jargs))
    for got in (ops.maxsim_scores(T(q), T(qm), T(docs), T(mask)),
                ref.maxsim_scores_ref(T(q), T(qm), T(docs), T(mask), chunk=2),
                maxsim.maxsim_scores(T(q), T(qm), T(docs), T(mask), block=3)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    pallas = jax_ops.maxsim_scores(*jargs, use_kernel=True)
    np.testing.assert_allclose(ops.maxsim_scores(T(q), T(qm), T(docs), T(mask)).numpy(),
                               np.asarray(pallas), rtol=1e-5, atol=1e-4)


def test_core_functions_match_jax_blocked():
    """m = 40 docs over blocks of 8: the core functions against JAX's
    ``lax.map``-blocked versions."""
    rng = np.random.default_rng(11)
    n, m, Td, d = 12, 40, 6, 20
    x = rng.standard_normal((n, d)).astype(np.float32)
    docs, mask = _docs(rng, m, Td, d)
    got = maxsim.token_maxsim(T(x), T(docs), T(mask), block=8).numpy()
    want = np.asarray(jax_maxsim.token_maxsim(jnp.asarray(x), jnp.asarray(docs),
                                              jnp.asarray(mask), block=8))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_true_topk_and_recall_match_jax():
    rng = np.random.default_rng(5)
    B, Tq, m, Td, d = 6, 5, 50, 8, 20
    q = rng.standard_normal((B, Tq, d)).astype(np.float32)
    qm = np.ones((B, Tq), bool)
    qm[1, 3:] = False
    docs, mask = _docs(rng, m, Td, d)
    jargs = [jnp.asarray(a) for a in (q, qm, docs, mask)]
    want_s, want_i = jax_maxsim.true_topk(*jargs, 7, block=16)
    got_s, got_i = maxsim.true_topk(T(q), T(qm), T(docs), T(mask), 7, block=16)
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5, atol=1e-4)
    retrieved = rng.integers(0, m, (B, 12)).astype(np.int32)
    retrieved[0, :7] = np.asarray(want_i)[0]
    np.testing.assert_allclose(
        maxsim.recall_at(T(retrieved), got_i).numpy(),
        np.asarray(jax_maxsim.recall_at(jnp.asarray(retrieved), want_i)), rtol=1e-6)
    assert float(maxsim.recall_at(T(retrieved), got_i)[0]) == 1.0


def served_corpus(m, d, seed):
    """The chip smoke's corpus distribution (data/synthetic.make_corpus at
    the build cell's settings: Poisson(67.5) lengths clipped to [4, 80],
    unit tokens at topic weight 1.2), at m docs of width d."""
    from repro_torch.data import synthetic

    return synthetic.make_corpus(m=m, d=d, avg_tokens=67.5, max_tokens=80, n_centers=256,
                                 seed=seed)


@pytest.mark.parametrize("n,m,d", [(512, 64, 128), (96, 24, 1024), (256, 64, 20)],
                         ids=["served", "d1024", "d20"])
def test_maxsim_split_error(n, m, d):
    """The token MaxSim kernel's arithmetic (csrc/maxsim_tc.cuh), emulated by
    ref.tf32_split_maxsim: the split pieces (ref.tf32_rna), sums restarted
    every 64 columns and added in fp32, the masked max over each doc's 80
    token rows; OLS tokens drawn from the corpus as the build draws them.
    Against fp64 token MaxSim: within ref.TF32_SPLIT_RTOL x max(1, max
    |score|), the tolerance of the card's check; NEG where a doc has no
    valid token, exactly."""
    corpus = served_corpus(m, d, seed=d)
    rng = np.random.default_rng(d + 1)
    docs, mask = T(corpus.doc_tokens), T(corpus.doc_mask)
    mask[1] = False                                   # a doc with no valid token
    flat = corpus.doc_tokens[corpus.doc_mask]
    x = T(flat[rng.integers(0, len(flat), n)])
    got = ref.tf32_split_maxsim(x, docs, mask)
    sc = torch.einsum("nd,mtd->nmt", x.double(), docs.double())
    exact = torch.where(mask[None], sc, ref.NEG).amax(-1)
    real = exact > ref.NEG / 2
    assert torch.equal(got > ref.NEG / 2, real) and bool((got[~real] == ref.NEG).all())
    err = float((got.double() - exact)[real].abs().max())
    assert err <= ref.TF32_SPLIT_RTOL * max(1.0, float(exact[real].abs().max())), err

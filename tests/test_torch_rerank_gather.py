"""The dense-store MaxSim rerank of the sharded path held against JAX.

The port's plain twin (``kernels/ref.rerank_scores_ref``, which the
``rerank_gather_scores`` wrapper runs for CPU tensors) and its top-k wrapper
``ops.fused_rerank`` take the same numpy inputs as the JAX oracle
(``repro.kernels.ref.rerank_scores_ref``), the JAX Pallas kernel in
interpret mode (``gather_scan.rerank_gather_scores(..., interpret=True)``)
and JAX's ``ops.fused_rerank``.  Cases: fp32 tokens and SQ8 codes with
per-token scales, -1 candidates (doc 0's score here, NEG after the top-k
wrapper), a doc whose mask is all False, a partial query mask, duplicated
candidates, Td in {5, 6, 77}, and k above k'.

Tolerance: fp32 rtol 1e-6 (atol 1e-5 on scores of a few units: the
frameworks sum the d products in other orders); SQ8 the JAX suite's
2^-16 x 4 of the largest score (the Pallas kernel splits q into hi/lo
bf16 halves).  Ids equal up to counted near-ties (relative gap < 1e-5).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.anns.quantization import sq8_quant as jax_sq8_quant
from repro.kernels import gather_scan as jax_gs
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref

from repro_torch.kernels import gather_scan, ops, ref

SQ8_RTOL = 2 ** -16 * 4
TIE = 1e-5


def make_case(Td, sq8, *, B=3, m=12, Tq=4, d=16, kp=8, seed=0):
    rng = np.random.default_rng(seed + Td)
    q = rng.standard_normal((B, Tq, d)).astype(np.float32)
    qm = rng.random((B, Tq)) > 0.3
    qm[:, 0] = True
    docs = rng.standard_normal((m, Td, d)).astype(np.float32)
    dm = rng.random((m, Td)) > 0.3
    dm[:, 0] = True
    dm[5] = False                                  # a doc with no valid token
    cand = rng.integers(0, m, (B, kp)).astype(np.int32)
    cand[0, 1] = cand[1, -1] = -1                  # pads
    cand[2, :2] = 5                                # the empty doc, twice
    cand[1, 3] = cand[1, 4]                        # a duplicated candidate
    scales = None
    if sq8:
        codes, sc = jax_sq8_quant(jnp.asarray(docs))
        docs, scales = np.asarray(codes), np.asarray(sc)
    return q, qm, cand, docs, dm, scales


def T(x):
    return None if x is None else torch.as_tensor(np.array(x))


def J(x):
    return None if x is None else jnp.asarray(x)


def close(got, want, sq8):
    got, want = np.asarray(got), np.asarray(want)
    if sq8:
        err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
        assert err < SQ8_RTOL, err
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("sq8", [False, True], ids=["fp32", "sq8"])
@pytest.mark.parametrize("Td", [5, 6, 77])
def test_plain_twin_matches_jax(Td, sq8):
    case = make_case(Td, sq8)
    got = gather_scan.rerank_gather_scores(*map(T, case))
    assert got.shape == (3, 8) and got.dtype == torch.float32
    close(got, jax_ref.rerank_scores_ref(*map(J, case)), sq8)
    # -1 candidates score doc 0; the doc with no valid token Tq_valid x NEG
    q, qm, cand, *_ = case
    pad = cand < 0
    np.testing.assert_array_equal(
        got.numpy()[pad], ref.rerank_scores_ref(
            *map(T, (q, qm, np.where(pad, 0, cand), *case[3:]))).numpy()[pad])
    assert np.allclose(got[2, :2].numpy(), qm[2].sum() * ref.NEG, rtol=1e-6)
    # chunks of candidates give the same scores
    chunked = ref.rerank_scores_ref(*map(T, case), chunk=3)
    np.testing.assert_allclose(chunked.numpy(), got.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("sq8", [False, True], ids=["fp32", "sq8"])
@pytest.mark.parametrize("Td", [5, 6, 77])
def test_plain_twin_matches_the_pallas_kernel(Td, sq8):
    case = make_case(Td, sq8, kp=5)
    got = gather_scan.rerank_gather_scores(*map(T, case))
    want = jax_gs.rerank_gather_scores(*map(J, case), interpret=True)
    real = np.asarray(want) > ref.NEG / 2
    close(got.numpy()[real], np.asarray(want)[real], sq8)
    np.testing.assert_allclose(got.numpy()[~real], np.asarray(want)[~real], rtol=1e-6)


@pytest.mark.parametrize("k", [3, 12], ids=["k_below_kp", "k_above_kp"])
@pytest.mark.parametrize("sq8", [False, True], ids=["fp32", "sq8"])
@pytest.mark.parametrize("Td", [6, 77])
def test_fused_rerank_matches_jax(Td, sq8, k):
    """-1 candidates score NEG and come last, id -1; rows are padded to k
    with (NEG, -1) when k > k' = 8."""
    q, qm, cand, docs, dm, scales = make_case(Td, sq8)
    got_s, got_i = ops.fused_rerank(T(q), T(qm), T(cand), T(docs), T(dm), k,
                                    doc_scales=T(scales))
    want_s, want_i = jax_ops.fused_rerank(J(q), J(qm), J(cand), J(docs), J(dm), k,
                                          doc_scales=J(scales))
    assert got_s.shape == (3, k) and got_i.dtype == torch.int32
    close(got_s, want_s, sq8)
    diff = got_i.numpy() != np.asarray(want_i)
    gap = np.abs(got_s.numpy() - np.asarray(want_s)) / np.maximum(np.abs(want_s), 1.0)
    assert np.all(gap[diff] < TIE) and diff.sum() <= 1
    if k > 8:
        assert (got_i[:, 8:] == -1).all() and (got_s[:, 8:] == ref.NEG).all()
    assert (got_i[0] == -1).sum() == (1 if k > 8 else 0) + max(0, k - 8)


def test_wrapper_counts_no_launch_on_the_cpu():
    n0 = gather_scan.rerank_gather_scores.launches
    gather_scan.rerank_gather_scores(*map(T, make_case(6, True)))
    assert gather_scan.rerank_gather_scores.launches == n0
    assert ops.KERNELS["rerank_gather_scores"] is gather_scan.rerank_gather_scores


@pytest.mark.parametrize("d", [128, 1024, 20], ids=["served", "d1024", "d20"])
@pytest.mark.parametrize("sq8", [False, True], ids=["fp32", "sq8"])
def test_rerank_split_error(sq8, d):
    """The dense rerank kernel's arithmetic (csrc/maxsim_tc.cuh), emulated by
    ref.tf32_split_rerank: 3xTF32 pieces for fp32 tokens, 2xTF32 for SQ8
    codes (q split, the codes exact, the token's scale after the sum), sums
    restarted every 64 columns and added in fp32, the masked max over each
    candidate's 80 rows, the masked sum over 32 query tokens; queries drawn
    as the chip smoke draws them (a doc's tokens plus encoder noise), -1
    and duplicated candidates.  Against fp64 MaxSim over the same stored
    tokens: within ref.TF32_SPLIT_RTOL x max(1, max |score|), the tolerance
    of the card's check."""
    from repro_torch.data import synthetic

    # the chip smoke's corpus distribution: Poisson(67.5) lengths clipped to
    # [4, 80], unit tokens at topic weight 1.2
    corpus = synthetic.make_corpus(m=48, d=d, avg_tokens=67.5, max_tokens=80, n_centers=256,
                                   seed=d + 7)
    rng = np.random.default_rng(d)
    B, Tq, kp = 6, 32, 40
    q = T(synthetic.queries_from_corpus_query(corpus, B, q_tokens=Tq, seed=d))
    qm = torch.ones(B, Tq, dtype=torch.bool)
    qm[0, 20:] = False                                 # a short query
    cand = T(rng.integers(-1, 48, (B, kp)).astype(np.int32))
    cand[1, 3] = cand[1, 4]
    docs, mask = T(corpus.doc_tokens), T(corpus.doc_mask)
    scales = None
    if sq8:
        codes, sc = jax_sq8_quant(jnp.asarray(corpus.doc_tokens))
        docs, scales = T(codes), T(sc)
    got = ref.tf32_split_rerank(q, qm, cand, docs, mask, scales)
    c = cand.clamp_min(0).long()
    s = torch.einsum("bqd,bktd->bkqt", q.double(), docs[c].double())
    if sq8:
        s = s * scales[c].double()[:, :, None, :]
    best = torch.where(mask[c][:, :, None, :], s, ref.NEG).amax(-1)
    exact = torch.where(qm[:, None, :], best, 0.0).sum(-1)
    err = float((got.double() - exact).abs().max())
    assert err <= ref.TF32_SPLIT_RTOL * max(1.0, float(exact.abs().max())), err
    assert bool(got[1, 3] == got[1, 4])

"""The CUDA kernels held against their plain PyTorch versions on the card.

This file imports no JAX, so it runs where the port runs:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Every test needs a CUDA device and skips without one.  Tolerances: the
kernels sum in another order than the plain versions (fp32 rounding): the
psi-pool to 1e-4 (LayerNorm over d' = 2048 amplifies the product's
rounding), the scan to the JAX suite's SQ8 bound 2^-16 * 4 relative to the
largest score, the rerank to rtol 1e-5 / atol 1e-4, token MaxSim to
1e-5 x max(1, max|plain|) with NEG entries exactly equal.
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch.core import pages
from repro_torch.core.config import LemurConfig
from repro_torch.core.model import Psi
from repro_torch.anns.quantization import sq8_quant
from repro_torch.core import maxsim
from repro_torch.data import synthetic
from repro_torch.kernels import fused_psi, gather_scan, ops, ref
from repro_torch.kernels import maxsim as kmaxsim
from repro_torch.retriever import LemurRetriever, SearchParams

SQ8_RTOL = 2 ** -16 * 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _psi_params(rng, d, dp):
    return [torch.as_tensor(a, dtype=torch.float32) for a in (
        rng.standard_normal((d, dp)) / np.sqrt(d), 0.1 * rng.standard_normal(dp),
        1 + 0.1 * rng.standard_normal(dp), 0.1 * rng.standard_normal(dp))]


@pytest.mark.gpu
@pytest.mark.parametrize("B,Tq,d,dp", [(3, 5, 16, 64), (2, 32, 128, 2048),
                                       (1, 1, 8, 300), (2, 9, 128, 4096)])
def test_fused_psi_kernel(cuda, B, Tq, d, dp):
    rng = np.random.default_rng(B * Tq + dp)
    q = torch.as_tensor(rng.standard_normal((B, Tq, d)), dtype=torch.float32, device=cuda)
    qm = torch.as_tensor(rng.random((B, Tq)) > 0.3, device=cuda)
    w = [t.to(cuda) for t in _psi_params(rng, d, dp)]
    n0 = fused_psi.fused_psi_pool.launches
    torch.testing.assert_close(fused_psi.fused_psi_pool(q, qm, *w),
                               ref.psi_pool_ref(q, qm, *w), rtol=1e-4, atol=1e-4)
    assert fused_psi.fused_psi_pool.launches == n0 + 1
    x = q.reshape(B * Tq, d)
    torch.testing.assert_close(fused_psi.fused_psi(x, *w), ref.fused_psi_ref(x, *w),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("B,nlist,cap,d,nprobe", [
    (4, 8, 5, 12, 3), (1, 16, 9, 32, 8), (3, 4, 1, 20, 4), (2, 4, 64, 2048, 3)])
@pytest.mark.parametrize("sq8", [False, True])
def test_ivf_scan_kernel(cuda, B, nlist, cap, d, nprobe, sq8):
    rng = np.random.default_rng(B * nlist + cap)
    ids = rng.integers(-1, 99, (nlist, cap)).astype(np.int32)
    ids[0] = -1
    vecs = torch.as_tensor(rng.standard_normal((nlist, cap, d)) * (ids >= 0)[..., None],
                           dtype=torch.float32, device=cuda)
    args = list(sq8_quant(vecs)) if sq8 else [vecs]
    q = torch.as_tensor(rng.standard_normal((B, d)), dtype=torch.float32, device=cuda)
    probe = torch.as_tensor(rng.integers(0, nlist, (B, nprobe)), dtype=torch.int32,
                            device=cuda)
    ids = torch.as_tensor(ids, device=cuda)
    got = gather_scan.ivf_probe_scan(q, probe, ids, *args)
    want = ref.ivf_scan_ref(q, probe, ids, *args)
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    assert bool(torch.isneginf(got[~fin]).all())
    if fin.any():
        denom = max(float(want[fin].abs().max()), 1.0)
        assert float((got[fin] - want[fin]).abs().max()) / denom < SQ8_RTOL


@pytest.mark.gpu
@pytest.mark.parametrize("B,C,Tq,d,kp,pmax", [
    (3, 12, 4, 16, 5, 2), (1, 8, 3, 20, 6, 1), (2, 40, 32, 128, 64, 5),
    (2, 10, 40, 8, 9, 3)])     # Tq > 32: two query-token groups a lane
def test_rerank_paged_kernel(cuda, B, C, Tq, d, kp, pmax):
    rng = np.random.default_rng(B * C + Tq)
    n_tokens = rng.integers(1, pmax * 16 + 1, C).astype(np.int32)
    n_tokens[1] = 0
    table = rng.permutation(C * pmax).reshape(C, pmax).astype(np.int32)
    table[np.arange(pmax)[None, :] >= (-(-n_tokens // 16))[:, None]] = -1
    g = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=cuda)
    args = (g(rng.standard_normal((B, Tq, d)), torch.float32),
            g(rng.random((B, Tq)) > 0.3),
            g(rng.integers(-1, C, (B, kp)), torch.int32),
            g(rng.standard_normal((C * pmax, 16, d)), torch.float32),
            g(table), g(n_tokens))
    got = gather_scan.rerank_paged_scores(*args)
    want = ref.rerank_scores_paged_ref(*args)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    k = kp + 3
    s, i = ops.fused_rerank_paged(*args, k)
    s0, i0 = ops.fused_rerank_paged(*(a.cpu() for a in args), k)
    assert torch.equal(i.cpu(), i0)
    torch.testing.assert_close(s.cpu(), s0, rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
def test_kernel_wrappers_validate_arguments(cuda):
    q = torch.zeros(2, 8, device=cuda)
    ids = torch.zeros(4, 3, dtype=torch.int32, device=cuda)
    vecs = torch.zeros(4, 3, 8, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        gather_scan.ivf_probe_scan(q, torch.zeros(2, 2, dtype=torch.int64, device=cuda),
                                   ids, vecs)
    with pytest.raises(ValueError, match="on cpu"):
        gather_scan.ivf_probe_scan(q, torch.zeros(2, 2, dtype=torch.int32), ids, vecs)


@pytest.mark.gpu
def test_search_on_card_matches_cpu(cuda):
    """The same index served on the card (kernels) and on the CPU (plain
    versions) returns the same ids; scores within rtol 1e-5 / atol 1e-4."""
    rng = np.random.default_rng(3)
    m, T, d, dp = 500, 30, 32, 256
    tok = torch.nn.functional.normalize(torch.as_tensor(
        rng.standard_normal((m, T, d)), dtype=torch.float32), dim=-1)
    mask = torch.as_tensor(rng.random((m, T)) > 0.3)
    W = torch.as_tensor(rng.standard_normal((m, dp)), dtype=torch.float32)
    store, _ = pages.from_dense(W, tok, mask)
    store.alive[[4, 8]] = False
    psi = Psi.init(d, dp, torch.Generator().manual_seed(0), device="cpu")
    cfg = LemurConfig(d=d, d_prime=dp, k=20, k_prime=128)
    cpu = LemurRetriever.from_arrays(cfg, psi, store,
                                     generator=torch.Generator().manual_seed(1))
    idx = cpu.index
    gpu = LemurRetriever(idx._replace(
        psi=copy.deepcopy(psi).to(cuda), store=store.to(cuda),
        ann=type(idx.ann)(*(None if t is None else t.to(cuda) for t in idx.ann))))
    q = torch.as_tensor(rng.standard_normal((16, 8, d)), dtype=torch.float32)
    s0, i0 = cpu.search(q)
    s1, i1 = gpu.search(q)
    assert torch.equal(i1.cpu(), i0)
    torch.testing.assert_close(s1.cpu(), s0, rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("n,m,T,d", [
    (7, 5, 3, 20), (9, 4, 1, 16), (65, 37, 7, 20), (130, 70, 80, 128), (1, 1, 1, 4),
    (64, 33, 40, 256)])
def test_token_maxsim_kernel(cuda, n, m, T, d):
    """Ragged n and m, d not a multiple of 4, T = 1, a doc with no valid
    token, a mask that is not a prefix, and a 16-position chunk masked in
    every doc (the kernel skips it)."""
    rng = np.random.default_rng(n * m + T)
    g = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=cuda)
    x = g(rng.standard_normal((n, d)), torch.float32)
    docs = g(rng.standard_normal((m, T, d)), torch.float32)
    mask = rng.random((m, T)) > 0.4
    mask[0] = False
    if T > 32:
        mask[:, 16:32] = False
    mask = g(mask)
    n0 = kmaxsim.token_maxsim.launches
    got = kmaxsim.token_maxsim(x, docs, mask)
    assert kmaxsim.token_maxsim.launches == n0 + 1
    want = ref.token_maxsim_ref(x, docs, mask)
    real = want != ref.NEG
    assert torch.equal(got != ref.NEG, real) and not bool(real[:, 0].any())
    if real.any():
        scale = max(1.0, float(want[real].abs().max()))
        assert float((got[real] - want[real]).abs().max()) <= 1e-5 * scale
    q = x[: (n // 4) * 4].reshape(-1, 4, d)
    qm = g(rng.random(q.shape[:2]) > 0.3)
    torch.testing.assert_close(ops.maxsim_scores(q, qm, docs, mask),
                               ref.maxsim_scores_ref(q, qm, docs, mask), rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
def test_build_on_card(cuda, tmp_path):
    """A small build on the card: every token MaxSim and psi launch is the
    expected one, recall is far above a blind first stage, and save/load
    returns the same ids and scores."""
    corpus = synthetic.make_corpus(m=3000, d=32, avg_tokens=16, max_tokens=24,
                                   n_centers=64, seed=0)
    cfg = LemurConfig(d=32, d_prime=128, m_pretrain=256, n_train=2048, n_ols=512,
                      epochs=3, k=10, k_prime=64)
    ops.reset_launch_counts()
    r = LemurRetriever.build(corpus, cfg, generator=torch.Generator().manual_seed(0),
                             device=cuda)
    counts = ops.launch_counts()
    assert counts["token_maxsim"] == 1 + -(-3000 // 2048) and counts["fused_psi"] == 1
    assert r.device.type == "cuda" and r.x_ols.device.type == "cuda"
    q = synthetic.queries_from_corpus_query(corpus, 64, q_tokens=8, seed=7)
    qm = np.ones(q.shape[:2], bool)
    dev = lambda a: torch.as_tensor(a, device=cuda)
    _, truth = maxsim.true_topk(dev(q), dev(qm), dev(corpus.doc_tokens),
                                dev(corpus.doc_mask), 10)
    s, i = r.search(q, qm, SearchParams(k=10))
    assert float(maxsim.recall_at(i, truth).mean()) > 5 * cfg.k_prime / 3000
    r.save(tmp_path)
    back = LemurRetriever.load(tmp_path, device=cuda)
    s1, i1 = back.search(q, qm, SearchParams(k=10))
    assert torch.equal(i, i1) and torch.equal(s, s1)

"""The CUDA kernels held against their plain PyTorch versions on the card.

This file imports no JAX, so it runs where the port runs:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Every test needs a CUDA device and skips without one.  Tolerances: the
kernels sum in another order than the plain versions (fp32 rounding): the
psi-pool to 1e-4 (LayerNorm over d' = 2048 amplifies the product's
rounding), the scan to the JAX suite's SQ8 bound 2^-16 * 4 relative to the
largest score, the rerank to rtol 1e-5 / atol 1e-4, token MaxSim to
1e-5 x max(1, max|plain|) with NEG entries exactly equal; the one-launch
and SQ8 scans as the psi-pool and the scan, with ids equal up to near-ties
(relative gap 1e-5) and exactly equal on integer-valued rows.  The residual
kernels (2 and 4 bits) sum in another order: scores to 1e-5 x max(1,
max|plain|) (the rerank as the fp32 one), and exactly equal where the
codec's tables, the centroids and the queries are small integers (every
product and sum exact); the scans and the tensor-core rerank add the
centroid part apart from the residual part (fp32 rounding), and are held to
fp64 as well: the scans within 1e-5 x max(1, max|exact|), the rerank
within ref.TF32_SPLIT_RTOL x max(1, max|exact|).
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch.anns.base import pad_topk, stable_topk
from repro_torch.core import pages
from repro_torch.core.config import LemurConfig
from repro_torch.core.model import Psi
from repro_torch.anns.quantization import sq8_quant, train_residual_codec
from repro_torch.core import maxsim
from repro_torch.data import synthetic
from repro_torch.kernels import fused_psi, gather_scan, ops, ref
from repro_torch.kernels import maxsim as kmaxsim
from repro_torch.anns import ivf as ivf_mod
from repro_torch.retriever import IVFSearchParams, LemurRetriever, SearchParams
from repro_torch.retriever.facade import search_pipeline

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
@pytest.mark.parametrize("B,Tq,d,dp,mask", [
    (3, 1, 16, 256, "random"),       # a query a row
    (4, 6, 20, 2044, "random"),      # 10 queries a 64-row tile, d' off 16 bytes
    (256, 32, 128, 2048, "random"),  # the served pool
    (2, 33, 13, 2040, "none"),       # a query a tile, d off 8, no mask
    (3, 80, 128, 4096, "random"),    # a query over two tiles, clusters of 16
    (2, 512, 128, 2048, "random"),   # a query over eight tiles
    (5, 6, 3000, 4096, "random"),    # d looped in 94 chunks
    (1, 7, 128, 64, "random"),       # one warpgroup of a block without columns
])
def test_psi_kernel_shapes(cuda, B, Tq, d, dp, mask):
    """The tensor-core psi kernel, pooled and unpooled, against its plain
    version (1e-4) and an fp64 psi (ref.PSI_SPLIT_RTOL x max(1, max|exact|));
    two calls give the same bits; a fully masked query pools to 0."""
    rng = np.random.default_rng(B * Tq + d + dp)
    q = torch.as_tensor(rng.standard_normal((B, Tq, d)), dtype=torch.float32, device=cuda)
    qm = None
    if mask == "random":
        qm = torch.as_tensor(rng.random((B, Tq)) > 0.3, device=cuda)
        qm[0] = False
    w = [t.to(cuda) for t in _psi_params(rng, d, dp)]
    w64 = [t.double() for t in w]
    got = fused_psi.fused_psi_pool(q, qm, *w)
    assert torch.equal(got, fused_psi.fused_psi_pool(q, qm, *w))
    torch.testing.assert_close(got, ref.psi_pool_ref(q, qm, *w), rtol=1e-4, atol=1e-4)
    exact = ref.psi_pool_ref(q.double(), qm, *w64)
    err = float((got.double() - exact).abs().max())
    assert err <= ref.PSI_SPLIT_RTOL * max(1.0, float(exact.abs().max())), err
    if qm is not None:
        assert bool((got[0] == 0).all())
    x = q.reshape(B * Tq, d)
    feats = fused_psi.fused_psi(x, *w)
    assert torch.equal(feats, fused_psi.fused_psi(x, *w))
    torch.testing.assert_close(feats, ref.fused_psi_ref(x, *w), rtol=1e-4, atol=1e-4)
    exact = ref.fused_psi_ref(x.double(), *w64)
    err = float((feats.double() - exact).abs().max())
    assert err <= ref.PSI_SPLIT_RTOL * max(1.0, float(exact.abs().max())), err


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["fp32", "sq8", "residual"])
def test_one_launch_routes_pool_once(cuda, kind):
    """ops.fused_query / fused_query_res launch the psi-pool once a search
    (the probe selection's; the kernel takes its latent) and equal the
    kernel fed the pool's latent, bit for bit."""
    B, Tq, d, dp, nlist, cap, nprobe, kp = 4, 32, 128, 2048, 8, 300, 4, 256
    rng = np.random.default_rng(5)
    g = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=cuda)
    w = [t.to(cuda) for t in _psi_params(rng, d, dp)]
    psi = Psi.from_arrays(*w, device="cuda")
    q = g(rng.standard_normal((B, Tq, d)), torch.float32)
    qm = g(rng.random((B, Tq)) > 0.3)
    ids = rng.permutation(10 ** 6)[:nlist * cap].reshape(nlist, cap).astype(np.int32)
    ids[:, cap - cap // 3:] = -1
    cent = g(rng.standard_normal((nlist, dp)) / np.sqrt(dp), torch.float32)
    if kind == "residual":
        codes = g(rng.integers(0, 256, (nlist, cap, dp // 2)).astype(np.uint8))
        _, values = _residual_tables(rng, nlist, dp, 4, False)
        lists = (g(ids), codes, g(values))
        route, name = ops.fused_query_res, "query_fused_res"
        kargs = (g(ids), codes, cent, g(values))
    else:
        vecs = g(rng.standard_normal((nlist, cap, dp)) * (ids >= 0)[..., None], torch.float32)
        lists = (g(ids), *(sq8_quant(vecs) if kind == "sq8" else (vecs,)))
        route, name = ops.fused_query, "query_fused"
        kargs = lists
    ops.reset_launch_counts()
    got = route(q, qm, psi, cent, *lists, nprobe=nprobe, kp=kp)
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    assert counts == {"fused_psi_pool": 1, name: 1}, counts
    lat = fused_psi.fused_psi_pool(q, qm, *w)
    probe = stable_topk(lat @ cent.T, nprobe)[1].to(torch.int32)
    want = ops.KERNELS[name](q, qm, *w, probe, *kargs, kp=kp, latent=lat)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("B,nlist,cap,d,nprobe", [
    (4, 8, 5, 12, 3), (1, 16, 9, 32, 8), (3, 4, 1, 20, 4), (2, 4, 64, 2048, 3),
    (3, 4, 40, 4096, 3),        # q from device memory, rows staged
    (2, 4, 33, 20000, 3),       # fp32 rows past the staging ring; int8 one a window
    (2, 4, 33, 80000, 3)])      # both past the ring: rows read from device memory
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


def _paged_path(Tq, d):
    """The path rerank_paged_plan takes at these widths: the tensor cores
    where d is whole float4s and q's image and two 16-row slots a consumer
    warp fit a block (Tq <= 64 at d <= 128 here), else the CUDA cores."""
    return "tensor cores" if d % 4 == 0 and d <= 128 and Tq <= 64 else "cuda cores"


@pytest.mark.gpu
@pytest.mark.parametrize("B,C,Tq,d,kp,pmax", [
    (3, 12, 4, 16, 5, 2), (1, 8, 3, 20, 6, 1), (2, 40, 32, 128, 64, 5),
    (2, 10, 40, 8, 9, 3),      # Tq > 32: two query-token groups a lane
    (2, 9, 100, 130, 7, 3),    # d off whole float4s (a padded slot), Tq = 100
    (2, 8, 5, 21, 6, 2),       # d odd
    (2, 8, 1, 768, 6, 2),      # Tq = 1; d = 768: q and the slots past shared memory
    (2, 8, 32, 1024, 6, 2),    # the served Tq at d = 1,024 (the wide walk)
    (2, 10, 512, 128, 9, 3),   # Tq = 512 at the served d (the wide walk, one chunk a page)
    (1, 6, 512, 1024, 5, 2),   # both
    (2, 300, 32, 128, 600, 5)])   # the served widths, k' past a block's 512 candidates
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
    n0 = gather_scan.rerank_paged_scores.launches
    got = gather_scan.rerank_paged_scores(*args)
    assert gather_scan.rerank_paged_scores.launches == n0 + 1
    # csrc/rerank_paged.cu: rerank_paged_plan
    assert gather_scan.rerank_paged_scores.last_path == _paged_path(Tq, d)
    want = ref.rerank_scores_paged_ref(*args)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    k = kp + 3
    s, i = ops.fused_rerank_paged(*args, k)
    s0, i0 = ops.fused_rerank_paged(*(a.cpu() for a in args), k)
    assert torch.equal(i.cpu(), i0)
    torch.testing.assert_close(s.cpu(), s0, rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("B,m,Tq,Td,d,kp", [
    (3, 12, 4, 5, 16, 8), (1, 9, 6, 77, 128, 40),    # B = 1, Td off every tile
    (2, 300, 32, 80, 128, 300), (2, 20, 40, 16, 32, 7),    # Tq > 32: a 64-token tile
    (2, 30, 100, 13, 20, 20),        # d off 4 and 16, Td off 8, Tq = 100 (a 128 tile)
    (2, 25, 1, 77, 130, 17),         # Tq = 1, d = 130 (a partial chunk)
    (2, 20, 512, 21, 768, 9),        # Tq = 512: four query tiles; d = 768
    (2, 16, 32, 80, 1024, 12),       # d = 1,024: q's image streams through the ring
    (3, 40, 32, 80, 128, 1000)])     # several blocks a query
@pytest.mark.parametrize("sq8", [False, True])
def test_rerank_gather_kernel(cuda, B, m, Tq, Td, d, kp, sq8):
    """-1 candidates (doc 0), a doc with no valid token, duplicated
    candidates (equal to the bit), a partial query mask; the top-k wrapper
    with k above k'."""
    rng = np.random.default_rng(B * m + Td)
    g = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=cuda)
    docs = g(rng.standard_normal((m, Td, d)), torch.float32)
    dm = rng.random((m, Td)) > 0.4
    dm[3] = False
    cand = rng.integers(-1, m, (B, kp)).astype(np.int32)
    cand[0, :2] = 3
    cand[-1, -1] = cand[-1, 0]
    args = [g(rng.standard_normal((B, Tq, d)), torch.float32), g(rng.random((B, Tq)) > 0.3),
            g(cand), *(sq8_quant(docs) if sq8 else (docs, None))]
    args = args[:4] + [g(dm)] + args[4:]
    n0 = gather_scan.rerank_gather_scores.launches
    got = gather_scan.rerank_gather_scores(*args)
    want = ref.rerank_scores_ref(*args, chunk=64)
    assert gather_scan.rerank_gather_scores.launches == n0 + 1
    real = want > ref.NEG / 2
    torch.testing.assert_close(got[real], want[real], rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(got[~real], want[~real], rtol=1e-6, atol=0.0)
    assert bool(got[0, 0] == got[0, 1]) and bool(got[-1, -1] == got[-1, 0])
    s, i = ops.fused_rerank(*args[:5], kp + 3, doc_scales=args[5])
    s0, i0 = ops.fused_rerank(*(None if a is None else a.cpu() for a in args[:5]), kp + 3,
                              doc_scales=None if args[5] is None else args[5].cpu())
    torch.testing.assert_close(s.cpu(), s0, rtol=1e-5, atol=1e-4)
    assert int((i.cpu() != i0).sum()) <= 1


@pytest.fixture
def nccl_mesh(cuda, tmp_path):
    """A one-rank NCCL process group on the card and its ("model",) mesh."""
    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh

    tdist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg", world_size=1,
                             rank=0)
    try:
        yield init_device_mesh("cuda", (1,), mesh_dim_names=("model",))
    finally:
        tdist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("route", [{}, {"use_one_launch": True}, {"use_fused_gather": False}],
                         ids=["fused", "one_launch", "legacy"])
@pytest.mark.parametrize("sq8", [True, False])
def test_sharded_search_on_card_matches_cpu(nccl_mesh, route, sq8):
    """LemurRetriever.shard on a one-rank NCCL mesh: the kernels' route
    (mips_topk, rerank_gather_scores) against the same state's plain
    composition on the CPU; ids up to near-ties, scores rtol 1e-5."""
    from repro_torch.dist import ShardedRetrievalState
    from repro_torch.dist.serve import _local_retrieve
    from repro_torch.core.model import pool_queries

    rng = np.random.default_rng(9)
    m, T, d, dp = 700, 37, 128, 256
    tok = torch.nn.functional.normalize(torch.as_tensor(
        rng.standard_normal((m, T, d)), dtype=torch.float32), dim=-1)
    mask = torch.as_tensor(rng.random((m, T)) > 0.3)
    W = torch.as_tensor(rng.standard_normal((m, dp)), dtype=torch.float32)
    store, _ = pages.from_dense(W.cuda(), tok.cuda(), mask.cuda())
    store.alive[[4, 8]] = False
    psi = Psi.init(d, dp, torch.Generator().manual_seed(0), device="cuda")
    r = LemurRetriever.from_arrays(LemurConfig(d=d, d_prime=dp, k=20, k_prime=64), psi, store,
                                   generator=torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match="cpu"):
        LemurRetriever(r.index._replace(store=store.to("cpu"))).shard(nccl_mesh)
    sr = r.shard(nccl_mesh, sq8=sq8)
    assert sr.state.W.is_cuda and sr.rows_per_shard == 1024
    q = torch.as_tensor(rng.standard_normal((16, 8, d)), dtype=torch.float32)
    qm = torch.as_tensor(rng.random((16, 8)) > 0.2)
    qm[:, 0] = True
    params = SearchParams(**route)
    ops.reset_launch_counts()
    s1, i1 = sr.search(q, qm, params)
    c = ops.launch_counts()
    assert c["fused_psi_pool"] == 1
    assert c["mips_topk"] == int(bool(route.get("use_one_launch")))
    assert c["rerank_gather_scores"] == int(route.get("use_fused_gather", True))
    st = sr.state
    cpu = ShardedRetrievalState(copy.deepcopy(st.psi).cpu(),
                                *(None if t is None else t.cpu() for t in st[1:]))
    p = sr.resolve(params)
    s0, i0 = _local_retrieve(pool_queries(cpu.psi, q, qm), cpu, q, qm, k=p.k, k_prime=256,
                             use_fused_gather=p.use_fused_gather,
                             use_one_launch=p.use_one_launch)
    torch.testing.assert_close(s1.cpu(), s0, rtol=1e-5, atol=1e-4)
    assert int((i1.cpu() != i0).sum()) <= 2
    assert not bool(torch.isin(i1.cpu(), torch.tensor([4, 8])).any())


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
    (64, 33, 40, 256),
    (300, 90, 77, 130),     # T off 8 and 64, d off a chunk, two x tiles and a partial one
    (40, 20, 13, 768),      # d past the old cap of 256
    (33, 17, 21, 1024),     # ... and the x tile's image streamed through the ring
    (1000, 300, 80, 128)])  # the build's T and d, several blocks a tile
def test_token_maxsim_kernel(cuda, n, m, T, d):
    """Ragged n and m, d not a multiple of 4, T = 1, a doc with no valid
    token, a mask that is not a prefix, and a 16-position slice masked in
    every doc."""
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


def _same_topk(got_s, got_i, want_s, want_i, tol):
    """Scores within tol x max(1, max|plain|) (pads equal), ids equal up to
    near-ties (relative gap < 1e-5)."""
    fin = torch.isfinite(want_s)
    assert torch.equal(torch.isfinite(got_s), fin)
    assert torch.equal(got_i[~fin], want_i[~fin])
    if fin.any():
        scale = max(1.0, float(want_s[fin].abs().max()))
        assert float((got_s[fin] - want_s[fin]).abs().max()) <= tol * scale
    diff = got_i != want_i
    assert bool(((got_s - want_s).abs()[diff & fin] <= 1e-5 * want_s.abs().clamp_min(1)[diff & fin]).all())


@pytest.mark.gpu
@pytest.mark.parametrize("B,Tq,d,dp,nlist,cap,nprobe,kp", [
    (1, 5, 16, 64, 6, 7, 2, 9),          # B=1, cap odd, kp > valid slots
    (3, 32, 128, 2048, 8, 300, 4, 256),  # full widths, cap past a chunk
    (4, 6, 20, 300, 5, 11, 5, 60),       # d' off every tile, kp > the strip
    (2, 6, 16, 64, 8, 3000, 4, 4096),    # k' past the old shared-memory list's cap
    (2, 6, 16, 64, 8, 3000, 4, 4097),
    (2, 6, 16, 64, 8, 3000, 4, 8192),    # ... and kp > the valid slots
])
@pytest.mark.parametrize("sq8", [False, True])
def test_query_fused_kernel(cuda, B, Tq, d, dp, nlist, cap, nprobe, kp, sq8):
    """Pads, an empty list and duplicated rows (exact ties); the result
    equals the default route's kernels (psi-pool, scan, stable top-k) bit
    for bit."""
    rng = np.random.default_rng(B * cap + dp)
    g = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=cuda)
    w = [t.to(cuda) for t in _psi_params(rng, d, dp)]
    q = g(rng.standard_normal((B, Tq, d)), torch.float32)
    qm = g(rng.random((B, Tq)) > 0.3)
    ids = rng.permutation(10 ** 6)[:nlist * cap].reshape(nlist, cap).astype(np.int32)
    ids[:, cap - cap // 3:] = -1
    ids[1] = -1                                       # an empty list
    vecs = rng.standard_normal((nlist, cap, dp)) * (ids >= 0)[..., None]
    vecs[2, 1] = vecs[0, 0]
    vecs[3, 0] = vecs[0, 0]
    vecs = g(vecs, torch.float32)
    lists = list(sq8_quant(vecs)) if sq8 else [vecs]
    probe = np.stack([rng.permutation(nlist)[:nprobe] for _ in range(B)]).astype(np.int32)
    probe[0, 0] = 0
    args = (q, qm, *w, g(probe), g(ids), *lists)
    n0 = ops.launch_counts()["query_fused"]
    got = ops.KERNELS["query_fused"](*args, kp=kp)
    assert ops.launch_counts()["query_fused"] == n0 + 1
    want = ref.query_fused_ref(*args, kp=kp)
    _same_topk(*got, *want, SQ8_RTOL if sq8 else 1e-4)
    # the kernel's own pool and scan: the default route's kernels, same bits
    psi_q = fused_psi.fused_psi_pool(q, qm, *w)
    s = gather_scan.ivf_probe_scan(psi_q, g(probe), g(ids), *lists).reshape(B, -1)
    flat_i = g(ids)[g(probe).long()].reshape(B, -1)
    top, pos = stable_topk(s, min(kp, s.shape[1]))
    top, idx = pad_topk(top, torch.gather(flat_i, 1, pos), kp)
    assert torch.equal(got[1], idx) and torch.equal(got[0], top)


@pytest.mark.gpu
@pytest.mark.parametrize("B,m,dp,kp", [(1, 7, 16, 5), (9, 1500, 64, 100),
                                       (20, 3000, 2048, 1024), (3, 40, 20, 64),
                                       (70, 40000, 48, 100),    # the filtered pass
                                       (5, 70001, 20, 300),     # ... d off the vector width
                                       (9, 5000, 64, 4096),     # k' of the sharded default
                                       (5, 600000, 32, 4096),   # ... through the filter
                                       (5, 9000, 64, 4097),     # past the old limit
                                       (3, 600000, 32, 4097),   # ... through the filter
                                       (3, 40000, 64, 8192),
                                       (2, 60000, 32, 32768)])  # 4 sorted chunks a query
@pytest.mark.parametrize("sq8", [False, True])
def test_mips_topk_kernel(cuda, B, m, dp, kp, sq8):
    """valid holes, kp above the valid rows and above m, m off the tile, and
    exact ties from integer-valued duplicated rows (ids equal exactly: small
    integers are exact in TF32 and every sum is exact); past
    FILTER_MIN_ROWS x kp rows the sampled bound, filter and selection; k'
    past any shared-memory list."""
    from repro_torch.kernels import query_fused as qf

    rng = np.random.default_rng(m + kp)
    g = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=cuda)
    q = g(rng.integers(-3, 4, (B, dp)), torch.float32)
    W = rng.integers(-3, 4, (m, dp)).astype(np.float32)
    W[m // 2] = W[m // 3]
    W[m - 1] = W[0]
    W = g(W)
    valid = g(rng.random(m) > 0.25)
    args = list(sq8_quant(W)) if sq8 else [W, None]
    n0 = qf.mips_topk.launches
    got_s, got_i = qf.mips_topk(q, *args, valid, kp=kp)
    assert qf.mips_topk.launches == n0 + 1
    want_s, want_i = ref.mips_topk_ref(q, *args, valid, kp=kp)
    if sq8:
        _same_topk(got_s, got_i, want_s, want_i, SQ8_RTOL)
    else:    # integer products: every sum is exact, so are the ids
        assert torch.equal(got_i, want_i) and torch.equal(got_s, want_s)


@pytest.mark.gpu
@pytest.mark.parametrize("B,m,dp", [(256, 5000, 2048), (7, 1000, 48), (300, 900, 20)])
@pytest.mark.parametrize("sq8", [False, True])
def test_tc_product_against_fp64(cuda, B, m, dp, sq8):
    """The tensor-core product (csrc/tc_scan.cuh) and mips_sq8's all pairs
    against an fp64 product: within ref.TF32_SPLIT_RTOL x max(1, max
    |exact|), the bound the CPU emulation of the split shows
    (tests/test_torch_query_fused.py::test_tf32_split_error); the sample's
    scores (every 32nd row, a row stride) equal the full pass's at those
    rows bit for bit, so the filtered pass can trust the sampled bound."""
    from repro_torch.kernels import mips_sq8 as mq
    from repro_torch.kernels import query_fused as qf

    rng = np.random.default_rng(B + m + dp)
    g = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=cuda)
    q = g(rng.standard_normal((B, dp)) * 5, torch.float32)
    W = g(rng.standard_normal((m, dp)), torch.float32)
    valid = g(rng.random(m) > 0.1)
    args = list(sq8_quant(W)) if sq8 else [W, None]
    got = qf.tc_scores(q, *args, valid)
    exact = q.double() @ args[0].double().T
    if sq8:
        exact = exact * args[1].double()[None, :]
    assert bool((got[:, ~valid] == ref.NEG).all())
    exact = exact[:, valid]
    tol = ref.TF32_SPLIT_RTOL * max(1.0, float(exact.abs().max()))
    assert float((got[:, valid].double() - exact).abs().max()) <= tol
    assert torch.equal(qf.tc_scores(q, *args, valid, stride=qf.SAMPLE_STRIDE),
                       got[:, ::qf.SAMPLE_STRIDE])
    if sq8:
        pairs = mq.mips_sq8(q, *args)
        ex = (q.double() @ args[0].double().T) * args[1].double()[None, :]
        assert float((pairs.double() - ex).abs().max()) <= (
            ref.TF32_SPLIT_RTOL * max(1.0, float(ex.abs().max())))


@pytest.mark.gpu
def test_mips_sq8_batched_past_the_old_grid(cuda):
    """n past 128 x 65,535 rows a query (the batched entry's old cap, its
    row tiles on grid.y), 3 rows into the next tile, B = 2."""
    from repro_torch.kernels import mips_sq8 as mq

    B, n, d = 2, 128 * 65535 + 3, 16
    gen = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn(B, d, generator=gen, device=cuda)
    codes = torch.randint(-127, 128, (B, n, d), generator=gen, device=cuda).to(torch.int8)
    scales = torch.rand(B, n, generator=gen, device=cuda) + 0.1
    got = mq.mips_sq8_batched(q, codes, scales)
    want = ref.mips_sq8_batched_ref(q, codes, scales, chunk=1)
    assert float((got - want).abs().max()) <= SQ8_RTOL * max(1.0, float(want.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["rerank_paged_scores", "rerank_paged_res_scores",
                                    "rerank_gather_fp32", "rerank_gather_sq8"])
def test_reranks_take_any_batch(cuda, kernel):
    """B = 65,539 queries of k' = 2 (the reranks' old cap was B <= 65,535,
    B on grid.y): every row against the plain version."""
    rng = np.random.default_rng(17)
    B, Tq, d, kp, C = 65539, 4, 16, 2, 30
    g = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=cuda)
    q = g(rng.standard_normal((B, Tq, d)), torch.float32)
    qm = g(rng.random((B, Tq)) > 0.3)
    cand = g(rng.integers(-1, C, (B, kp)), torch.int32)
    if kernel.startswith("rerank_gather"):
        docs = g(rng.standard_normal((C, 20, d)), torch.float32)
        dm = g(rng.random((C, 20)) > 0.3)
        args = (q, qm, cand, *(sq8_quant(docs) if kernel.endswith("sq8") else (docs, None)))
        args = args[:4] + (dm,) + args[4:]
        got = gather_scan.rerank_gather_scores(*args)
        want = ref.rerank_scores_ref(*args, chunk=1)
        real = want > ref.NEG / 2
        torch.testing.assert_close(got[real], want[real], rtol=1e-5, atol=1e-4)
        return
    pmax = 2
    n_tokens = g(rng.integers(1, pmax * 16 + 1, C), torch.int32)
    table = g(rng.permutation(C * pmax).reshape(C, pmax), torch.int32)
    if kernel == "rerank_paged_scores":
        args = (q, qm, cand, g(rng.standard_normal((C * pmax, 16, d)), torch.float32), table,
                n_tokens)
        got = gather_scan.rerank_paged_scores(*args)
        assert gather_scan.rerank_paged_scores.last_path == "tensor cores"
        want = ref.rerank_scores_paged_ref(*args, chunk=8192)
    else:
        cent, values = _residual_tables(rng, 6, d, 4, False)
        args = (q, qm, cand, g(rng.integers(0, 6, (C * pmax, 16)), torch.int32),
                g(rng.integers(0, 256, (C * pmax, 16, d // 2)), torch.uint8), table,
                n_tokens, g(cent), g(values))
        got = gather_scan.rerank_paged_res_scores(*args)
        want = ref.rerank_scores_paged_res_ref(*args, chunk=8192)
    real = want > ref.NEG / 2
    torch.testing.assert_close(got[real], want[real], rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("what", ["token_maxsim", "rerank_fp32", "rerank_sq8"])
@pytest.mark.parametrize("d", [20, 128, 1024])
def test_maxsim_tc_against_fp64(cuda, what, d):
    """The MaxSim body's tensor-core arithmetic (csrc/maxsim_tc.cuh)
    against fp64 MaxSim: within ref.TF32_SPLIT_RTOL x max(1, max |exact|),
    the bound tests/test_torch_maxsim.py::test_maxsim_split_error shows
    for the emulated split on the CPU; NEG where a doc has no valid token."""
    rng = np.random.default_rng(d + len(what))
    g = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=cuda)
    norm = lambda a: a / np.linalg.norm(a, axis=-1, keepdims=True)
    T = 80
    docs = g(norm(rng.standard_normal((64, T, d))), torch.float32)
    mask = rng.random((64, T)) > 0.15
    mask[3] = False
    mask = g(mask)
    if what == "token_maxsim":
        x = g(norm(rng.standard_normal((300, d))), torch.float32)
        got = kmaxsim.token_maxsim(x, docs, mask).double()
        sc = torch.einsum("nd,mtd->nmt", x.double(), docs.double())
        exact = torch.where(mask[None], sc, ref.NEG).amax(-1)
    else:
        B, Tq, kp = 4, 32, 40
        q = g(norm(rng.standard_normal((B, Tq, d))), torch.float32)
        qm = g(rng.random((B, Tq)) > 0.2)
        cand = g(rng.integers(0, 64, (B, kp)), torch.int32)
        toks, scales = sq8_quant(docs) if what == "rerank_sq8" else (docs, None)
        got = gather_scan.rerank_gather_scores(q, qm, cand, toks, mask, scales).double()
        c = cand.long()
        sc = torch.einsum("bqd,bktd->bkqt", q.double(), toks[c].double())
        if scales is not None:
            sc = sc * scales[c].double()[:, :, None, :]
        best = torch.where(mask[c][:, :, None, :], sc, ref.NEG).amax(-1)
        exact = torch.where(qm[:, None, :], best, 0.0).sum(-1)
    real = exact > ref.NEG / 2
    assert torch.equal(got > ref.NEG / 2, real)
    tol = ref.TF32_SPLIT_RTOL * max(1.0, float(exact[real].abs().max()))
    assert float((got[real] - exact[real]).abs().max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("B,n,d", [(1, 5, 16), (3, 300, 2048), (4, 70, 20), (2, 129, 128)])
def test_mips_sq8_kernel(cuda, B, n, d):
    from repro_torch.kernels import mips_sq8 as mq

    rng = np.random.default_rng(B * n + d)
    g = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=cuda)
    q = g(rng.standard_normal((B, d)), torch.float32)
    codes = g(rng.integers(-127, 128, (B, n, d)), torch.int8)
    scales = g(rng.random((B, n)) + 0.1, torch.float32)
    n0 = mq.mips_sq8.launches
    got = mq.mips_sq8_batched(q, codes, scales)
    want = ref.mips_sq8_batched_ref(q, codes, scales)
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= SQ8_RTOL * scale
    got = mq.mips_sq8(q, codes.reshape(B * n, d), scales.reshape(-1))
    want = ref.mips_sq8_ref(q, codes.reshape(B * n, d), scales.reshape(-1))
    assert float((got - want).abs().max()) <= SQ8_RTOL * max(1.0, float(want.abs().max()))
    assert mq.mips_sq8.launches == n0 + 2
    with pytest.raises(ValueError, match="int8"):
        mq.mips_sq8_batched(q, codes.float(), scales)


@pytest.mark.gpu
@pytest.mark.parametrize("params", [
    SearchParams(),
    SearchParams(backend=IVFSearchParams(use_one_launch=True)),
    SearchParams(use_ann=False, use_one_launch=True),
    SearchParams(use_ann=False),
    SearchParams(backend=IVFSearchParams(use_fused_gather=False), use_fused_gather=False),
    SearchParams(use_residual=False),
], ids=["default", "one_launch_ivf", "exact_one_launch", "exact_blocked", "legacy",
        "residual_off"])
@pytest.mark.parametrize("tier", ["fp32", "sq8", "residual"])
def test_routes_on_card_match_cpu(cuda, params, tier):
    """Each route served on the card returns the CPU's ids up to near-ties,
    over fp32 and SQ8 lists of an fp32 store, and over 4-bit residual lists
    of a compressed store."""
    rng = np.random.default_rng(5)
    m, T, d, dp = 600, 24, 32, 256
    tok = torch.nn.functional.normalize(torch.as_tensor(
        rng.standard_normal((m, T, d)), dtype=torch.float32), dim=-1)
    mask = torch.as_tensor(rng.random((m, T)) > 0.3)
    W = torch.as_tensor(rng.standard_normal((m, dp)), dtype=torch.float32)
    codec = None
    cfg = LemurConfig(d=d, d_prime=dp, k=20, k_prime=128)
    if tier == "residual":
        codec = train_residual_codec(torch.Generator().manual_seed(2), tok[mask], bits=4,
                                     ncent=32, iters=3)
        cfg = cfg.replace(ivf=cfg.ivf.replace(residual_bits=4),
                          residual=cfg.residual.replace(enabled=True))
    cfg = cfg.replace(ivf=cfg.ivf.replace(sq8=tier == "sq8"))
    store, _ = pages.from_dense(W, tok, mask, codec=codec)
    store.alive[[4, 8]] = False
    psi = Psi.init(d, dp, torch.Generator().manual_seed(0), device="cpu")
    cpu = LemurRetriever.from_arrays(cfg, psi, store,
                                     generator=torch.Generator().manual_seed(1))
    idx = cpu.index
    gpu = LemurRetriever(idx._replace(
        psi=copy.deepcopy(psi).to(cuda), store=store.to(cuda),
        ann=type(idx.ann)(*(None if t is None else t.to(cuda) for t in idx.ann))))
    q = torch.as_tensor(rng.standard_normal((16, 8, d)), dtype=torch.float32)
    s0, i0 = cpu.search(q, None, params)
    s1, i1 = gpu.search(q, None, params)
    torch.testing.assert_close(s1.cpu(), s0, rtol=1e-5, atol=1e-4)
    diff = i1.cpu() != i0
    assert int(diff.sum()) <= 2


@pytest.mark.gpu
def test_mips_topk_rescans_when_the_bound_lets_too_much_through(cuda):
    """Every sampled row scores lowest, so the bound admits nearly every row
    and the candidates overflow: the call rescans exactly and still returns
    the plain result."""
    from repro_torch.kernels import query_fused as qf

    rng = np.random.default_rng(1)
    g = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=cuda)
    q = g(rng.integers(0, 4, (6, 32)), torch.float32)
    W = rng.integers(-3, 4, (30000, 32)).astype(np.float32)
    W[::qf.SAMPLE_STRIDE] = -3
    W = g(W)
    n0 = qf.mips_topk.rescans
    got = qf.mips_topk(q, W, kp=80)
    assert qf.mips_topk.rescans == n0 + 1
    want = ref.mips_topk_ref(q, W, kp=80)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _residual_tables(rng, n_cent, d, bits, exact):
    """Centroids (n_cent, d) and values (d, 2^bits): small integers when
    ``exact`` (every decode, product and sum is exact), else normal."""
    L = 1 << bits
    if exact:
        return (rng.integers(-3, 4, (n_cent, d)).astype(np.float32),
                np.sort(rng.integers(-4, 5, (d, L)), axis=1).astype(np.float32))
    return (rng.standard_normal((n_cent, d)).astype(np.float32),
            np.sort(rng.standard_normal((d, L)), axis=1).astype(np.float32))


def _close(got, want, tol, exact):
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin) and torch.equal(got[~fin], want[~fin])
    if exact:
        assert torch.equal(got, want)
    elif fin.any():
        scale = max(1.0, float(want[fin].abs().max()))
        assert float((got[fin] - want[fin]).abs().max()) <= tol * scale


@pytest.mark.gpu
@pytest.mark.parametrize("B,nlist,cap,d,nprobe", [
    (1, 8, 5, 16, 3),           # B=1, cap below a warp's rows
    (3, 16, 9, 32, 8),
    (2, 4, 1100, 2048, 3),      # full d', cap past a 1024-slot chunk
    (2, 6, 130, 1008, 4),       # d' off the 512-dim tile
    (2, 4, 130, 2044, 3),       # rows not whole words (1,022 / 511 bytes)
    (2, 4, 130, 2040, 3)])      # (1,020 / 510 bytes)
@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("exact", [False, True], ids=["float", "integer"])
def test_ivf_res_scan_kernel(cuda, B, nlist, cap, d, nprobe, bits, exact):
    """Pads (-1 slots, an empty list, an out-of-range probe) score -inf; the
    rest agree with the plain decode-then-score scan."""
    rng = np.random.default_rng(B * nlist + cap + bits)
    g = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=cuda)
    ids = rng.integers(-1, 99, (nlist, cap)).astype(np.int32)
    ids[1] = -1
    codes = rng.integers(0, 256, (nlist, cap, d * bits // 8)).astype(np.uint8)
    cent, values = _residual_tables(rng, nlist, d, bits, exact)
    q = rng.integers(-2, 3, (B, d)) if exact else rng.standard_normal((B, d))
    probe = rng.integers(0, nlist, (B, nprobe)).astype(np.int32)
    probe[0, 0] = 1
    args = (g(q, torch.float32), g(probe), g(ids), g(codes), g(cent), g(values))
    n0 = gather_scan.ivf_probe_res_scan.launches
    got = gather_scan.ivf_probe_res_scan(*args)
    assert gather_scan.ivf_probe_res_scan.launches == n0 + 1
    _close(got, ref.ivf_scan_res_ref(*args), 1e-5, exact)
    with pytest.raises(ValueError, match="uint8"):
        gather_scan.ivf_probe_res_scan(*args[:3], args[3].to(torch.int8), *args[4:])
    # pack_codes packs whole bytes: rows of 18 dims at 2 bits would be 4.5 bytes
    with pytest.raises(ValueError, match="whole bytes"):
        gather_scan.ivf_probe_res_scan(torch.zeros(1, 18, device=cuda), *args[1:5],
                                       torch.zeros(18, 4, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("B,C,Tq,d,kp,pmax,ncent", [
    (3, 12, 4, 16, 5, 2, 10), (1, 8, 3, 20, 6, 1, 3), (2, 40, 32, 128, 64, 5, 256),
    (2, 10, 40, 8, 9, 3, 7),
    (2, 12, 8, 116, 20, 2, 16),     # token rows not whole words (58 / 29 bytes)
    (2, 8, 32, 1024, 6, 2, 5),      # d = 1,024: the wide walk
    (2, 8, 512, 128, 7, 2, 9),      # Tq = 512 at the served d
    (2, 8, 100, 768, 5, 2, 4)])     # Tq = 100, d = 768
@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("exact", [False, True], ids=["float", "integer"])
def test_rerank_paged_res_kernel(cuda, B, C, Tq, d, kp, pmax, ncent, bits, exact):
    """Compressed pages decoded in the kernel: a doc with no tokens, -1
    candidates and table pads, k' above the docs; the top-k wrapper equals
    the CPU's."""
    rng = np.random.default_rng(B * C + Tq + bits)
    n_tokens = rng.integers(1, pmax * 16 + 1, C).astype(np.int32)
    n_tokens[1] = 0
    table = rng.permutation(C * pmax).reshape(C, pmax).astype(np.int32)
    table[np.arange(pmax)[None, :] >= (-(-n_tokens // 16))[:, None]] = -1
    cent, values = _residual_tables(rng, ncent, d, bits, exact)
    g = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=cuda)
    q = rng.integers(-2, 3, (B, Tq, d)) if exact else rng.standard_normal((B, Tq, d))
    args = (g(q, torch.float32), g(rng.random((B, Tq)) > 0.3),
            g(rng.integers(-1, C, (B, kp)), torch.int32),
            g(rng.integers(0, ncent, (C * pmax, 16)), torch.int32),
            g(rng.integers(0, 256, (C * pmax, 16, d * bits // 8)), torch.uint8),
            g(table), g(n_tokens), g(cent), g(values))
    n0 = gather_scan.rerank_paged_res_scores.launches
    got = gather_scan.rerank_paged_res_scores(*args)
    assert gather_scan.rerank_paged_res_scores.launches == n0 + 1
    # csrc/rerank_paged_res.cu: rerank_paged_res_plan
    assert gather_scan.rerank_paged_res_scores.last_path == (
        "tensor cores" if Tq <= 64 and d <= 128 else "cuda cores")
    want = ref.rerank_scores_paged_res_ref(*args)
    if exact and Tq > 64:
        # a pad's score sums Tq_valid NEGs, which rounds by the order of the
        # sum past a few dozen; the real rows are still exact
        real = want > ref.NEG / 2
        assert torch.equal(got[real], want[real])
        torch.testing.assert_close(got[~real], want[~real], rtol=1e-6, atol=0.0)
    elif exact:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    k = kp + 3
    s, i = ops.fused_rerank_paged_res(*args, k)
    s0, i0 = ops.fused_rerank_paged_res(*(a.cpu() for a in args), k)
    assert torch.equal(i.cpu(), i0)
    torch.testing.assert_close(s.cpu(), s0, rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [130, 66])
@pytest.mark.parametrize("exact", [False, True], ids=["float", "integer"])
def test_rerank_paged_res_kernel_at_widths_off_float4(cuda, d, exact):
    """Token widths pack_codes takes at 4 bits but not whole float4s (d % 4
    == 2, rows of 65 and 33 bytes): at d = 130 the CUDA-core kernel decodes
    the page a value at a time into a slot padded to whole float4s, d = 66
    runs on the tensor cores; scores as the plain version's (equal on
    integer tables)."""
    rng = np.random.default_rng(d + exact)
    B, C, Tq, kp, pmax, ncent, bits = 2, 10, 5, 12, 2, 6, 4
    n_tokens = rng.integers(1, pmax * 16 + 1, C).astype(np.int32)
    table = rng.permutation(C * pmax).reshape(C, pmax).astype(np.int32)
    cent, values = _residual_tables(rng, ncent, d, bits, exact)
    g = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=cuda)
    q = rng.integers(-2, 3, (B, Tq, d)) if exact else rng.standard_normal((B, Tq, d))
    args = (g(q, torch.float32), g(rng.random((B, Tq)) > 0.3),
            g(rng.integers(-1, C, (B, kp)), torch.int32),
            g(rng.integers(0, ncent, (C * pmax, 16)), torch.int32),
            g(rng.integers(0, 256, (C * pmax, 16, d * bits // 8)), torch.uint8),
            g(table), g(n_tokens), g(cent), g(values))
    got = gather_scan.rerank_paged_res_scores(*args)
    assert gather_scan.rerank_paged_res_scores.last_path == (
        "tensor cores" if d == 66 else "cuda cores")
    want = ref.rerank_scores_paged_res_ref(*args)
    if exact:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("B,Tq,d,dp,nlist,cap,nprobe,kp", [
    (1, 5, 16, 64, 6, 7, 2, 9),          # B=1, cap odd, kp > valid slots
    (3, 32, 128, 2048, 8, 300, 4, 256),  # full widths, cap past a pass of 128
    (4, 6, 20, 1008, 5, 11, 5, 60),      # d' off the 512-dim tile, kp > the strip
    (2, 8, 16, 256, 3, 1100, 2, 1500),   # cap past a 1024-slot chunk
    (2, 8, 16, 256, 3, 4000, 3, 4097),   # k' past the old shared-memory list's cap
    (2, 8, 16, 256, 3, 4000, 3, 8192),   # ... and kp > the valid slots
    (2, 8, 16, 2044, 4, 300, 3, 100),    # rows not whole words
    (2, 8, 16, 2040, 4, 300, 3, 100),
])
@pytest.mark.parametrize("bits", [2, 4])
def test_query_fused_res_kernel(cuda, B, Tq, d, dp, nlist, cap, nprobe, kp, bits):
    """Pads, an empty list and duplicated rows (exact ties); the result
    equals the residual default route's kernels (psi-pool, residual scan,
    stable top-k) bit for bit."""

    rng = np.random.default_rng(B * cap + dp + bits)
    g = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=cuda)
    w = [t.to(cuda) for t in _psi_params(rng, d, dp)]
    q = g(rng.standard_normal((B, Tq, d)), torch.float32)
    qm = g(rng.random((B, Tq)) > 0.3)
    ids = rng.permutation(10 ** 6)[:nlist * cap].reshape(nlist, cap).astype(np.int32)
    ids[:, cap - cap // 3:] = -1
    ids[1] = -1                                       # an empty list
    codes = rng.integers(0, 256, (nlist, cap, dp * bits // 8)).astype(np.uint8)
    codes[0, 2] = codes[0, 0]                         # exact ties within a list
    cent, values = _residual_tables(rng, nlist, dp, bits, False)
    probe = np.stack([rng.permutation(nlist)[:nprobe] for _ in range(B)]).astype(np.int32)
    probe[0, 0] = 0
    lists = (g(ids), g(codes), g(cent), g(values))
    args = (q, qm, *w, g(probe), *lists)
    n0 = ops.launch_counts()["query_fused_res"]
    got = ops.KERNELS["query_fused_res"](*args, kp=kp)
    assert ops.launch_counts()["query_fused_res"] == n0 + 1
    want = ref.query_fused_res_ref(*args, kp=kp)
    _same_topk(*got, *want, 1e-4)
    psi_q = fused_psi.fused_psi_pool(q, qm, *w)
    s = gather_scan.ivf_probe_res_scan(psi_q, g(probe), *lists).reshape(B, -1)
    flat_i = g(ids)[g(probe).long()].reshape(B, -1)
    top, pos = stable_topk(s, min(kp, s.shape[1]))
    top, idx = pad_topk(top, torch.gather(flat_i, 1, pos), kp)
    assert torch.equal(got[1], idx) and torch.equal(got[0], top)


def _res_pages(rng, cuda, B, C, Tq, d, kp, pmax, ncent, bits):
    """Compressed pages at served-like values (unit query tokens and
    centroids, residual values of 0.05), a doc without tokens, table pads,
    -1 candidates and a duplicated candidate (row 0, columns 1 and 4)."""
    g = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=cuda)
    unit = lambda x: x / np.linalg.norm(x, axis=-1, keepdims=True)
    n_tokens = rng.integers(1, pmax * 16 + 1, C).astype(np.int32)
    n_tokens[1] = 0
    table = rng.permutation(C * pmax).reshape(C, pmax).astype(np.int32)
    table[np.arange(pmax)[None, :] >= (-(-n_tokens // 16))[:, None]] = -1
    cand = rng.integers(-1, C, (B, kp)).astype(np.int32)
    cand[0, 1] = cand[0, 4] = 0
    qm = rng.random((B, Tq)) > 0.3
    qm[:, 0] = True
    return (g(unit(rng.standard_normal((B, Tq, d))), torch.float32), g(qm), g(cand),
            g(rng.integers(0, ncent, (C * pmax, 16)), torch.int32),
            g(rng.integers(0, 256, (C * pmax, 16, d * bits // 8)), torch.uint8),
            g(table), g(n_tokens), g(unit(rng.standard_normal((ncent, d))), torch.float32),
            g(np.sort(rng.standard_normal((d, 1 << bits)) * 0.05, axis=1), torch.float32))


def _rerank_res_fp64(args):
    """Exact MaxSim in fp64 over the host decoder's tokens."""
    from repro_torch.anns.quantization import ResidualCodec, residual_decode
    q, qm, cand, cent_pages, code_pages, table, n_tokens, cent, values = args
    toks = residual_decode(ResidualCodec(cent, None, values), cent_pages, code_pages).double()
    c = cand.long()
    real = c >= 0
    safe = c.clamp_min(0)
    tk = toks[table[safe].long().clamp_min(0)]               # (B, k', pmax, 16, d)
    B, kp, pmax, page, d = tk.shape
    sc = torch.einsum("bqd,bktd->bkqt", q.double(), tk.reshape(B, kp, pmax * page, d))
    nt = torch.where(real, n_tokens[safe], 0)
    pos = torch.arange(pmax * page, device=q.device)
    sc = torch.where((pos < nt[..., None])[:, :, None, :], sc, ref.NEG)
    return torch.where(qm[:, None, :], sc.amax(-1), 0.0).sum(-1)


@pytest.mark.gpu
@pytest.mark.parametrize("B,C,Tq,d,kp,pmax,ncent,bits,path", [
    (4, 300, 32, 128, 256, 5, 256, 4, "tensor cores"),   # the served widths
    (4, 300, 32, 128, 256, 5, 256, 2, "tensor cores"),
    (3, 40, 1, 128, 37, 5, 256, 4, "tensor cores"),      # Tq = 1
    (2, 40, 100, 128, 20, 3, 64, 4, "cuda cores"),       # Tq = 100: the table past a block
    (2, 40, 512, 128, 20, 3, 16, 4, "cuda cores"),       # Tq = 512
    (3, 40, 32, 20, 40, 3, 16, 4, "tensor cores"),       # d = 20, off a 32-column chunk
    (2, 40, 32, 130, 20, 3, 16, 4, "cuda cores"),        # d = 130, off float4s
    (2, 40, 32, 768, 20, 3, 16, 4, "cuda cores"),        # d = 768
    (2, 40, 32, 1024, 20, 3, 16, 4, "cuda cores"),       # d = 1,024: the wide walk
])
def test_rerank_paged_res_against_fp64(cuda, B, C, Tq, d, kp, pmax, ncent, bits, path):
    """rerank_paged_res_scores on both of its paths against fp64 MaxSim
    over the host decoder's tokens (ref.TF32_SPLIT_RTOL x max(1,
    max|exact|)), against its plain version (1e-4 + 1e-5 x max|plain|, the
    smoke's check) and, on the tensor cores' path, against the emulation
    of its arithmetic (ref.tf32_split_rerank_res); a duplicated candidate
    scores alike to the bit; pads at Tq_valid x NEG."""
    rng = np.random.default_rng(B * C + Tq + d + bits)
    args = _res_pages(rng, cuda, B, C, Tq, d, kp, pmax, ncent, bits)
    got = gather_scan.rerank_paged_res_scores(*args)
    assert gather_scan.rerank_paged_res_scores.last_path == path
    exact = _rerank_res_fp64(args)
    plain = ref.rerank_scores_paged_res_ref(*args, chunk=1)
    real = exact > ref.NEG / 2
    assert torch.equal(got > ref.NEG / 2, real)
    assert bool(got[0, 1] == got[0, 4])
    err = float((got[real].double() - exact[real]).abs().max())
    assert err <= ref.TF32_SPLIT_RTOL * max(1.0, float(exact[real].abs().max()))
    err = float((got[real] - plain[real]).abs().max())
    assert err <= 1e-4 + 1e-5 * float(plain[real].abs().max())
    torch.testing.assert_close(got[~real], plain[~real], rtol=1e-6, atol=0.0)
    if path == "tensor cores":
        emu = ref.tf32_split_rerank_res(*args)
        err = float((got[real] - emu[real]).abs().max())
        assert err <= ref.TF32_SPLIT_RTOL * max(1.0, float(exact[real].abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("dp,bits", [(2048, 4), (2048, 2), (2044, 4), (2040, 2)])
def test_residual_scans_against_fp64(cuda, dp, bits):
    """ivf_probe_res_scan and query_fused_res (a cluster of blocks a query,
    live rows only) at the served list shape: scores within 1e-5 x max(1,
    max|exact|) of the fp64 dot with the host decoder's rows (pads -inf),
    and of the emulation of the scorer (ref.res_scan_split); the one-launch
    kernel's ids and scores equal the psi-pool, the residual scan and a
    stable top-k' bit for bit."""
    from repro_torch.anns.quantization import ResidualCodec, residual_decode
    rng = np.random.default_rng(dp + bits)
    B, Tq, d, nlist, cap, nprobe, kp = 4, 32, 128, 48, 1024, 32, 1024
    g = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=cuda)
    counts = rng.integers(0, cap + 1, nlist)
    ids = np.where(np.arange(cap)[None] < counts[:, None],
                   rng.permutation(nlist * cap).reshape(nlist, cap), -1).astype(np.int32)
    ids[5, 7] = -1                                   # a hole among live slots
    codes = g(rng.integers(0, 256, (nlist, cap, dp * bits // 8)), torch.uint8)
    cent = rng.standard_normal((nlist, dp))
    cent = g(cent / np.linalg.norm(cent, axis=1, keepdims=True), torch.float32)
    values = g(np.sort(rng.standard_normal((dp, 1 << bits)) * 0.02, axis=1), torch.float32)
    probe = g(np.stack([rng.permutation(nlist)[:nprobe] for _ in range(B)]), torch.int32)
    probe[0, 0] = 5
    lists = (g(ids), codes, cent, values)
    w = [t.to(cuda) for t in _psi_params(rng, d, dp)]
    q = g(rng.standard_normal((B, Tq, d)), torch.float32)
    qm = g(rng.random((B, Tq)) > 0.3)
    psi_q = fused_psi.fused_psi_pool(q, qm, *w)
    got = gather_scan.ivf_probe_res_scan(psi_q, probe, *lists)
    rows = residual_decode(ResidualCodec(cent, None, values),
                           probe[..., None].expand(B, nprobe, cap), codes[probe.long()])
    exact = torch.einsum("bd,bpcd->bpc", psi_q.double(), rows.double())
    fin = lists[0][probe.long()] >= 0
    assert torch.equal(torch.isfinite(got), fin)
    tol = 1e-5 * max(1.0, float(exact[fin].abs().max()))
    assert float((got[fin].double() - exact[fin]).abs().max()) <= tol
    emu = ref.res_scan_split(psi_q, probe, *lists)
    assert float((got[fin] - emu[fin]).abs().max()) <= tol
    s, i = ops.KERNELS["query_fused_res"](q, qm, *w, probe, *lists, kp=kp)
    top, pos = stable_topk(got.reshape(B, -1), kp)
    top, idx = pad_topk(top, torch.gather(lists[0][probe.long()].reshape(B, -1), 1, pos), kp)
    assert torch.equal(s, top) and torch.equal(i, idx)


def _fp32_pages(rng, cuda, B, C, Tq, d, kp, pmax):
    """fp32 pages at served-like values (unit query and page tokens), a doc
    without tokens, table pads, -1 candidates and a duplicated candidate
    (row 0, columns 1 and 4)."""
    g = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=cuda)
    unit = lambda x: x / np.linalg.norm(x, axis=-1, keepdims=True)
    n_tokens = rng.integers(1, pmax * 16 + 1, C).astype(np.int32)
    n_tokens[1] = 0
    table = rng.permutation(C * pmax).reshape(C, pmax).astype(np.int32)
    table[np.arange(pmax)[None, :] >= (-(-n_tokens // 16))[:, None]] = -1
    cand = rng.integers(-1, C, (B, kp)).astype(np.int32)
    cand[0, 1] = cand[0, 4] = 0
    qm = rng.random((B, Tq)) > 0.3
    qm[:, 0] = True
    return (g(unit(rng.standard_normal((B, Tq, d))), torch.float32), g(qm), g(cand),
            g(unit(rng.standard_normal((C * pmax, 16, d))), torch.float32), g(table),
            g(n_tokens))


@pytest.mark.gpu
@pytest.mark.parametrize("B,C,Tq,d,kp,pmax,path", [
    (4, 300, 32, 128, 256, 5, "tensor cores"),    # the served widths
    (3, 40, 1, 128, 37, 5, "tensor cores"),       # Tq = 1
    (2, 40, 64, 128, 20, 3, "tensor cores"),      # Tq = 64: a 64-token tile, two slots
    (3, 40, 32, 20, 40, 3, "tensor cores"),       # d = 20, off a 32-column chunk
    (2, 40, 100, 128, 20, 3, "cuda cores"),       # Tq = 100: the image past a block
    (2, 40, 512, 128, 20, 3, "cuda cores"),       # Tq = 512
    (2, 40, 32, 130, 20, 3, "cuda cores"),        # d = 130, off float4s
    (2, 40, 32, 768, 20, 3, "cuda cores"),        # d = 768
    (2, 40, 32, 1024, 20, 3, "cuda cores"),       # d = 1,024: the wide walk
])
def test_rerank_paged_against_fp64(cuda, B, C, Tq, d, kp, pmax, path):
    """rerank_paged_scores on both of its paths against fp64 MaxSim
    (ref.TF32_SPLIT_RTOL x max(1, max|exact|)), against its plain version
    (1e-4 + 1e-5 x max|plain|, the smoke's check) and, on the tensor cores'
    path, against the emulation of its arithmetic (ref.tf32_split_rerank_paged);
    a duplicated candidate scores alike to the bit; pads at Tq_valid x NEG."""
    rng = np.random.default_rng(B * C + Tq + d)
    args = _fp32_pages(rng, cuda, B, C, Tq, d, kp, pmax)
    got = gather_scan.rerank_paged_scores(*args)
    assert gather_scan.rerank_paged_scores.last_path == path
    q, qm, cand, pages_, table, n_tokens = args
    c = cand.long()
    safe = c.clamp_min(0)
    tk = pages_[table[safe].long().clamp_min(0)].double()     # (B, k', pmax, 16, d)
    sc = torch.einsum("bqd,bktd->bkqt", q.double(), tk.reshape(B, kp, pmax * 16, d))
    nt = torch.where(c >= 0, n_tokens[safe], 0)
    pos = torch.arange(pmax * 16, device=cuda)
    sc = torch.where((pos < nt[..., None])[:, :, None, :], sc, ref.NEG)
    exact = torch.where(qm[:, None, :], sc.amax(-1), 0.0).sum(-1)
    plain = ref.rerank_scores_paged_ref(*args, chunk=1)
    real = exact > ref.NEG / 2
    assert torch.equal(got > ref.NEG / 2, real)
    assert bool(got[0, 1] == got[0, 4])
    err = float((got[real].double() - exact[real]).abs().max())
    assert err <= ref.TF32_SPLIT_RTOL * max(1.0, float(exact[real].abs().max()))
    err = float((got[real] - plain[real]).abs().max())
    assert err <= 1e-4 + 1e-5 * float(plain[real].abs().max())
    torch.testing.assert_close(got[~real], plain[~real], rtol=1e-6, atol=0.0)
    if path == "tensor cores":
        emu = ref.tf32_split_rerank_paged(*args)
        err = float((got[real] - emu[real]).abs().max())
        assert err <= ref.TF32_SPLIT_RTOL * max(1.0, float(exact[real].abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("case,B,nlist,cap,dp,nprobe", [
    ("one_list", 20, 6, 300, 2048, 3),      # every query probes list 2: 20 readers > 8
    ("empty_lists", 6, 8, 64, 2048, 4),     # lists 1 and 5 empty
    ("holes", 5, 6, 300, 2048, 3),          # -1 anywhere among live slots
    ("dup_out_of_range", 5, 6, 40, 2048, 4),  # a list twice, probes -1 and nlist + 3
    ("cap_1", 7, 9, 1, 2048, 4),
    ("cap_off_tile", 4, 5, 300, 20, 3),     # cap off 32 and 256; d' 20: off 16 bytes
    ("one_list_4096", 20, 6, 300, 4096, 3),  # the skew at d' 4,096: q from device memory
    ("holes_4096", 5, 6, 300, 4096, 3),
])
@pytest.mark.parametrize("sq8", [False, True])
def test_ivf_scan_grouped_under_skew(cuda, case, B, nlist, cap, dp, nprobe, sq8):
    """ivf_probe_scan walks lists, not queries: skewed readers, empty lists,
    holes, duplicate and out-of-range probes, cap 1 and off the row tiles,
    d' 2,048, 4,096 and off 16 bytes.  Scores as the plain version's (pads and
    out-of-range strips -inf), and query_fused at k' >= the strip equals
    psi-pool + ivf_probe_scan + a stable top-k' bit for bit."""
    rng = np.random.default_rng(nlist * cap + dp + sq8)
    g = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=cuda)
    d, Tq = 16, 6
    ids = rng.permutation(10 ** 6)[:nlist * cap].reshape(nlist, cap).astype(np.int32)
    live = rng.integers(cap // 2, cap + 1, nlist) if cap > 1 else np.ones(nlist, np.int64)
    ids[np.arange(cap)[None, :] >= live[:, None]] = -1
    probe = np.stack([rng.permutation(nlist)[:nprobe] for _ in range(B)]).astype(np.int32)
    if case.startswith("one_list"):
        probe[:, 1] = 2
        probe[probe[:, 0] == 2, 0] = 0
        probe[probe[:, 2] == 2, 2] = 0
    elif case == "empty_lists":
        ids[[1, 5]] = -1
        probe[0, :2] = [1, 5]
    elif case.startswith("holes"):
        ids[rng.random(ids.shape) < 0.2] = -1
    elif case == "dup_out_of_range":
        probe[0, 1] = probe[0, 0]
        probe[1, 2] = -1
        probe[2, 0] = nlist + 3
    vecs = g(rng.standard_normal((nlist, cap, dp)) * (ids >= 0)[..., None], torch.float32)
    lists = list(sq8_quant(vecs)) if sq8 else [vecs]
    w = [t.to(cuda) for t in _psi_params(rng, d, dp)]
    q = g(rng.standard_normal((B, Tq, d)), torch.float32)
    qm = g(rng.random((B, Tq)) > 0.3)
    gp, gi = g(probe), g(ids)
    psi_q = fused_psi.fused_psi_pool(q, qm, *w)
    n0 = gather_scan.ivf_probe_scan.launches
    got = gather_scan.ivf_probe_scan(psi_q, gp, gi, *lists)
    assert gather_scan.ivf_probe_scan.launches == n0 + 1
    inr = (gp >= 0) & (gp < nlist)                         # (B, nprobe)
    want = ref.ivf_scan_ref(psi_q, gp.clamp(0, nlist - 1), gi, *lists)
    want = torch.where(inr[..., None], want, float("-inf"))
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    assert bool(torch.isneginf(got[~fin]).all())
    denom = max(1.0, float(want[fin].abs().max()))
    assert float((got[fin] - want[fin]).abs().max()) / denom < SQ8_RTOL
    # query_fused pools, scans with this body and selects: at k' past the
    # strip and at k' 100, psi-pool + ivf_probe_scan + a stable top-k' bit
    # for bit, and its plain twin's ids up to near-ties
    flat_i = torch.where(inr[..., None], gi[gp.clamp(0, nlist - 1).long()], -1).reshape(B, -1)
    for kp in (nprobe * cap + 5, 100):
        n0 = ops.launch_counts()["query_fused"]
        s, i = ops.KERNELS["query_fused"](q, qm, *w, gp, gi, *lists, kp=kp)
        assert ops.launch_counts()["query_fused"] == n0 + 1
        top, pos = stable_topk(got.reshape(B, -1), min(kp, nprobe * cap))
        top, idx = pad_topk(top, torch.gather(flat_i, 1, pos), kp)
        assert torch.equal(i, idx) and torch.equal(s, top)
    _same_topk(s, i, *ref.query_fused_grouped(q, qm, *w, gp, gi, *lists, kp=kp),
               SQ8_RTOL if sq8 else 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("case,B,nlist,cap,dp,nprobe,bits", [
    ("one_list", 20, 6, 300, 2048, 3, 4),     # every query probes list 2: 20 readers > 16
    ("one_list", 20, 6, 300, 2048, 3, 2),
    ("empty_lists", 6, 8, 64, 2048, 4, 4),    # lists 1 and 5 empty
    ("holes", 5, 6, 300, 2048, 3, 2),         # -1 anywhere among live slots
    ("dup_out_of_range", 5, 6, 40, 2048, 4, 4),  # a list twice, probes -1 and nlist + 3
    ("cap_1", 7, 9, 1, 2048, 4, 2),
    ("cap_off_tile", 4, 5, 300, 20, 3, 4),    # cap off 32 and 256; rows of 10 B
    ("cap_off_tile", 4, 5, 300, 1008, 3, 2),  # rows of 252 B: words, not 16-byte chunks
    ("bytes", 5, 6, 130, 2044, 3, 4),         # rows of 1,022 B: not whole words
    ("bytes", 5, 6, 130, 2040, 3, 2),         # 510 B
    ("one_list_4096", 20, 6, 300, 4096, 3, 4),  # d' past the registers' q and the table
    ("holes_4096", 5, 6, 300, 4096, 3, 2),
    ("wide_words", 5, 6, 100, 4104, 3, 4),    # 2,052 B: words, not 16-byte chunks
    ("wide_words", 5, 6, 100, 4112, 3, 2),    # 1,028 B
    ("wide_bytes", 5, 6, 100, 4098, 3, 4),    # 2,049 B
    ("wide_bytes", 5, 6, 100, 4104, 3, 2),    # 1,026 B
])
@pytest.mark.parametrize("exact", [False, True], ids=["float", "integer"])
def test_ivf_res_scan_grouped_under_skew(cuda, case, B, nlist, cap, dp, nprobe, bits, exact):
    """ivf_probe_res_scan walks lists, not queries, in every kernel instance
    (rows staged or read from device memory as words or bytes; d' up to and
    past 2,048): skewed readers, empty lists, holes, duplicate and
    out-of-range probes, cap 1 and off the tiles.  Scores as the emulation
    of the scorer's arithmetic (ref.res_scan_split, within 1e-5 x max(1,
    max|emulation|); exactly on integer tables, where every sum is exact),
    pads and out-of-range strips -inf; query_fused_res (d' <= 4,096) equals
    psi-pool + ivf_probe_res_scan + a stable top-k' bit for bit."""
    rng = np.random.default_rng(nlist * cap + dp + bits)
    g = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=cuda)
    d, Tq = 16, 6
    ids = rng.permutation(10 ** 6)[:nlist * cap].reshape(nlist, cap).astype(np.int32)
    live = rng.integers(cap // 2, cap + 1, nlist) if cap > 1 else np.ones(nlist, np.int64)
    ids[np.arange(cap)[None, :] >= live[:, None]] = -1
    probe = np.stack([rng.permutation(nlist)[:nprobe] for _ in range(B)]).astype(np.int32)
    if case.startswith("one_list"):
        probe[:, 1] = 2
        probe[probe[:, 0] == 2, 0] = 0
        probe[probe[:, 2] == 2, 2] = 0
    elif case == "empty_lists":
        ids[[1, 5]] = -1
        probe[0, :2] = [1, 5]
    elif case.startswith("holes"):
        ids[rng.random(ids.shape) < 0.2] = -1
    elif case == "dup_out_of_range":
        probe[0, 1] = probe[0, 0]
        probe[1, 2] = -1
        probe[2, 0] = nlist + 3
    codes = g(rng.integers(0, 256, (nlist, cap, dp * bits // 8)), torch.uint8)
    cent, values = _residual_tables(rng, nlist, dp, bits, exact)
    lists = (g(ids), codes, g(cent), g(values))
    gp = g(probe)
    if exact:
        psi_q = g(rng.integers(-2, 3, (B, dp)), torch.float32)
    else:
        psi_q = g(rng.standard_normal((B, dp)) / np.sqrt(dp), torch.float32)
    n0 = gather_scan.ivf_probe_res_scan.launches
    got = gather_scan.ivf_probe_res_scan(psi_q, gp, *lists)
    assert gather_scan.ivf_probe_res_scan.launches == n0 + 1
    inr = (gp >= 0) & (gp < nlist)
    want = ref.res_scan_split(psi_q, gp.clamp(0, nlist - 1), *lists)
    want = torch.where(inr[..., None], want, float("-inf"))
    _close(got, want, 1e-5, exact)
    if dp > 4096 or exact:
        return
    w = [t.to(cuda) for t in _psi_params(rng, d, dp)]
    q = g(rng.standard_normal((B, Tq, d)), torch.float32)
    qm = g(rng.random((B, Tq)) > 0.3)
    pq = fused_psi.fused_psi_pool(q, qm, *w)
    sc = gather_scan.ivf_probe_res_scan(pq, gp, *lists).reshape(B, -1)
    flat_i = torch.where(inr[..., None], lists[0][gp.clamp(0, nlist - 1).long()], -1)
    for kp in (nprobe * cap + 5, 100):
        s, i = ops.KERNELS["query_fused_res"](q, qm, *w, gp, *lists, kp=kp)
        top, pos = stable_topk(sc, min(kp, nprobe * cap))
        top, idx = pad_topk(top, torch.gather(flat_i.reshape(B, -1), 1, pos), kp)
        assert torch.equal(i, idx) and torch.equal(s, top)


# --------------------------------------------------------------------------
# mutation on the card
# --------------------------------------------------------------------------

def _mutation_index(tier, m=600, T=24, d=32, dp=256):
    """A CPU retriever from arrays (fp32 or SQ8 lists of an fp32 store, or
    4-bit residual lists of a compressed store), its docs' tokens and mask."""
    rng = np.random.default_rng(11)
    tok = torch.nn.functional.normalize(torch.as_tensor(
        rng.standard_normal((m, T, d)), dtype=torch.float32), dim=-1)
    mask = torch.as_tensor(rng.random((m, T)) > 0.3)
    W = torch.as_tensor(rng.standard_normal((m, dp)), dtype=torch.float32)
    cfg = LemurConfig(d=d, d_prime=dp, k=20, k_prime=128, n_ols=512)
    codec = None
    if tier == "residual":
        codec = train_residual_codec(torch.Generator().manual_seed(2), tok[mask], bits=4,
                                     ncent=32, iters=3)
        cfg = cfg.replace(ivf=cfg.ivf.replace(residual_bits=4),
                          residual=cfg.residual.replace(enabled=True))
    cfg = cfg.replace(ivf=cfg.ivf.replace(sq8=tier == "sq8"))
    store, _ = pages.from_dense(W, tok, mask, codec=codec)
    store.alive[[4, 8]] = False
    psi = Psi.init(d, dp, torch.Generator().manual_seed(0), device="cpu")
    return LemurRetriever.from_arrays(cfg, psi, store, generator=torch.Generator().manual_seed(1))


def _on_card(r, cuda):
    """The same index on the card, its own tensors (a retriever that owns
    them, as ``load`` makes)."""
    idx = r.index
    return LemurRetriever._owning(idx._replace(
        psi=copy.deepcopy(idx.psi).to(cuda), store=idx.store.to(cuda),
        stats=type(idx.stats)(*(t.to(cuda) for t in idx.stats)),
        ann=type(idx.ann)(*(None if t is None else t.to(cuda) for t in idx.ann))))


def _new_docs(rng, n, T, d, long_doc=0):
    lengths = rng.integers(1, T + 1, n)
    if long_doc:
        lengths[0] = long_doc
    Tm = int(lengths.max())
    tok = torch.nn.functional.normalize(torch.as_tensor(
        rng.standard_normal((n, Tm, d)), dtype=torch.float32), dim=-1)
    mask = torch.arange(Tm)[None, :] < torch.as_tensor(lengths)[:, None]
    return tok * mask[..., None], mask


@pytest.mark.gpu
@pytest.mark.parametrize("tier", ["fp32", "sq8", "residual"])
def test_mutation_pages_and_lists_on_card_match_cpu(cuda, tier):
    """pages.delete_docs / add_docs and ivf.extend_ivf given the same W rows
    on the card and on the CPU: every field, the free list and the bytes
    bit for bit, through a table-width growth (a doc of 70 tokens), a slot
    capacity growth (600 + 700 docs past 1,024), a pool growth and a list
    capacity growth (300 rows at one centroid).  The assignment is fp32 on
    both (TF32 is off in the package)."""
    rng = np.random.default_rng(3)
    r = _mutation_index(tier)
    g = _on_card(r, cuda)
    sc, sg = r.index.store, g.index.store
    fc, fg = pages.free_list(sc), pages.free_list(sg)
    assert fc == fg
    sc, fc, bc = pages.delete_docs(sc, fc, [1, 2, 50])
    sg, fg, bg = pages.delete_docs(sg, fg, [1, 2, 50])
    assert (fc, bc) == (fg, bg)
    tok, mask = _new_docs(rng, 700, 24, 32, long_doc=70)
    w = torch.as_tensor(rng.standard_normal((700, 256)), dtype=torch.float32)
    sc, fc, ic, bc = pages.add_docs(sc, fc, w, tok, mask)
    sg, fg, ig, bg = pages.add_docs(sg, fg, w.to(cuda), tok.to(cuda), mask.to(cuda))
    assert (fc, bc) == (fg, bg) and np.array_equal(ic, ig)
    assert sg.capacity == 2048 and sg.pages_per_doc == 8 and sg.n_pages > r.index.store.n_pages
    for k in sc._fields:
        a, b = getattr(sc, k), getattr(sg, k)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b.cpu()), k
    ac, ag = r.index.ann, g.index.ann
    rows = ac.centroids[3] + (ac.mean if ac.mean is not None else 0) + 0.01 * torch.as_tensor(
        rng.standard_normal((300, 256)), dtype=torch.float32)
    for new in (w[:40], rows):
        ac = ivf_mod.extend_ivf(ac, new)
        ag = ivf_mod.extend_ivf(ag, new.to(cuda))
        for k, a in ac._asdict().items():
            if a is not None:
                assert torch.equal(a, getattr(ag, k).cpu()), k
    assert ag.capacity >= 512


@pytest.mark.gpu
@pytest.mark.parametrize("tier", ["fp32", "sq8", "residual"])
def test_mutation_through_the_facade_on_card(cuda, tier):
    """The same delete / add / update through the facade on the card and on
    the CPU (each with its fallback solver over the same drawn tokens):
    pages, table, counts, tombstones, free list and bytes bit for bit; the
    list ids and counts equal; on the card the new rows' token MaxSim
    targets within ref.TF32_SPLIT_RTOL of the plain ones and the W rows
    within that tolerance carried through the solve (x the Gram condition
    number) of the plain fit; routes' ids up to near-ties; no deleted id
    served; an add within capacity wrote the pool and W in place."""
    rng = np.random.default_rng(4)
    r = _mutation_index(tier)
    g = _on_card(r, cuda)
    ptrs = (g.index.store.tok_pages.data_ptr(), g.index.store.W.data_ptr())
    tok, mask = _new_docs(rng, 40, 24, 32)
    utok, umask = _new_docs(rng, 5, 24, 32)
    n0 = kmaxsim.token_maxsim.launches
    for x, t, mk, ut, um in ((r, tok, mask, utok, umask),
                             (g, tok.to(cuda), mask.to(cuda), utok.to(cuda), umask.to(cuda))):
        x.delete([10, 11, 12])
        x.add(t, mk)
        x.update([13, int(x.last_added_ids[0])], ut, um)
    assert kmaxsim.token_maxsim.launches == n0 + 2
    assert (g.index.store.tok_pages.data_ptr(), g.index.store.W.data_ptr()) == ptrs
    sc, sg = r.index.store, g.index.store
    for k in ("tok_pages", "page_table", "n_tokens", "alive", "n_docs", "cent_pages",
              "code_pages"):
        if getattr(sc, k) is not None:
            assert torch.equal(getattr(sc, k), getattr(sg, k).cpu()), k
    assert g._free() == r._free() and (g.version, g.bytes_moved) == (r.version, r.bytes_moved)
    assert torch.equal(g.solver_state["x_ols"].cpu(), r.solver_state["x_ols"])
    for k in ("ids", "counts"):
        assert torch.equal(getattr(r.index.ann, k), getattr(g.index.ann, k).cpu()), k
    solver, stats = g.solver_state, g.index.stats
    x = solver["x_ols"]
    gt = maxsim.token_maxsim(x, tok.to(cuda), mask.to(cuda))
    gp = ref.token_maxsim_ref(x, tok.to(cuda), mask.to(cuda))
    assert (gt - gp).abs().max() <= ref.TF32_SPLIT_RTOL * max(1.0, float(gp.abs().max()))
    wp = torch.cholesky_solve(solver["feats"].T @ ((gp - stats.mean) / stats.std),
                              solver["chol"]).T
    sv = torch.linalg.svdvals(solver["chol"])
    cond = float((sv.max() / sv.min()) ** 2)
    new = torch.arange(600, 640, device=cuda)
    err = float((sg.W[new] - wp).abs().max())
    assert err <= ref.TF32_SPLIT_RTOL * cond * float(wp.abs().max()), (err, cond)
    q = torch.as_tensor(rng.standard_normal((16, 8, 32)), dtype=torch.float32)
    gone = [10, 11, 12, 13, 600]
    for params in (SearchParams(), SearchParams(backend=IVFSearchParams(use_one_launch=True)),
                   SearchParams(use_ann=False, use_one_launch=True)):
        s0, i0 = r.search(q, None, params)
        s1, i1 = g.search(q, None, params)
        torch.testing.assert_close(s1.cpu(), s0, rtol=1e-5, atol=1e-4)
        assert int((i1.cpu() != i0).sum()) <= 2
        assert not np.isin(i1.cpu().numpy(), gone).any()


@pytest.mark.gpu
def test_snapshot_and_clone_on_card(cuda):
    """A held snapshot and a clone answer as before while the other side
    mutates on the card; the first write after the snapshot copies W."""
    rng = np.random.default_rng(6)
    g = _on_card(_mutation_index("sq8"), cuda)
    q = torch.as_tensor(rng.standard_normal((8, 8, 32)), dtype=torch.float32, device=cuda)
    qm = torch.ones(q.shape[:2], dtype=torch.bool, device=cuda)
    p = g.resolve(SearchParams(use_ann=False, use_one_launch=True))
    snap = g.snapshot()
    twin = g.clone()
    want = search_pipeline(snap, q, qm, p)
    want_twin = twin.search(q, qm)
    W = g.index.store.W.data_ptr()
    tok, mask = _new_docs(rng, 30, 24, 32)
    g.add(tok.to(cuda), mask.to(cuda))
    g.delete([0, 1, 2])
    assert g.index.store.W.data_ptr() != W
    got = search_pipeline(snap, q, qm, p)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    got = twin.search(q, qm)
    assert torch.equal(got[0], want_twin[0]) and torch.equal(got[1], want_twin[1])


# --------------------------------------------------------------------------
# the other first-stage backends: the card's run against the CPU's
# --------------------------------------------------------------------------

def _backend_data(m=9_001, T=12, d=32, dp=48, B=6, seed=3):
    """A corpus whose doc count is no multiple of any chunk (8,192-row scan
    blocks, DESSERT's doc chunks, the builds' reads)."""
    from repro_torch.anns.base import CorpusView, QueryBatch

    rng = np.random.default_rng(seed)
    f = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=torch.float32)  # noqa: E731
    mask = torch.as_tensor(rng.random((m, T)) < 0.7)
    mask[:, 0] = True
    qm = torch.as_tensor(rng.random((B, 5)) < 0.8)
    qm[:, 0] = True
    return (CorpusView(f(m, dp), f(m, T, d), mask), QueryBatch(f(B, dp), f(B, 5, d), qm))


def _to(x, dev):
    return type(x)(*(None if t is None else t.to(dev) for t in x))


def _near_tie_ids(s_cpu, i_cpu, s_card, i_card):
    """Scores within rtol 1e-5 / atol 1e-4; ids equal up to near-ties."""
    s_card, i_card = s_card.cpu(), i_card.cpu()
    torch.testing.assert_close(s_card, s_cpu, rtol=1e-5, atol=1e-4)
    diff = i_card != i_cpu
    gap = torch.where(torch.isfinite(s_cpu), s_card - s_cpu, 0.0).abs() / s_cpu.abs().clamp_min(1)
    assert bool((gap[diff] < 1e-5).all()), "an id differs without a near-tie"


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["bruteforce", "ivf", "muvera", "dessert", "token_pruning"])
def test_backend_search_on_card_matches_cpu(cuda, name, monkeypatch):
    """Each backend built on the CPU, its state moved to the card: the card's
    search (DESSERT a chunk of 1,000 docs at a time) against the CPU's."""
    from repro_torch.anns import dessert, registry

    monkeypatch.setattr(dessert, "_SEARCH_DOCS", 1000)
    view, qb = _backend_data()
    be = registry.get_backend(name)
    state = be.build(torch.Generator().manual_seed(0), view, None)
    arrays, meta = be.pack_state(state)
    on_card = be.unpack_state({k: v.to(cuda) for k, v in arrays.items()}, meta)
    for k in (100, 1024):
        s_cpu, i_cpu = be.search(state, qb, k, be.default_params(None))
        s_card, i_card = be.search(on_card, _to(qb, cuda), k, be.default_params(None))
        assert i_card.dtype == torch.int32 and i_card.device.type == "cuda"
        _near_tie_ids(s_cpu, i_cpu, s_card, i_card)


@pytest.mark.gpu
def test_dessert_chunked_route_matches_direct_on_card(cuda):
    """The product route (bf16 0/1 products, exact counts) against the JAX
    form's (B, m, L, Tq) lookup, both on the card: the same table values
    summed in the same order."""
    from repro_torch.anns import dessert
    from repro_torch.anns.base import CorpusView

    view, qb = _backend_data(m=2_999)
    idx = dessert.build_dessert(CorpusView(None, view.doc_tokens.to(cuda),
                                           view.doc_mask.to(cuda)), dessert.DessertConfig())
    q, qm = qb.tokens.to(cuda), qb.mask.to(cuda)
    for chunk in (300, 4096):
        s, i = dessert.search_dessert(idx, q, qm, k_prime=500, chunk=chunk)
        ds, di = dessert.search_dessert_direct(idx, q, qm, k_prime=500)
        _near_tie_ids(ds.cpu(), di.cpu(), s, i)
    # the hashes: a doc's bits differ only where a token's dot with a plane
    # is within 1e-5 ||token|| ||plane|| of 0 (a sign of rounding)
    cpu = dessert.build_dessert(view, dessert.DessertConfig())
    assert torch.equal(cpu.hyper, idx.hyper.cpu())
    flips = (cpu.occupancy != idx.occupancy.cpu()).any(-1).any(-1)
    hyp = cpu.hyper.reshape(-1, cpu.hyper.shape[-1])
    dots = view.doc_tokens @ hyp.T
    scale = view.doc_tokens.norm(dim=-1)[..., None] * hyp.norm(dim=-1)
    near = ((dots.abs() < 1e-5 * scale) & view.doc_mask[..., None]).any(-1).any(-1)
    assert not bool((flips & ~near).any()), "an occupancy flip without a near-zero dot"


@pytest.mark.gpu
def test_token_pruning_lists_on_card_match_cpu(cuda):
    """Lists built and extended on the card equal the CPU's bit for bit,
    given the same centroids; the ragged search equals the JAX form's."""
    from repro_torch.anns import token_pruning as tp
    from repro_torch.anns.base import CorpusView

    view, qb = _backend_data(m=3_001)
    cpu = tp.build_token_pruning(CorpusView(None, view.doc_tokens[:2500],
                                            view.doc_mask[:2500]), nlist=16,
                                 generator=torch.Generator().manual_seed(0))
    card = tp.build_token_pruning(CorpusView(None, view.doc_tokens[:2500].to(cuda),
                                             view.doc_mask[:2500].to(cuda)),
                                  centroids=cpu.centroids.to(cuda))
    assert torch.equal(card.doc_lists.cpu(), cpu.doc_lists)
    assert torch.equal(card.counts.cpu(), cpu.counts)
    cpu = tp.extend_token_pruning(cpu, view.doc_tokens[2500:], view.doc_mask[2500:], 2500)
    card = tp.extend_token_pruning(card, view.doc_tokens[2500:].to(cuda),
                                   view.doc_mask[2500:].to(cuda), 2500)
    assert torch.equal(card.doc_lists.cpu(), cpu.doc_lists)
    q, qm = qb.tokens.to(cuda), qb.mask.to(cuda)
    s, i = tp.search_token_pruning(card, q, qm, nprobe=8, k_prime=300, m=view.m)
    ds, di = tp.search_token_pruning_direct(card, q, qm, nprobe=8, k_prime=300, m=view.m)
    assert torch.equal(s, ds) and torch.equal(i, di)


# --------------------------------------------------------------------------
# online serving, the fleet router and the index lifecycle on the card
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def online_card():
    """A small IVF build on the card (the lifecycle suites' widths, 3,000
    docs) and its ragged host queries."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    corpus = synthetic.make_corpus(m=3000, d=32, avg_tokens=16, max_tokens=24,
                                   n_centers=64, seed=0)
    cfg = LemurConfig(d=32, d_prime=128, m_pretrain=256, n_train=2048, n_ols=512,
                      epochs=3, k=10, k_prime=64)
    r = LemurRetriever.build(corpus, cfg, generator=torch.Generator().manual_seed(0),
                             device="cuda")
    from repro_torch.serving import ragged_queries
    return r, corpus, ragged_queries(48, 32, (2, 40), seed=4)


@pytest.mark.gpu
def test_server_replay_on_card(online_card):
    """An open-loop replay through a RetrieverServer on the card: nothing
    lost, one launch of each serving kernel a micro-batch, the served
    shapes within the ladder's bound, and every result's ids equal to a
    direct search of its query alone up to near-ties (relative gap < 1e-5),
    scores within rtol 1e-5 / atol 1e-4; the results come back as host
    arrays."""
    from repro_torch.serving import BucketLadder, RetrieverServer, poisson_trace, replay

    r, _, queries = online_card
    r = r.clone()
    ladder = BucketLadder((16, 32, 64), 8)
    tc0 = r.trace_count()
    with RetrieverServer(r, ladder=ladder, max_wait_us=500) as srv:
        srv.search(queries[0], timeout=120)          # first launches build the kernels
        ops.reset_launch_counts()
        res, rep = replay(srv, queries, poisson_trace(300.0, 0.5, seed=1), timeout=120)
    assert rep["n_lost"] == 0 and all(isinstance(x, tuple) for x in res)
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    assert counts == {k: rep["n_batches"] for k in ("fused_psi_pool", "ivf_probe_scan",
                                                    "rerank_paged_scores")}
    assert r.trace_count() - tc0 <= ladder.compile_bound()
    for i, (s, ids) in enumerate(res):
        q = queries[i % len(queries)]
        assert isinstance(s, np.ndarray) and isinstance(ids, np.ndarray)
        ws, wi = r.search(q[None], np.ones((1, len(q)), bool))
        _same_topk(torch.as_tensor(s)[None], torch.as_tensor(ids)[None], ws.cpu(), wi.cpu(),
                   1e-5)


@pytest.mark.gpu
def test_fleet_add_barrier_on_card(online_card):
    """Two clones on the card behind a Router: one add lands one
    snapshot_version on both, the new W rows are equal bit for bit, the
    first add copies what the clones share, and both answer a query the
    same way after it."""
    from repro_torch.fleet import Router, clone_replicas, warm_replicas
    from repro_torch.serving import BucketLadder

    r, corpus, queries = online_card
    reps = clone_replicas(r, 2)
    ladder = BucketLadder((32, 64), 4)
    warm_replicas(reps, ladder, 32)
    new = synthetic.make_corpus(m=5, d=32, avg_tokens=16, max_tokens=24, n_centers=64, seed=9)
    pool = r.index.store.tok_pages.data_ptr()
    with Router(reps, ladder=ladder, max_wait_us=500, stall_timeout_s=30.0) as router:
        f = router.add(new.doc_tokens, new.doc_mask)
        assert f.result(timeout=120) == r.m + 5 and f.snapshot_version == r.version + 1
        assert [rp.version for rp in reps] == [r.version + 1] * 2
        outs = [router.search(queries[1], timeout=120) for _ in range(4)]
    a, b = (rp.index.store for rp in reps)
    assert torch.equal(a.W[r.m:r.m + 5], b.W[r.m:r.m + 5])
    assert a.tok_pages.data_ptr() != pool and b.tok_pages.data_ptr() != pool
    assert r.index.store.tok_pages.data_ptr() == pool and r.m == corpus.m
    for s, ids in outs[1:]:
        assert np.array_equal(ids, outs[0][1]) and np.array_equal(s, outs[0][0])


@pytest.mark.gpu
def test_router_frees_replica_memory_on_card(online_card):
    """Two clones behind a Router copy what they share at their first add;
    once ``with Router(...)`` has exited and the caller drops the replicas,
    that card memory is freed with Python's cyclic collector off: no
    reference cycle through the router, its barriers or its requests keeps
    it."""
    import gc

    from repro_torch.fleet import Router, clone_replicas
    from repro_torch.serving import BucketLadder

    r, _, queries = online_card
    new = synthetic.make_corpus(m=5, d=32, avg_tokens=16, max_tokens=24, n_centers=64, seed=12)
    r.search(queries[0][None], np.ones((1, len(queries[0])), bool))
    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    gc.disable()
    try:
        reps = clone_replicas(r, 2)
        with Router(reps, ladder=BucketLadder((32, 64), 4), max_wait_us=500,
                    stall_timeout_s=30.0) as router:
            assert router.add(new.doc_tokens, new.doc_mask).result(timeout=120) == r.m + 5
            futs = [router.submit(q) for q in queries[:8]]
            router.kill_replica(1)
            for f in futs:
                f.result(timeout=120)
            torch.cuda.synchronize()
            grown = torch.cuda.memory_allocated() - mem0
        del router, reps, futs, f
        torch.cuda.synchronize()
        left = torch.cuda.memory_allocated() - mem0
    finally:
        gc.enable()
    pool = r.index.store.tok_pages
    assert grown >= 2 * pool.numel() * pool.element_size(), grown
    assert left <= 0.01 * grown, (left, grown)


@pytest.mark.gpu
def test_refresh_deterministic_on_card(online_card):
    """build_refresh of one snapshot with one seed, twice on the card: W,
    the OLS solver and every field of the rebuilt IVF equal bit for bit (the
    k-means sums in a fixed order); installing it serves from the card."""
    from repro_torch.anns.kmeans import segment_sums
    from repro_torch.lifecycle import build_refresh

    r, _, queries = online_card
    r = r.clone()
    new = synthetic.make_corpus(m=200, d=32, avg_tokens=16, max_tokens=24, n_centers=8,
                                topic_strength=4.0, seed=11)
    r.add(new.doc_tokens, new.doc_mask)
    r.delete(np.arange(0, 300, 3))
    a, b = build_refresh(r, seed=5), build_refresh(r, seed=5)
    assert a.W.device.type == "cuda" and a.phase_s.keys() == {"solver", "refit", "recluster"}
    assert torch.equal(a.W, b.W)
    for k in ("chol", "feats", "x_ols"):
        assert torch.equal(a.solver[k], b.solver[k]), k
    for k, v in a.ann._asdict().items():
        if v is not None:
            assert torch.equal(v, getattr(b.ann, k)), k
    x = torch.randn(70000, 64, device="cuda")
    c = torch.randint(0, 700, (70000,), device="cuda")
    s1, s2 = segment_sums(x, c, 700), segment_sums(x, c, 700)
    assert torch.equal(s1, s2)
    want = torch.zeros(700, 64, dtype=torch.float64, device="cuda").index_add_(0, c, x.double())
    torch.testing.assert_close(s1.double(), want, rtol=1e-5, atol=1e-4)
    r.install_refresh(a)
    q = queries[2]
    s, ids = r.search(q[None], np.ones((1, len(q)), bool))
    assert ids.device.type == "cuda" and bool((ids >= 0).all())


# --------------------------------------------------------------------------
# the v0 surface, the ops entries and the launcher on the card
# --------------------------------------------------------------------------

@pytest.mark.gpu
def test_ops_entries_are_their_wrappers_on_card(cuda):
    """The four ``ops`` entries launch the wrapper each names and give its
    bits: token MaxSim, the unpooled psi (from a Psi and from JAX's param
    dict), the SQ8 and fp32 IVF scans and the 4-bit residual scan, each
    counted once a call."""
    from repro_torch.anns.quantization import pack_codes
    from repro_torch.convert import psi_params_from_numpy

    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((37, 128)), dtype=torch.float32, device=cuda)
    docs = torch.as_tensor(rng.standard_normal((23, 9, 128)), dtype=torch.float32,
                           device=cuda)
    mask = torch.as_tensor(rng.random((23, 9)) > 0.3, device=cuda)
    w = _psi_params(rng, 128, 256)
    w_cuda = [t.to(cuda) for t in w]
    psi = Psi.from_arrays(*w, device="cuda")
    jdict = psi_params_from_numpy({"dense": {"kernel": w[0].numpy(), "bias": w[1].numpy()},
                                   "ln": {"scale": w[2].numpy(), "bias": w[3].numpy()}})
    nlist, cap, dp = 16, 40, 256
    ids = torch.as_tensor(rng.integers(-1, 500, (nlist, cap)), dtype=torch.int32, device=cuda)
    vecs = torch.as_tensor(rng.standard_normal((nlist, cap, dp)), dtype=torch.float32,
                           device=cuda)
    codes, scales = sq8_quant(vecs)
    q = torch.as_tensor(rng.standard_normal((6, dp)), dtype=torch.float32, device=cuda)
    probe = torch.as_tensor(rng.integers(0, nlist, (6, 5)), dtype=torch.int32, device=cuda)
    rcodes = pack_codes(torch.as_tensor(rng.integers(0, 16, (nlist, cap, dp)), device=cuda), 4)
    cent = torch.randn(nlist, dp, device=cuda)
    values = torch.sort(torch.randn(dp, 16, device=cuda), 1).values
    cases = [
        ("token_maxsim", lambda: ops.token_maxsim(x, docs, mask),
         lambda: kmaxsim.token_maxsim(x, docs, mask)),
        ("fused_psi", lambda: ops.fused_psi(x, psi), lambda: fused_psi.fused_psi(x, *w_cuda)),
        ("fused_psi", lambda: ops.fused_psi(x, jdict), lambda: fused_psi.fused_psi(x, *w_cuda)),
        ("ivf_probe_scan", lambda: ops.fused_ivf_scan(q, probe, ids, codes, scales),
         lambda: gather_scan.ivf_probe_scan(q, probe, ids, codes, scales)),
        ("ivf_probe_scan", lambda: ops.fused_ivf_scan(q, probe, ids, vecs),
         lambda: gather_scan.ivf_probe_scan(q, probe, ids, vecs)),
        ("ivf_probe_res_scan",
         lambda: ops.fused_ivf_scan_res(q, probe, ids, rcodes, cent, values),
         lambda: gather_scan.ivf_probe_res_scan(q, probe, ids, rcodes, cent, values)),
    ]
    for name, entry, wrapper in cases:
        want = wrapper()
        ops.reset_launch_counts()
        got = entry()
        assert {k: v for k, v in ops.launch_counts().items() if v} == {name: 1}, name
        assert got.device.type == "cuda" and torch.equal(got, want), name


@pytest.mark.gpu
def test_v0_query_and_candidates_are_the_facade_on_card(online_card):
    """The v0 ``query`` and ``candidates`` give, bit for bit, what
    ``LemurRetriever.search`` / ``first_stage`` give with the same resolved
    params, on the default, exact and nprobe-set routes."""
    from repro_torch.core import index as v0
    from repro_torch.retriever.facade import first_stage

    r, corpus, _ = online_card
    q = torch.as_tensor(synthetic.queries_from_corpus_query(corpus, 9, 8, seed=3),
                        device="cuda")
    qm = torch.ones(q.shape[:2], dtype=torch.bool, device="cuda")
    idx = r.index
    for kw in ({}, {"use_ann": False}, {"nprobe": 3}, {"k": 5, "k_prime": 40}):
        p = v0._legacy_params(idx, **kw)
        s, i = v0.query(idx, q, qm, **kw)
        ws, wi = r.search(q, qm, p)
        assert torch.equal(s, ws) and torch.equal(i, wi), kw
    for use_ann in (False, True):
        for nprobe in (None, 3):
            got = v0.candidates(idx, q, qm, k_prime=48, nprobe=nprobe, use_ann=use_ann)
            p = v0._legacy_params(idx, k_prime=48, nprobe=nprobe, use_ann=use_ann)
            assert torch.equal(got, first_stage(idx, q, qm, p)), (use_ann, nprobe)
            assert torch.equal(got, r.candidates(q, qm, p))
    toks, m = idx.dense_view()
    assert toks.device.type == "cuda" and toks.shape[0] == idx.m == r.m


@pytest.mark.gpu
def test_launcher_on_card_leaves_no_group(cuda, tmp_path):
    """The launcher at a small size on the card, every backend, the
    one-rank NCCL mesh, online and fleet: every backend served with one
    trace, no request lost, and the process group it made is gone."""
    import contextlib
    import io

    import torch.distributed as tdist

    from repro_torch.launch import serve

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = serve.main(["--m", "3000", "--d", "32", "--d-prime", "128", "--batch", "16",
                          "--n-batches", "3", "--backend", "all", "--save-dir", str(tmp_path),
                          "--mesh", "1", "--online", "--online-duration", "1", "--fleet", "2"])
    assert not tdist.is_initialized()
    rows = res["rows"]
    assert all(row["jit_traces"] == 1 for row in rows["backends"])
    assert rows["fleet"]["n_lost"] == 0 and rows["online"]["n_lost"] == 0
    assert res["retriever"].device.type == "cuda"
    out = buf.getvalue()
    assert out.count("sharded QPS=") == 2 and "[serve] fleet replicas=2" in out


# --------------------------------------------------------------------------
# the model layer (nn, optim, models/lm.py): the card against the CPU path
# --------------------------------------------------------------------------

LM_CONFIGS = ["gemma_7b", "qwen2_5_32b", "granite_20b", "llama4_maverick_400b",
              "deepseek_v3_671b"]


def _lm_close(got, want, rtol=1e-4, atol=1e-5, msg=""):
    np.testing.assert_allclose(got.detach().float().cpu().numpy(),
                               want.detach().float().cpu().numpy(), rtol=rtol, atol=atol,
                               err_msg=msg)


@pytest.mark.gpu
@pytest.mark.parametrize("name", LM_CONFIGS)
def test_smoke_lm_on_card_matches_cpu(cuda, name):
    """Each SMOKE LM (fp32) on the card against the same parameters and
    tokens on the CPU: forward, loss, gradients, one train step, prefill and
    three decode steps.  Tolerances: rtol 1e-4 / atol 1e-5 (fp32 on both,
    TF32 off; cuBLAS and the CPU sum in other orders); gradients within 1e-4
    x max |grad| of the leaf; the train step's new params within 2 x lr
    (Adam's first step moves a parameter by lr x g / (|g| + eps), which flips
    with a gradient at rounding level)."""
    import importlib

    from repro_torch.common.pytree import named_leaves, tree_map
    from repro_torch.models import lm
    from repro_torch.optim.adam import adam_init

    cfg = importlib.import_module(f"repro_torch.configs.{name}").SMOKE
    cpu = lm.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    card = tree_map(lambda t: t.to(cuda), cpu)
    toks = torch.randint(0, cfg.vocab, (2, 32), generator=torch.Generator().manual_seed(1))
    labels = torch.roll(toks, -1, 1)
    with torch.no_grad():
        h_c, aux_c = lm.forward_train(cpu, toks, cfg)
        h_g, aux_g = lm.forward_train(card, toks.to(cuda), cfg)
        _lm_close(h_g, h_c, msg="hidden")
        _lm_close(lm.lm_loss(card, h_g, labels.to(cuda), cfg), lm.lm_loss(cpu, h_c, labels, cfg))
        _lm_close(aux_g, aux_c)
    (_, _), g_c = lm.value_and_grad(cpu, toks, labels, cfg)
    (_, _), g_g = lm.value_and_grad(card, toks.to(cuda), labels.to(cuda), cfg)
    for (n, a), (_, b) in zip(named_leaves(g_g), named_leaves(g_c)):
        _lm_close(a, b, rtol=0, atol=1e-4 * float(b.abs().max()) + 1e-7, msg=n)
    step = lm.make_train_step(cfg)
    batch = {"tokens": toks, "labels": labels}
    p_c, _, m_c = step(cpu, adam_init(cpu), batch)
    p_g, _, m_g = step(card, adam_init(card), {k: v.to(cuda) for k, v in batch.items()})
    _lm_close(m_g["loss"], m_c["loss"])
    _lm_close(m_g["grad_norm"], m_c["grad_norm"])
    for (n, a), (_, b) in zip(named_leaves(p_g), named_leaves(p_c)):
        _lm_close(a, b, rtol=0, atol=2e-3, msg=n)
    with torch.no_grad():
        lg_c, c_c = lm.prefill(cpu, toks[:, :16], cfg, 24)
        lg_g, c_g = lm.prefill(card, toks[:, :16].to(cuda), cfg, 24)
        _lm_close(lg_g, lg_c, msg="prefill")
        tok = toks[:, 16:17]
        dstep = lm.make_decode_step(cfg)
        for s in range(3):
            nxt_c, lg_c, c_c = dstep(cpu, tok, c_c, 17 + s)
            nxt_g, lg_g, c_g = dstep(card, tok.to(cuda), c_g, 17 + s)
            _lm_close(lg_g, lg_c, msg=f"decode {s}")
            tok = nxt_c
        for (n, a), (_, b) in zip(named_leaves(c_g), named_leaves(c_c)):
            _lm_close(a, b, msg=n)


@pytest.mark.gpu
def test_full_width_layer_on_card_matches_cpu(cuda):
    """One gemma-7b layer at full width in fp32 (d 3,072, 16 heads of 256,
    d_ff 24,576) on the card against the CPU path, 1 x 256 tokens: within
    1e-4 x max |y| (fp32 sums of 3,072 and 24,576 terms in other orders)."""
    from repro_torch.common.pytree import tree_map
    from repro_torch.configs.gemma_7b import CONFIG
    from repro_torch.models import lm

    cfg = CONFIG.replace(param_dtype="float32", compute_dtype="float32", n_layers=1)
    spec = lm.layer_stacks(cfg)[0][1][0]
    gen = torch.Generator().manual_seed(0)
    layer = lm._init_layer(gen, cfg, spec, "cpu")
    layer["ln1"]["scale"] = 1 + 0.1 * torch.randn(cfg.d_model, generator=gen)
    x = torch.randn((1, 256, cfg.d_model), generator=gen)
    pos = torch.arange(256)[None]
    with torch.no_grad():
        y_cpu, _ = lm._layer_train(cfg, spec, layer, x, pos)
        y, _ = lm._layer_train(cfg, spec, tree_map(lambda t: t.to(cuda), layer), x.to(cuda),
                               pos.to(cuda))
    err, scale = float((y.cpu() - y_cpu).abs().max()), float(y_cpu.abs().max())
    assert err <= 1e-4 * scale, (err, scale)


@pytest.mark.gpu
def test_moe_dense_on_card_full_expert_count(cuda):
    """``moe_apply_dense`` at deepseek's expert count and top-k (256 experts
    of 64, top-8, one shared) with tied router scores on the card against
    the CPU: the same experts picked (lowest index first), outputs within
    1e-5 x max |y|."""
    from repro_torch.common.pytree import tree_map
    from repro_torch.nn import moe

    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe(gen, 256, 128, 64, n_shared=1, device="cpu")
    p["router"][:, 128:] = p["router"][:, :128]                    # every score twice
    x = torch.randn((3, 5, 128), generator=gen)
    y_c, aux_c = moe.moe_apply_dense(p, x, n_experts=256, top_k=8)
    y_g, aux_g = moe.moe_apply_dense(tree_map(lambda t: t.to(cuda), p), x.to(cuda),
                                     n_experts=256, top_k=8)
    _, eid_c, _ = moe._route(x.reshape(-1, 128), p["router"], 256, 8)
    _, eid_g, _ = moe._route(x.reshape(-1, 128).to(cuda), p["router"].to(cuda), 256, 8)
    assert torch.equal(eid_g.cpu(), eid_c)
    # the picks come in tied pairs (e, e + 128), the lower index first
    assert bool((eid_c[:, 0::2] < 128).all()) and torch.equal(eid_c[:, 1::2], eid_c[:, 0::2] + 128)
    err = float((y_g.cpu() - y_c).abs().max())
    assert err <= 1e-5 * float(y_c.abs().max()), err
    _lm_close(aux_g, aux_c, rtol=1e-5)


# --------------------------------------------------------------------------
# the training path (recsys, gnn, loader, checkpoint, trainer): the card
# against the CPU path
# --------------------------------------------------------------------------

TRAIN_ARCHS = ["deepfm", "xdeepfm", "bst", "two-tower-retrieval", "meshgraphnet"]


def _train_batch(arch, cfg, device):
    if arch == "meshgraphnet":
        g = synthetic.make_mesh_graph(120, d_feat=cfg.d_node_in, d_edge=cfg.d_edge_in,
                                      d_out=cfg.d_out)
        b = {k: getattr(g, k) for k in ("node_feat", "edge_feat", "senders", "receivers",
                                        "labels")}
    else:
        d = synthetic.make_clicks(32, max(cfg.n_fields, 1), np.array(cfg.vocab_sizes or [10]),
                                  hist_len=cfg.seq_len, n_items=cfg.n_items)
        keys = {"bst": ("history", "target_item", "labels"),
                "two_tower": ("ids", "target_item", "labels")}.get(cfg.model, ("ids", "labels"))
        b = {("item" if k == "target_item" and cfg.model == "two_tower" else k):
             (d[k][:, :cfg.n_fields] if k == "ids" else d[k]) for k in keys}
    return {k: torch.as_tensor(v).to(device) for k, v in b.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_smoke_train_step_on_card_matches_cpu(cuda, arch):
    """Each SMOKE recsys arch and meshgraphnet (fp32): three train steps on
    the card against the same steps on the CPU.  Tolerances: loss and grad
    norm rtol 1e-5 / 1e-4 (fp32 on both, TF32 off; the dense embedding
    gradient adds duplicate ids in another order on the card); params within
    2 x lr (Adam moves a parameter by up to lr either way on a gradient at
    rounding level)."""
    from repro_torch.common.pytree import named_leaves, tree_map
    from repro_torch.configs import registry
    from repro_torch.models import gnn, recsys
    from repro_torch.optim.adam import adam_init

    cfg = registry.get_arch(arch).SMOKE
    mod = gnn if arch == "meshgraphnet" else recsys
    init = gnn.init_gnn if arch == "meshgraphnet" else recsys.init_recsys
    cpu = init(torch.Generator().manual_seed(0), cfg, device="cpu")
    card = tree_map(lambda t: t.to(cuda), cpu)
    b_cpu = _train_batch(arch, cfg, "cpu")
    b_card = {k: v.to(cuda) for k, v in b_cpu.items()}
    step = mod.make_train_step(cfg)
    o_c, o_g = adam_init(cpu), adam_init(card)
    for _ in range(3):
        cpu, o_c, m_c = step(cpu, o_c, b_cpu)
        card, o_g, m_g = step(card, o_g, b_card)
        _lm_close(m_g["loss"], m_c["loss"], rtol=1e-5, atol=0)
        _lm_close(m_g["grad_norm"], m_c["grad_norm"], rtol=1e-4, atol=0)
    for (n, a), (_, b) in zip(named_leaves(card), named_leaves(cpu)):
        _lm_close(a, b, rtol=0, atol=2e-3, msg=n)


@pytest.mark.gpu
def test_loader_copies_on_a_side_stream_before_the_step_reads(cuda):
    """The loader's batches arrive on the card, each read by the consumer's
    stream only after its copy's event: a kernel queued on the consumer's
    stream right after ``next`` sees the whole batch, batch after batch,
    while the producer thread copies the next ones."""
    from repro_torch.data.loader import ShardedLoader

    n, rows = 12, 1 << 20
    host = [np.full((rows,), i, np.float32) for i in range(n)]
    ld = ShardedLoader(iter(host), prefetch=3, device=cuda)
    assert ld._stream is not None and ld._stream != torch.cuda.current_stream()
    sums = []
    for b in ld:
        assert b.device.type == "cuda" and b.shape == (rows,)
        sums.append(b.sum())           # queued on the consumer's stream
    assert [float(s) for s in sums] == [float(i * rows) for i in range(n)]


@pytest.mark.gpu
def test_checkpoint_round_trip_on_card(cuda, tmp_path):
    """A TrainLoop on the card saves asynchronously; a second loop restores
    onto the card with bit-equal leaves and resumes at the saved step."""
    from repro_torch.common.pytree import named_leaves
    from repro_torch.configs import registry
    from repro_torch.models import recsys
    from repro_torch.optim.adam import adam_init
    from repro_torch.train import TrainerConfig, TrainLoop

    cfg = registry.get_arch("deepfm").SMOKE
    b = _train_batch("deepfm", cfg, cuda)
    tc = TrainerConfig(checkpoint_dir=str(tmp_path), total_steps=4, checkpoint_every=2,
                       log_every=0)
    mk = lambda seed: recsys.init_recsys(torch.Generator(device=cuda).manual_seed(seed),
                                         cfg, device=cuda)
    p = mk(0)
    loop = TrainLoop(tc, recsys.make_train_step(cfg), p, adam_init(p), logger=lambda s: None)
    assert loop.run([b] * 4)["final_step"] == 4
    p2 = mk(1)
    loop2 = TrainLoop(tc, recsys.make_train_step(cfg), p2, adam_init(p2),
                      logger=lambda s: None)
    assert loop2.try_restore() and loop2.step == 4
    for (n, a), (_, c) in zip(named_leaves((loop.params, loop.opt_state)),
                              named_leaves((loop2.params, loop2.opt_state))):
        assert c.device.type == "cuda" and a.dtype == c.dtype and torch.equal(a, c), n

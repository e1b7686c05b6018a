"""The port's non-learned build half (SQ8, k-means, IVF packing, paging)
and its IVF search, held against the JAX package on the same inputs.

Bit-identical where the arithmetic is the same op by op: SQ8 codes and
scales, list packing with the JAX assignment (or centroids) injected, the
paged store.  Where fp32 products are summed (assignment, scan scores) the
two frameworks may order the sums differently: ids must match except at
near-ties (relative score gap < 1e-5), which are counted.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.anns import ivf as jax_ivf
from repro.anns.quantization import sq8_quant as jax_sq8
from repro.core import pages as jax_pages

from repro_torch.anns import ivf, kmeans
from repro_torch.anns.quantization import sq8_dequant, sq8_quant
from repro_torch.core import pages


def T(x):
    return torch.as_tensor(np.array(x))


def _vectors(seed, m, d):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((6, d)) * 3
    return (centers[rng.integers(0, 6, m)] + rng.standard_normal((m, d))).astype(np.float32)


def test_sq8_quant_bit_identical():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((7, 5, 33)).astype(np.float32) * 4
    x[0, 0] = 0.0                                    # zero row: clamped scale
    x[1, 2, :] = np.round(x[1, 2, :])
    codes, scales = sq8_quant(T(x))
    jc, js = jax_sq8(jnp.asarray(x))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(js))
    assert codes.dtype == torch.int8 and float(scales[0, 0]) > 0
    assert torch.equal(sq8_dequant(codes, scales)[0, 0], torch.zeros(33))


@pytest.mark.parametrize("sq8", [False, True])
@pytest.mark.parametrize("m,d,nlist,cap_floor", [(200, 16, 16, 1), (37, 12, 8, 64)])
def test_pack_lists_bit_identical(sq8, m, d, nlist, cap_floor):
    v = _vectors(m + d, m, d)
    assign = np.random.default_rng(1).integers(0, nlist, m)
    assign[:3] = 0                                   # one list longer than others
    want = jax_ivf._pack_lists(jnp.asarray(v), assign, nlist, sq8=sq8,
                               cap_floor=cap_floor)
    got = ivf._pack_lists(T(v), T(assign), nlist, sq8=sq8, cap_floor=cap_floor)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("sq8", [False, True])
def test_build_ivf_with_jax_centroids_bit_identical(sq8):
    """No centring: with the JAX quantizer injected every list is identical."""
    v = _vectors(3, 300, 24)
    jidx = jax_ivf.build_ivf(jax.random.PRNGKey(0), jnp.asarray(v), 16, sq8=sq8,
                             kmeans_iters=3, center=False)
    got = ivf.build_ivf(T(v), 16, sq8=sq8, center=False,
                        centroids=T(jidx.centroids))
    for name in ("ids", "vecs", "scales", "counts", "centroids"):
        w = getattr(jidx, name)
        if w is None:
            assert getattr(got, name) is None
        else:
            np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(w))
    assert got.mean is None and got.capacity == jidx.capacity


def test_build_ivf_centred_matches_jax():
    """Centring sums the corpus in each framework's order: the mean agrees to
    fp32 rounding and the assignment (hence ids, counts) exactly; the codes
    may move by one step where a rounding boundary is crossed."""
    v = _vectors(4, 400, 32)
    jidx = jax_ivf.build_ivf(jax.random.PRNGKey(1), jnp.asarray(v), 16, sq8=True,
                             kmeans_iters=3)
    got = ivf.build_ivf(T(v), 16, sq8=True, centroids=T(jidx.centroids))
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(jidx.mean), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(jidx.ids))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(jidx.counts))
    dc = np.abs(got.vecs.numpy().astype(int) - np.asarray(jidx.vecs).astype(int))
    assert dc.max() <= 1 and (dc > 0).mean() < 1e-3
    np.testing.assert_allclose(got.scales.numpy(), np.asarray(jidx.scales), rtol=1e-6)


def test_assign_clusters_matches_jax():
    v = _vectors(5, 500, 20)
    c = _vectors(6, 24, 20)
    got = ivf.assign_clusters(T(v), T(c)).numpy()
    want = np.asarray(jax_ivf.assign_clusters(jnp.asarray(v), jnp.asarray(c)))
    diff = got != want
    if diff.any():          # near-ties only
        s = v[diff] @ c.T - 0.5 * (c * c).sum(1)
        a, b = s[np.arange(diff.sum()), got[diff]], s[np.arange(diff.sum()), want[diff]]
        assert np.all(np.abs(a - b) / np.maximum(np.abs(a), 1) < 1e-5)
    assert diff.sum() <= 2


def test_kmeans_properties():
    """One Lloyd step from the drawn rows equals the loop version: members'
    mean, and an empty cluster keeps its centroid (no drift).  Only 5
    distinct points for 8 clusters force coinciding initial centroids, so
    some clusters come out empty.  The returned assignment is
    assign_clusters on the returned centroids."""
    base = _vectors(7, 5, 8)
    x = T(base[np.random.default_rng(0).integers(0, 5, 60)])
    init = x[torch.randperm(60, generator=torch.Generator().manual_seed(3))[:8]]
    a0 = ivf.assign_clusters(x, init)
    want = torch.stack([x[a0 == j].mean(0) if (a0 == j).any() else init[j]
                        for j in range(8)])
    assert (torch.bincount(a0, minlength=8) == 0).any()
    cent, a = kmeans.kmeans(x, 8, iters=1, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(cent, want, rtol=1e-6, atol=1e-6)
    assert torch.equal(a, ivf.assign_clusters(x, cent))


@pytest.mark.parametrize("sq8", [False, True])
@pytest.mark.parametrize("B,nprobe,k", [(6, 4, 10), (1, 3, 5), (5, 16, 400)])
def test_search_ivf_matches_jax(sq8, B, nprobe, k):
    """Same index, same pooled queries: JAX's fused search ids (k > #valid
    candidates pads with (-inf, -1) in both)."""
    v = _vectors(8, 250, 24)
    jidx = jax_ivf.build_ivf(jax.random.PRNGKey(2), jnp.asarray(v), 16, sq8=sq8,
                             kmeans_iters=3)
    idx = ivf.IVFIndex(*(None if a is None else T(a) for a in jidx[:6]))
    q = np.random.default_rng(B).standard_normal((B, 24)).astype(np.float32)
    ws, wi = jax_ivf.search_ivf(jidx, jnp.asarray(q), nprobe, k, use_fused_gather=True)
    gs, gi = ivf.search_ivf(idx, T(q), nprobe, k)
    ws, wi = np.asarray(ws), np.asarray(wi)
    fin = np.isfinite(ws)
    np.testing.assert_array_equal(np.isfinite(gs.numpy()), fin)
    np.testing.assert_allclose(gs.numpy()[fin], ws[fin], rtol=1e-5, atol=1e-5)
    diff = gi.numpy() != wi
    gap = np.abs(gs.numpy()[fin] - ws[fin]) / np.maximum(np.abs(ws[fin]), 1.0)
    assert np.all(gap[diff[fin]] < 1e-5) and diff.sum() <= max(1, diff.size // 50)
    np.testing.assert_array_equal(gi.numpy() < 0, wi < 0)


@pytest.mark.parametrize("m", [1, 300, 10_000, 800_000])
def test_default_nlist_matches_jax(m):
    assert ivf.default_nlist(m) == jax_ivf.default_nlist(m)


def _docs(seed, m=23, T_=37, d=8):
    rng = np.random.default_rng(seed)
    tok = rng.standard_normal((m, T_, d)).astype(np.float32)
    mask = rng.random((m, T_)) > 0.4
    mask[3] = False                        # a doc with no tokens
    mask[4] = True                         # a doc filling every position
    W = rng.standard_normal((m, 12)).astype(np.float32)
    return W, tok, mask


def test_from_dense_bit_identical():
    W, tok, mask = _docs(0)
    jstore, jmoved = jax_pages.from_dense(W, tok, mask)
    store, moved = pages.from_dense(T(W), T(tok), T(mask))
    assert moved == jmoved
    for name in store._fields:
        got, want = getattr(store, name), getattr(jstore, name)
        if want is None:                   # the compressed tier's fields, unset on fp32
            assert got is None, name
            continue
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)


def test_chunked_fill_equals_from_dense():
    """allocate + write_docs a chunk at a time builds the from_dense store."""
    W, tok, mask = _docs(1, m=40)
    want, _ = pages.from_dense(T(W), T(tok), T(mask))
    ppd = pages.pages_needed(T(mask).sum(1))
    store = pages.allocate(40, int(ppd.sum()), int(ppd.max()), 8, 12, device="cpu")
    slot = page = 0
    for s in range(0, 40, 7):
        page += pages.write_docs(store, slot, page, T(W[s:s + 7]), T(tok[s:s + 7]),
                                 T(mask[s:s + 7]))
        slot += len(W[s:s + 7])
    for name in store._fields:
        a, b = getattr(store, name), getattr(want, name)
        assert (a is None and b is None) or torch.equal(a, b), name


def test_mask_dead_matches_jax():
    W, tok, mask = _docs(2)
    jstore, _ = jax_pages.from_dense(W, tok, mask)
    jstore, _, _ = jax_pages.delete_docs(jstore, [], [2, 5, 9])
    store, _ = pages.from_dense(T(W), T(tok), T(mask))
    store.alive[[2, 5, 9]] = False
    cand = np.random.default_rng(0).integers(-1, 23, (4, 9)).astype(np.int32)
    np.testing.assert_array_equal(pages.mask_dead(store, T(cand)).numpy(),
                                  np.asarray(jax_pages.mask_dead(jstore, jnp.asarray(cand))))

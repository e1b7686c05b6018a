"""The port's residual codec, compressed page store, residual IVF lists and
the plain versions of the residual kernels, held against the JAX package
on the same inputs (made with numpy from a seed).

Bit for bit where the arithmetic is the same op by op: packing, encoding
and decoding on the same tables, ``quantile_linear`` against
``jnp.quantile``, token pooling, the compressed pages and the residual
lists built with JAX's codec or centroids injected.  Where fp32 products
are summed (the scans and reranks) the frameworks order the sums
differently: scores to rtol 1e-5 / atol 1e-4, ids equal up to counted
near-ties (relative score gap < 1e-5).  The JAX Pallas kernels run in
interpret mode, as ``tests/test_gather_scan.py`` runs them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.anns import ivf as jax_ivf
from repro.anns import quantization as jq
from repro.core import pages as jax_pages
from repro.data import synthetic as jax_synthetic
from repro.kernels import gather_scan as jax_gs
from repro.kernels import query_fused as jax_qf
from repro.kernels import ref as jax_ref

from repro_torch.anns import ivf, quantization as q
from repro_torch.anns.base import pad_topk, stable_topk
from repro_torch.core import pages
from repro_torch.kernels import ref

RTOL, ATOL, TIE = 1e-5, 1e-4, 1e-5


def T(x):
    return torch.as_tensor(np.array(x))


def jax_codec(rng, n, d, bits, ncent=8):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x, jq.train_residual_codec(jax.random.PRNGKey(1), jnp.asarray(x), bits=bits,
                                      ncent=ncent, iters=3)


def port_codec(jc) -> q.ResidualCodec:
    return q.ResidualCodec(*(T(a) for a in jc))


def assert_same_ids(want_s, want_i, got_s, got_i):
    """Pads equal, scores within tolerance, differing ids only at near-ties;
    returns where the ids differ."""
    fin = np.isfinite(want_s)
    np.testing.assert_array_equal(np.isfinite(got_s), fin)
    np.testing.assert_allclose(got_s[fin], want_s[fin], rtol=RTOL, atol=ATOL)
    diff = got_i != want_i
    gap = np.zeros(want_s.shape)
    gap[fin] = np.abs(got_s[fin] - want_s[fin]) / np.maximum(np.abs(want_s[fin]), 1)
    assert np.all(gap[diff] < TIE), "an id differs without a near-tie"
    return diff


# --------------------------------------------------------------------------
# the codec
# --------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("d", [4, 16, 20, 128])
def test_pack_unpack_round_trip_and_layout(bits, d):
    rng = np.random.default_rng(d + bits)
    idx = rng.integers(0, 1 << bits, (3, 5, d))
    packed = q.pack_codes(T(idx), bits)
    assert packed.dtype == torch.uint8 and packed.shape == (3, 5, d * bits // 8)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jq.pack_codes(jnp.asarray(idx), bits)))
    np.testing.assert_array_equal(q.unpack_codes(packed, bits).numpy(), idx)
    # dim i * per + j at bit bits * j of byte i
    per, last = 8 // bits, packed.shape[-1] - 1
    byte = int(packed[0, 0, last])
    assert (byte >> bits) & ((1 << bits) - 1) == idx[0, 0, last * per + 1]


def test_codec_rejects_bad_widths():
    with pytest.raises(ValueError, match="2 or 4 bits"):
        q.pack_codes(torch.zeros(2, 8, dtype=torch.long), 3)
    with pytest.raises(ValueError, match="not divisible"):
        q.pack_codes(torch.zeros(2, 6, dtype=torch.long), 2)


@pytest.mark.parametrize("n", [1, 2, 3, 8, 33, 100, 1001])
@pytest.mark.parametrize("bits", [2, 4])
def test_quantile_linear_equals_jnp_quantile_bit_for_bit(n, bits):
    """Odd and even n, n = 1, repeated values and a constant column, both
    the cut and the value quantiles, 150 columns (three blocks of sorting)."""
    rng = np.random.default_rng(n * bits)
    x = (rng.standard_normal((n, 150)) * rng.choice([1e-3, 1.0, 1e3], 150)).astype(np.float32)
    x[:, 3] = 1.5
    x[: n // 2 + 1, 5] = x[0, 5]
    x[:, 7] = np.round(x[:, 7] * 4) / 4
    L = 1 << bits
    for qs in (np.arange(1, L, dtype=np.float32) / L, (np.arange(L, dtype=np.float32) + 0.5) / L):
        want = np.asarray(jnp.quantile(jnp.asarray(x), jnp.asarray(qs), axis=0))
        got = q.quantile_linear(T(x), T(qs)).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("bits", [2, 4])
def test_encode_decode_bit_identical(bits):
    rng = np.random.default_rng(bits)
    x, jc = jax_codec(rng, 400, 16, bits)
    c = port_codec(jc)
    assert (c.ncent, c.d, c.nlevels, c.bits, c.packed_width) == (8, 16, 1 << bits, bits, 16 * bits // 8)
    cid, packed = q.residual_encode(c, T(x))
    jcid, jpacked = jq.residual_encode(jc, jnp.asarray(x))
    np.testing.assert_array_equal(cid.numpy(), np.asarray(jcid))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    # against given centroid ids (the IVF's own-list coding)
    own = rng.integers(0, 8, 400).astype(np.int32)
    np.testing.assert_array_equal(q.residual_encode(c, T(x), T(own))[1].numpy(),
                                  np.asarray(jq.residual_encode(jc, jnp.asarray(x),
                                                                jnp.asarray(own))[1]))
    # decode: the host decoder and the Pallas kernels' one-hot decoder
    dec = q.residual_decode(c, cid.reshape(20, 20), packed.reshape(20, 20, -1))
    want = np.asarray(jq.residual_decode(jc, jcid, jpacked))
    np.testing.assert_array_equal(dec.reshape(400, 16).numpy(), want)
    onehot = jax_gs.residual_decode_onehot(jcid, jpacked, jc.centroids, jc.values, bits=bits)
    np.testing.assert_array_equal(dec.reshape(400, 16).numpy(), np.asarray(onehot))


@pytest.mark.parametrize("bits", [2, 4])
def test_codec_tables_equal_jax_on_its_residuals(bits):
    """With JAX's k-means centroids, the residual quantile tables equal the
    ones JAX trained (the draws differ between the frameworks, the rule
    does not); the port's own training gives the same kinds of tables."""
    rng = np.random.default_rng(10 + bits)
    x, jc = jax_codec(rng, 500, 16, bits)
    cid = q.residual_assign(port_codec(jc), T(x))
    r = T(x) - T(jc.centroids)[cid.long()]
    cuts, values = q.residual_quantiles(r, bits)
    np.testing.assert_array_equal(cuts.numpy(), np.asarray(jc.cuts))
    np.testing.assert_array_equal(values.numpy(), np.asarray(jc.values))
    own = q.train_residual_codec(torch.Generator().manual_seed(0), T(x), bits=bits, ncent=8,
                                 iters=3, sample=300)
    assert own.centroids.shape == (8, 16) and own.cuts.shape == (16, (1 << bits) - 1)
    assert bool((own.values[:, 1:] >= own.values[:, :-1]).all())


def test_pool_tokens_equals_jax():
    corpus = jax_synthetic.make_corpus(m=40, d=16, avg_tokens=10, max_tokens=14,
                                       n_centers=8, seed=3)
    for budget in (0, 4, 9, 14):
        want = jax_pages.pool_tokens(corpus.doc_tokens, corpus.doc_mask, budget)
        got = pages.pool_tokens(T(corpus.doc_tokens), corpus.doc_mask, budget)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))


# --------------------------------------------------------------------------
# the compressed store and the residual lists, JAX's tables injected
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus():
    return jax_synthetic.make_corpus(m=120, d=16, avg_tokens=9, max_tokens=20,
                                     n_centers=12, seed=2)


@pytest.mark.parametrize("bits", [2, 4])
def test_compressed_store_bit_identical(corpus, bits):
    """from_dense(codec=) and the chunked allocate / write_docs fill give
    JAX's pages; gather_docs decodes them as JAX does; token_bytes agree."""
    mask = corpus.doc_mask.copy()
    mask[5] = False                                  # a doc with no tokens
    tokens = corpus.doc_tokens * mask[..., None]
    flat = tokens[mask]
    jc = jq.train_residual_codec(jax.random.PRNGKey(0), jnp.asarray(flat), bits=bits,
                                 ncent=16, iters=3)
    W = np.random.default_rng(0).standard_normal((corpus.m, 24)).astype(np.float32)
    jst, jmoved = jax_pages.from_dense(W, tokens, mask, codec=jc)
    st, moved = pages.from_dense(T(W), T(tokens), T(mask), codec=port_codec(jc))
    assert st.residual and st.d == 16 and st.tok_pages.shape == (st.n_pages, 16, 0)
    assert moved == jmoved
    for name in ("tok_pages", "page_table", "n_tokens", "W", "alive", "n_docs",
                 "cent_pages", "code_pages"):
        np.testing.assert_array_equal(getattr(st, name).numpy(), np.asarray(getattr(jst, name)))
    assert pages.token_bytes(st) == jax_pages.token_bytes(jst)
    # the chunked fill
    ppd = pages.pages_needed(T(mask.sum(1)))
    chunked = pages.allocate(corpus.m, int(ppd.sum()), int(ppd.max()), 16, 24, device="cpu",
                             codec=port_codec(jc))
    slot = page = 0
    for s in range(0, corpus.m, 37):
        e = min(s + 37, corpus.m)
        page += pages.write_docs(chunked, slot, page, T(W[s:e]), T(tokens[s:e]), T(mask[s:e]))
        slot = e
    for a, b in zip(chunked[:8], st[:8]):
        assert torch.equal(a, b)
    ids = np.array([[0, 5, -1], [7, 119, 3]], np.int32)
    toks, tm = pages.gather_docs(st, T(ids))
    jtoks, jtm = jax_pages.gather_docs(jst, jnp.asarray(ids))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jtm))


@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("center", [False, True])
def test_residual_ivf_with_jax_centroids(bits, center):
    """JAX's quantizer injected: ids and counts identical; without centring
    the codes and rq tables too (with it, the two frameworks' corpus means
    differ in the last bits, so the codes differ at bucket edges only);
    decoding the lists gives JAX's ``_residual_unpack``."""
    rng = np.random.default_rng(bits)
    centers = rng.standard_normal((6, 24)) * 3
    v = (centers[rng.integers(0, 6, 300)] + rng.standard_normal((300, 24))).astype(np.float32)
    jidx = jax_ivf.build_ivf(jax.random.PRNGKey(0), jnp.asarray(v), 16, sq8=True,
                             residual_bits=bits, kmeans_iters=3, center=center)
    got = ivf.build_ivf(T(v), 16, sq8=True, residual_bits=bits, center=center,
                        centroids=T(jidx.centroids))
    assert got.residual and got.scales is None and got.vecs.dtype == torch.uint8
    for name in ("ids", "counts", "centroids"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(jidx, name)))
    if not center:
        for name in ("vecs", "rq_cuts", "rq_values"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(jidx, name)))
        np.testing.assert_array_equal(ivf._residual_unpack(got).numpy(),
                                      np.asarray(jax_ivf._residual_unpack(jidx)))
    else:
        np.testing.assert_allclose(got.rq_values.numpy(), np.asarray(jidx.rq_values),
                                   rtol=1e-5, atol=1e-5)
        differ = (got.vecs.numpy() != np.asarray(jidx.vecs)).mean()
        assert differ < 0.01, differ


@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("fused", [True, False])
def test_search_residual_ivf_matches_jax(bits, fused):
    rng = np.random.default_rng(20 + bits)
    v = rng.standard_normal((400, 32)).astype(np.float32)
    jidx = jax_ivf.build_ivf(jax.random.PRNGKey(0), jnp.asarray(v), 16, residual_bits=bits,
                             kmeans_iters=3, center=False)
    got = ivf.build_ivf(T(v), 16, residual_bits=bits, center=False,
                        centroids=T(jidx.centroids))
    qv = rng.standard_normal((7, 32)).astype(np.float32)
    ws, wi = jax_ivf.search_ivf(jidx, jnp.asarray(qv), 4, 30, use_fused_gather=fused)
    gs, gi = ivf.search_ivf(got, T(qv), 4, 30, use_fused_gather=fused)
    assert_same_ids(np.asarray(ws), np.asarray(wi), gs.numpy(), gi.numpy())


# --------------------------------------------------------------------------
# the plain versions of the three kernels against JAX's Pallas kernels
# --------------------------------------------------------------------------

def _tables(rng, ncent, d, bits):
    return (rng.standard_normal((ncent, d)).astype(np.float32),
            np.sort(rng.standard_normal((d, 1 << bits)), axis=1).astype(np.float32))


@pytest.mark.parametrize("B,nlist,cap,d,nprobe", [(4, 8, 5, 16, 3), (1, 16, 9, 8, 8)])
@pytest.mark.parametrize("bits", [2, 4])
def test_ivf_scan_res_ref_vs_jax_interpret(B, nlist, cap, d, nprobe, bits):
    rng = np.random.default_rng(B * nlist + bits)
    ids = rng.integers(-1, 99, (nlist, cap)).astype(np.int32)
    ids[0] = -1
    codes = rng.integers(0, 256, (nlist, cap, d * bits // 8)).astype(np.uint8)
    cent, values = _tables(rng, nlist, d, bits)
    qv = rng.standard_normal((B, d)).astype(np.float32)
    probe = rng.integers(0, nlist, (B, nprobe)).astype(np.int32)
    args = (qv, probe, ids, codes, cent, values)
    got = ref.ivf_scan_res_ref(*(T(a) for a in args)).numpy()
    jargs = [jnp.asarray(a) for a in args]
    want = np.asarray(jax_gs.ivf_probe_res_scan(*jargs, interpret=True))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(jax_ref.ivf_scan_res_ref(*jargs)),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("B,C,Tq,d,kp", [(3, 12, 4, 16, 5), (1, 8, 3, 8, 6)])
@pytest.mark.parametrize("bits", [2, 4])
def test_rerank_paged_res_ref_vs_jax_interpret(B, C, Tq, d, kp, bits):
    """-1 candidates, short docs and a doc with no tokens; k' > the docs."""
    rng = np.random.default_rng(B * C + bits)
    page, pmax = 4, 2
    P = C * pmax
    cent_pages = rng.integers(0, 10, (P, page)).astype(np.int32)
    code_pages = rng.integers(0, 256, (P, page, d * bits // 8)).astype(np.uint8)
    cent, values = _tables(rng, 10, d, bits)
    table = rng.permutation(P).reshape(C, pmax).astype(np.int32)
    n_tokens = rng.integers(1, pmax * page + 1, C).astype(np.int32)
    n_tokens[2] = 0
    qv = rng.standard_normal((B, Tq, d)).astype(np.float32)
    qm = rng.random((B, Tq)) > 0.3
    qm[:, 0] = True
    cand = rng.integers(-1, C, (B, kp)).astype(np.int32)
    args = (qv, qm, cand, cent_pages, code_pages, table, n_tokens, cent, values)
    got = ref.rerank_scores_paged_res_ref(*(T(a) for a in args), chunk=2).numpy()
    jargs = [jnp.asarray(a) for a in args]
    want = np.asarray(jax_gs.rerank_paged_res_scores(*jargs, interpret=True))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(jax_ref.rerank_scores_paged_res_ref(*jargs)),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("B,nlist,cap,kp", [(2, 6, 7, 9), (1, 5, 12, 80)])
@pytest.mark.parametrize("bits", [2, 4])
def test_query_fused_res_ref_vs_jax_interpret(B, nlist, cap, kp, bits):
    """Pads, an empty list, duplicated rows (exact ties, the lower flat
    position first) and kp above the whole strip (padded (-inf, -1))."""
    rng = np.random.default_rng(B * cap + bits)
    d, dp, Tq, nprobe = 16, 64, 5, 3
    w = ((rng.standard_normal((d, dp)) * 0.1).astype(np.float32),
         (rng.standard_normal(dp) * 0.01).astype(np.float32),
         (1 + 0.1 * rng.standard_normal(dp)).astype(np.float32),
         (0.1 * rng.standard_normal(dp)).astype(np.float32))
    qt = rng.standard_normal((B, Tq, d)).astype(np.float32)
    qm = rng.random((B, Tq)) > 0.3
    qm[:, 0] = True
    ids = rng.permutation(1000)[:nlist * cap].reshape(nlist, cap).astype(np.int32)
    ids[:, cap - 2:] = -1
    ids[1] = -1
    codes = rng.integers(0, 256, (nlist, cap, dp * bits // 8)).astype(np.uint8)
    codes[0, 3] = codes[0, 0]
    cent, values = _tables(rng, nlist, dp, bits)
    probe = np.stack([rng.permutation(nlist)[:nprobe] for _ in range(B)]).astype(np.int32)
    probe[:, 0] = 0
    probe[0, 1] = 1
    args = (qt, qm, *w, probe, ids, codes, cent, values)
    gs, gi = ref.query_fused_res_ref(*(T(a) for a in args), kp=kp)
    jargs = [jnp.asarray(a) for a in args]
    ws, wi = jax_qf.query_fused_res(*jargs, kp=kp, interpret=True)
    ws, wi = np.asarray(ws), np.asarray(wi)
    fin = np.isfinite(ws)
    assert (gi.numpy()[~fin] == -1).all() and (wi[~fin] == -1).all()
    diff = assert_same_ids(ws, wi, gs.numpy(), gi.numpy())
    ties = np.zeros_like(diff)
    eq = (ws[:, 1:] == ws[:, :-1]) & fin[:, 1:]
    ties[:, 1:] |= eq
    ties[:, :-1] |= eq
    assert ties.any() and not diff[ties].any(), "an exact tie broke another way"
    jo_s, jo_i = jax_ref.query_fused_res_ref(*jargs, kp=kp)
    np.testing.assert_allclose(gs.numpy()[fin], np.asarray(jo_s)[fin], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("what", ["codec", "scan", "query_fused"])
@pytest.mark.parametrize("bits,dp", [(4, 2044), (2, 2040)])
def test_widths_off_whole_words_match_jax(bits, dp, what):
    """d' that pack_codes takes but whose packed rows are not whole 4-byte
    words (1,022 and 510 bytes): the port's codec bit for bit, its plain
    residual scan and one-launch first stage against JAX's oracles."""
    rng = np.random.default_rng(dp + bits)
    if what == "codec":
        x, jc = jax_codec(rng, 64, dp, bits)
        c = port_codec(jc)
        cid, packed = q.residual_encode(c, T(x))
        jcid, jpacked = jq.residual_encode(jc, jnp.asarray(x))
        assert packed.shape == (64, dp * bits // 8) and packed.shape[1] % 4
        np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
        np.testing.assert_array_equal(q.unpack_codes(packed, bits).numpy(),
                                      np.asarray(jq.unpack_codes(jpacked, bits)))
        np.testing.assert_array_equal(q.residual_decode(c, cid, packed).numpy(),
                                      np.asarray(jq.residual_decode(jc, jcid, jpacked)))
        return
    nlist, cap, B, nprobe = 5, 9, 3, 3
    ids = rng.integers(-1, 99, (nlist, cap)).astype(np.int32)
    ids[1] = -1
    codes = rng.integers(0, 256, (nlist, cap, dp * bits // 8)).astype(np.uint8)
    cent, values = _tables(rng, nlist, dp, bits)
    probe = np.stack([rng.permutation(nlist)[:nprobe] for _ in range(B)]).astype(np.int32)
    if what == "scan":
        qv = rng.standard_normal((B, dp)).astype(np.float32)
        args = (qv, probe, ids, codes, cent, values)
        got = ref.ivf_scan_res_ref(*(T(a) for a in args)).numpy()
        want = np.asarray(jax_ref.ivf_scan_res_ref(*[jnp.asarray(a) for a in args]))
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)
        return
    d, Tq = 16, 5
    w = ((rng.standard_normal((d, dp)) * 0.1).astype(np.float32),
         (rng.standard_normal(dp) * 0.01).astype(np.float32),
         (1 + 0.1 * rng.standard_normal(dp)).astype(np.float32),
         (0.1 * rng.standard_normal(dp)).astype(np.float32))
    qt = rng.standard_normal((B, Tq, d)).astype(np.float32)
    qm = rng.random((B, Tq)) > 0.3
    qm[:, 0] = True
    args = (qt, qm, *w, probe, ids, codes, cent, values)
    gs, gi = ref.query_fused_res_ref(*(T(a) for a in args), kp=20)
    ws, wi = jax_ref.query_fused_res_ref(*[jnp.asarray(a) for a in args], kp=20)
    assert_same_ids(np.asarray(ws), np.asarray(wi), gs.numpy(), gi.numpy())


# --------------------------------------------------------------------------
# the card's arithmetic, emulated (ref.res_scan_split, ref.tf32_split_rerank_res)
# --------------------------------------------------------------------------

#: the residual scans' card checks: max abs error <= RES_SCAN_RTOL x max(1,
#: max |exact|) (chip_smoke.py's RES_SCAN_RTOL)
RES_SCAN_RTOL = 1e-5


def _unit(rng, *shape):
    x = rng.standard_normal(shape)
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("dp,bits", [(2048, 4), (2048, 2), (2044, 4), (2040, 2)])
def test_res_scan_split_error(dp, bits):
    """The residual scans' scorer on the card (q . c of the list plus a
    table of q[k] values[k][l], never the decoded row), emulated by
    ref.res_scan_split: within RES_SCAN_RTOL of the fp64 dot with the host
    decoder's rows, and with JAX's ivf_probe_res_scan and query_fused_res
    (interpret mode), ids equal up to near-ties."""
    rng = np.random.default_rng(dp + bits)
    B, nlist, cap, nprobe, d, Tq = 2, 4, 8, 3, 16, 5
    ids = rng.permutation(1000)[:nlist * cap].reshape(nlist, cap).astype(np.int32)
    ids[:, cap - 3:] = -1
    ids[1] = -1
    codes = rng.integers(0, 256, (nlist, cap, dp * bits // 8)).astype(np.uint8)
    cent = _unit(rng, nlist, dp)
    values = np.sort(rng.standard_normal((dp, 1 << bits)) * 0.02, axis=1).astype(np.float32)
    probe = np.stack([rng.permutation(nlist)[:nprobe] for _ in range(B)]).astype(np.int32)
    probe[0, 0] = 1
    qv = _unit(rng, B, dp)
    args = (qv, probe, ids, codes, cent, values)
    got = ref.res_scan_split(*(T(a) for a in args)).numpy()
    rows = q.residual_decode(q.ResidualCodec(T(cent), None, T(values)),
                             T(probe)[..., None].expand(B, nprobe, cap), T(codes)[T(probe).long()])
    exact = np.einsum("bd,bpcd->bpc", qv.astype(np.float64), rows.double().numpy())
    fin = ids[probe] >= 0
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert np.abs(got[fin] - exact[fin]).max() <= RES_SCAN_RTOL * max(1.0, np.abs(exact[fin]).max())
    want = np.asarray(jax_gs.ivf_probe_res_scan(*[jnp.asarray(a) for a in args], interpret=True))
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)
    # the one-launch first stage: psi-pool, this scorer, the stable flat top-k'
    w = ((rng.standard_normal((d, dp)) * 0.1).astype(np.float32),
         (rng.standard_normal(dp) * 0.01).astype(np.float32),
         (1 + 0.1 * rng.standard_normal(dp)).astype(np.float32),
         (0.1 * rng.standard_normal(dp)).astype(np.float32))
    qt = rng.standard_normal((B, Tq, d)).astype(np.float32)
    qm = rng.random((B, Tq)) > 0.3
    qm[:, 0] = True
    kp = 12
    psi_q = ref.psi_pool_ref(T(qt), T(qm), *(T(a) for a in w))
    sc = ref.res_scan_split(psi_q, *(T(a) for a in args[1:])).reshape(B, -1)
    top, pos = stable_topk(sc, kp)
    gs, gi = pad_topk(top, torch.gather(T(ids)[T(probe).long()].reshape(B, -1), 1, pos), kp)
    qargs = [jnp.asarray(a) for a in (qt, qm, *w, probe, ids, codes, cent, values)]
    ws, wi = jax_qf.query_fused_res(*qargs, kp=kp, interpret=True)
    assert_same_ids(np.asarray(ws), np.asarray(wi), gs.numpy(), gi.numpy())


@pytest.mark.parametrize("d,Tq,bits,ncent", [(128, 32, 4, 256), (128, 32, 2, 64),
                                             (20, 32, 4, 16), (1024, 32, 4, 16)])
def test_rerank_res_split_error(d, Tq, bits, ncent):
    """The paged residual rerank's tensor-core arithmetic (a q . centroid
    table plus the 3xTF32 product of the residual part), emulated by
    ref.tf32_split_rerank_res: within ref.TF32_SPLIT_RTOL of the fp64 MaxSim
    over the host decoder's tokens, and with JAX's rerank_paged_res_scores
    (interpret mode); pads (-1, a doc without tokens) at Tq_valid x NEG."""
    rng = np.random.default_rng(d + Tq + bits + ncent)
    B, C, kp, pmax, page = 2, 10, 6, 3, 16
    P = C * pmax
    cent_pages = rng.integers(0, ncent, (P, page)).astype(np.int32)
    code_pages = rng.integers(0, 256, (P, page, d * bits // 8)).astype(np.uint8)
    cent = _unit(rng, ncent, d)
    values = np.sort(rng.standard_normal((d, 1 << bits)) * 0.05, axis=1).astype(np.float32)
    table = rng.permutation(P).reshape(C, pmax).astype(np.int32)
    n_tokens = rng.integers(1, pmax * page + 1, C).astype(np.int32)
    n_tokens[2] = 0
    table[np.arange(pmax)[None, :] >= (-(-n_tokens // page))[:, None]] = -1
    qv = _unit(rng, B, Tq, d)
    qm = rng.random((B, Tq)) > 0.3
    qm[:, 0] = True
    cand = rng.integers(-1, C, (B, kp)).astype(np.int32)
    cand[0, 4] = cand[0, 1] = 3
    args = (qv, qm, cand, cent_pages, code_pages, table, n_tokens, cent, values)
    got = ref.tf32_split_rerank_res(*(T(a) for a in args)).numpy()
    toks = q.residual_decode(q.ResidualCodec(T(cent), None, T(values)), T(cent_pages),
                             T(code_pages)).double().numpy()               # (P, page, d)
    exact = np.zeros((B, kp))
    for b in range(B):
        for i, c in enumerate(cand[b]):
            nt = n_tokens[c] if c >= 0 else 0
            pages = np.clip(table[c if c >= 0 else 0], 0, P - 1)
            tk = toks[pages].reshape(pmax * page, d)[:nt]
            best = (qv[b].astype(np.float64) @ tk.T).max(1) if nt else np.full(Tq, ref.NEG)
            exact[b, i] = best[qm[b]].sum()
    real = exact > ref.NEG / 2
    assert np.abs(got[real] - exact[real]).max() <= (
        ref.TF32_SPLIT_RTOL * max(1.0, np.abs(exact[real]).max()))
    np.testing.assert_allclose(got[~real], exact[~real], rtol=1e-6)
    want = np.asarray(jax_gs.rerank_paged_res_scores(*[jnp.asarray(a) for a in args],
                                                     interpret=True))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)

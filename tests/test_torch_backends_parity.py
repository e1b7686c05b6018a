"""The port's first-stage backends held to the JAX package, module by module.

The same numpy inputs go through the JAX function and the port's; the port
gets JAX's random parts (MUVERA's ``_partition_params``, DESSERT's planes,
token pruning's centroids), since ``jax.random`` streams cannot be replayed
by a ``torch.Generator``.

Tolerances, with their reasons:
* FDEs: rtol 1e-5 and atol 1e-5 x the largest |FDE|: fp32 products and sums
  of up to R 2^k d' terms in other orders.
* DESSERT occupancy: exact, except flips of tokens whose dot with a plane
  is within 1e-5 ||token|| ||plane|| of 0 (the sign of a rounding), counted.
* Token pruning: the sample, the lists and the counts bit for bit given the
  same assignment (checked first).
* Searches and adds: scores rtol 1e-5 / atol 1e-5 (fp32 sums in other
  orders); ids equal but at counted near-ties (relative gap < 1e-5), as the
  repo's other parity tests count them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.anns import dessert as jde
from repro.anns import muvera as jmu
from repro.anns import registry as jreg
from repro.anns import token_pruning as jtp
from repro.anns.base import CorpusView as JView
from repro.anns.base import QueryBatch as JQuery
from repro.anns.ivf import assign_clusters as j_assign

from repro_torch import convert
from repro_torch.anns import dessert, muvera, registry
from repro_torch.anns import kmeans as port_kmeans
from repro_torch.anns import token_pruning as tp
from repro_torch.anns.base import CorpusView, QueryBatch

RTOL, ATOL, TIE = 1e-5, 1e-5, 1e-5


def T(x):
    return torch.as_tensor(np.array(x))


def same_topk(s_ref, i_ref, s_got, i_got, *, max_ties=None):
    """Scores within tolerance; ids equal but at near-ties; returns the
    count of differing ids."""
    s_ref, i_ref = np.asarray(s_ref), np.asarray(i_ref)
    s_got, i_got = np.asarray(s_got), np.asarray(i_got)
    fin = np.isfinite(s_ref)
    assert np.array_equal(fin, np.isfinite(s_got))
    np.testing.assert_allclose(s_got[fin], s_ref[fin], rtol=RTOL, atol=ATOL)
    diff = i_got != i_ref
    ref = np.where(fin, s_ref, 0.0)
    gap = np.abs(np.where(fin, s_got, 0.0) - ref) / np.maximum(np.abs(ref), 1.0)
    assert np.all(gap[diff] < TIE), "an id differs without a near-tie"
    if max_ties is not None:
        assert diff.sum() <= max_ties, f"{diff.sum()} near-ties"
    return int(diff.sum())


@pytest.fixture(scope="module")
def data(tiny_corpus):
    rng = np.random.default_rng(3)
    toks = np.asarray(tiny_corpus.doc_tokens[:120], np.float32)
    mask = np.asarray(tiny_corpus.doc_mask[:120])
    extra_t = np.asarray(tiny_corpus.doc_tokens[120:150], np.float32)
    extra_m = np.asarray(tiny_corpus.doc_mask[120:150])
    q = rng.standard_normal((6, 5, toks.shape[-1])).astype(np.float32)
    qm = rng.random((6, 5)) < 0.8
    qm[:, 0] = True
    return toks, mask, extra_t, extra_m, q, qm


# --------------------------------------------------------------------------
# MUVERA
# --------------------------------------------------------------------------

@pytest.mark.parametrize("d_proj", [0, 8], ids=["identity", "projected"])
def test_fde_matches_jax(data, d_proj):
    toks, mask, _, _, q, qm = data
    cfg = jmu.MuveraConfig(r_reps=4, k_sim=3, d_proj=d_proj, final_dim=64, seed=7)
    hyper, proj, final = jmu._partition_params(cfg, toks.shape[-1])
    parts = muvera.MuveraParts(T(hyper), None if proj is None else T(proj), T(final))
    pcfg = muvera.MuveraConfig.from_dict(cfg.to_dict())
    assert torch.equal(muvera.bucket_ids(T(toks), parts.hyper),
                       T(jmu._bucket_ids(jnp.asarray(toks), hyper)).long())
    want = np.asarray(jmu.doc_fde(jnp.asarray(toks), jnp.asarray(mask), cfg))
    got = muvera.doc_fde(T(toks), T(mask), pcfg, parts, block=7).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    want_q = np.asarray(jmu.query_fde(jnp.asarray(q), jnp.asarray(qm), cfg))
    got_q = muvera.query_fde(T(q), T(qm), pcfg, parts).numpy()
    np.testing.assert_allclose(got_q, want_q, rtol=1e-5, atol=1e-5 * np.abs(want_q).max())


def test_partition_params_are_seeded():
    cfg = muvera.MuveraConfig(r_reps=3, k_sim=2, d_proj=4, final_dim=16, seed=5)
    a, b = muvera.partition_params(cfg, 8), muvera.partition_params(cfg, 8)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a.hyper.shape == (3, 2, 8) and a.proj.shape == (3, 8, 4)
    assert a.final.shape == (3 * 4 * 4, 16)
    assert set(a.final.abs().unique().tolist()) == {float(1 / torch.sqrt(torch.tensor(16.0)))}
    c = muvera.partition_params(cfg.replace(seed=6), 8)
    assert not torch.equal(a.hyper, c.hyper)


# --------------------------------------------------------------------------
# DESSERT
# --------------------------------------------------------------------------

def _dessert_pair(toks, mask, L=8, C=3):
    jcfg = jde.DessertConfig(n_tables=L, n_bits=C, seed=11)
    jidx = jde.build_dessert(jnp.asarray(toks), jnp.asarray(mask), jcfg)
    return jidx, dessert.DessertIndex(T(jidx.occupancy), T(jidx.hyper))


def test_dessert_occupancy_matches_jax(data):
    toks, mask, _, _, _, _ = data
    jidx, pidx = _dessert_pair(toks, mask)
    got = dessert.build_dessert(CorpusView(None, T(toks), T(mask)), dessert.DessertConfig(8, 3),
                                hyper=pidx.hyper).occupancy
    want = T(jidx.occupancy)
    flips = (got != want).any(-1).any(-1)                      # docs that differ
    hyp = np.asarray(jidx.hyper).reshape(-1, toks.shape[-1])
    dots = toks @ hyp.T
    scale = np.linalg.norm(toks, axis=-1)[..., None] * np.linalg.norm(hyp, axis=-1)
    near = ((np.abs(dots) < 1e-5 * scale) & mask[..., None]).any(-1).any(-1)
    assert not (flips.numpy() & ~near).any(), "an occupancy flip without a near-zero dot"
    assert int(flips.sum()) <= int(near.sum())


@pytest.mark.parametrize("chunk", [16384, 37], ids=["one_chunk", "chunked"])
def test_dessert_search_matches_jax(data, chunk):
    toks, mask, _, _, q, qm = data
    jidx, pidx = _dessert_pair(toks, mask)
    ws, wi = jde.search_dessert(jidx, jnp.asarray(q), jnp.asarray(qm), k_prime=50)
    gs, gi = dessert.search_dessert(pidx, T(q), T(qm), k_prime=50, chunk=chunk)
    same_topk(ws, wi, gs.numpy(), gi.numpy())
    ds, di = dessert.search_dessert_direct(pidx, T(q), T(qm), k_prime=50)
    same_topk(ds.numpy(), di.numpy(), gs.numpy(), gi.numpy())
    table = dessert.sim_table(8, 3, "cpu").numpy()
    rate = jnp.mean(jnp.asarray(np.arange(9)[:, None] > np.arange(8), jnp.float32), axis=1)
    want = jnp.cos(jnp.pi * (1.0 - jnp.power(jnp.clip(rate, 1e-6, 1.0), 1.0 / 3)))
    np.testing.assert_allclose(table, np.asarray(want), rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------
# token pruning
# --------------------------------------------------------------------------

def test_token_pruning_sample_matches_jax(data, monkeypatch):
    """JAX's draw (numpy, seed 0) over the flat valid tokens, gathered a
    chunk of docs at a time, in the draw's order."""
    toks, mask, _, _, _, _ = data
    monkeypatch.setattr(tp, "_BUILD_DOCS", 13)
    view = CorpusView(None, T(toks), T(mask))
    counts = [int(m.sum()) for _, _, m in view.chunks(13)]
    flat = toks[mask]
    n = flat.shape[0]
    ridx = np.random.default_rng(0).choice(n, 100, replace=False)
    assert np.array_equal(tp.sample_ids(n, 100), ridx) and tp.sample_ids(n, n) is None
    assert torch.equal(tp.training_sample(view, counts, 100), T(flat[ridx]))
    assert torch.equal(tp.training_sample(view, counts, n), T(flat))


def _tp_pair(toks, mask, nlist=32):
    jidx = jtp.build_token_pruning(jax.random.PRNGKey(0), jnp.asarray(toks),
                                   jnp.asarray(mask), nlist=nlist)
    return jidx, tp.TokenPruningIndex(T(jidx.centroids), T(jidx.doc_lists), T(jidx.counts))


def test_token_pruning_lists_match_jax(data, monkeypatch):
    toks, mask, extra_t, extra_m, _, _ = data
    monkeypatch.setattr(tp, "_BUILD_DOCS", 13)
    jidx, _ = _tp_pair(toks, mask)
    flat = toks[mask]
    want_a = np.asarray(j_assign(jnp.asarray(flat), jidx.centroids))
    got_a = port_kmeans.assign(T(flat), T(jidx.centroids)).numpy()
    assert np.array_equal(got_a, want_a), "the assignments differ: no list comparison"
    got = tp.build_token_pruning(CorpusView(None, T(toks), T(mask)), centroids=T(jidx.centroids))
    assert torch.equal(got.doc_lists, T(jidx.doc_lists))
    assert torch.equal(got.counts, T(jidx.counts))
    jext = jtp.extend_token_pruning(jidx, jnp.asarray(extra_t), jnp.asarray(extra_m), 120)
    ext = tp.extend_token_pruning(got, T(extra_t), T(extra_m), 120)
    assert torch.equal(ext.doc_lists, T(jext.doc_lists))
    assert torch.equal(ext.counts, T(jext.counts))
    assert torch.equal(got.doc_lists, T(jidx.doc_lists)), "extend wrote its input"


@pytest.mark.parametrize("nprobe", [1, 4, 64])      # 64 > nlist: clamped
def test_token_pruning_search_matches_jax(data, nprobe):
    toks, mask, _, _, q, qm = data
    jidx, pidx = _tp_pair(toks, mask)
    ws, wi = jtp.search_token_pruning(jidx, jnp.asarray(q), jnp.asarray(qm),
                                      nprobe=nprobe, k_prime=40, m=120)
    gs, gi = tp.search_token_pruning(pidx, T(q), T(qm), nprobe=nprobe, k_prime=40, m=120)
    same_topk(ws, wi, gs.numpy(), gi.numpy())
    ds, di = tp.search_token_pruning_direct(pidx, T(q), T(qm), nprobe=nprobe, k_prime=40,
                                            m=120)
    assert torch.equal(ds, gs) and torch.equal(di, gi)


# --------------------------------------------------------------------------
# the backend objects: search and add on JAX's state
# --------------------------------------------------------------------------

def port_state(name, jstate, d):
    """The port's state from a JAX state, through JAX's pack_state (MUVERA
    also takes the parts JAX regenerates from its seed)."""
    jbe = jreg.get_backend(name)
    arrays, meta = jbe.pack_state(jstate)
    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    if name == "muvera":
        hyper, proj, final = jmu._partition_params(jstate.mcfg, d)
        return convert.muvera_from_numpy(arrays["dfde"], jstate.mcfg, np.asarray(hyper),
                                         np.asarray(final), proj, device="cpu")
    return convert.ann_from_numpy(arrays, "cpu", backend=name, meta=meta)


@pytest.mark.parametrize("name", ["bruteforce", "ivf", "muvera", "dessert", "token_pruning"])
def test_backend_search_and_add_match_jax(data, name):
    toks, mask, extra_t, extra_m, q, qm = data
    rng = np.random.default_rng(5)
    W = rng.standard_normal((120, 32)).astype(np.float32)
    W2 = rng.standard_normal((30, 32)).astype(np.float32)
    ql = rng.standard_normal((6, 32)).astype(np.float32)
    jbe, be = jreg.get_backend(name), registry.get_backend(name)
    jstate = jbe.build(jax.random.PRNGKey(0), JView(jnp.asarray(W), jnp.asarray(toks),
                                                    jnp.asarray(mask)), None)
    state = port_state(name, jstate, toks.shape[-1])
    jq, pq = JQuery(jnp.asarray(ql), jnp.asarray(q), jnp.asarray(qm)), QueryBatch(T(ql), T(q), T(qm))
    for k in (20, 140):                                   # 140 > m: padded
        ws, wi = jbe.search(jstate, jq, k, jbe.default_params(None))
        gs, gi = be.search(state, pq, k, be.default_params(None))
        assert gi.dtype == torch.int32
        same_topk(ws, wi, gs.numpy(), gi.numpy())
    jstate = jbe.add(jstate, JView(jnp.asarray(W2), jnp.asarray(extra_t), jnp.asarray(extra_m)))
    state = be.add(state, CorpusView(T(W2), T(extra_t), T(extra_m)))
    jarr, jmeta = jbe.pack_state(jstate)
    arr, meta = be.pack_state(state)
    assert meta == jmeta
    for key, v in jarr.items():
        want = np.asarray(v)
        if want.dtype.kind == "f":
            np.testing.assert_allclose(arr[key].numpy(), want, rtol=RTOL,
                                       atol=ATOL * max(1.0, np.abs(want).max()))
        else:
            assert np.array_equal(arr[key].numpy(), want), key
    ws, wi = jbe.search(jstate, jq, 60, jbe.default_params(None))
    gs, gi = be.search(state, pq, 60, be.default_params(None))
    same_topk(ws, wi, gs.numpy(), gi.numpy())


def test_muvera_state_packs_its_parts(data):
    toks, mask, extra_t, extra_m, q, qm = data
    be = registry.get_backend("muvera")
    state = be.build(torch.Generator().manual_seed(0), CorpusView(None, T(toks), T(mask)),
                     None)
    arrays, meta = be.pack_state(state)
    assert set(arrays) == {"dfde", "hyper", "final"} and set(meta) == {"mcfg"}
    back = be.unpack_state(arrays, meta)
    assert all(torch.equal(a, b) for a, b in zip(back.parts, state.parts) if a is not None)
    with pytest.raises(ValueError, match="muvera_from_numpy"):
        be.unpack_state({"dfde": arrays["dfde"]}, meta)

"""The other first-stage backends through the port's facade, held to the JAX
package's: checkpoints both ways, ``with_backend``, mutation and
``install_refresh``, on one small JAX-built reduction (m = 300, d = 16).

* A JAX retriever re-pointed at ``bruteforce``, ``dessert`` or
  ``token_pruning`` (``with_backend``, after a few deletes) is saved; the
  port loads it and serves JAX's ids, and JAX loads the port's save of it
  and serves its own ids bit for bit.
* ``with_backend`` on both sides over one store, the port given JAX's random
  parts (MUVERA's planes and projections, DESSERT's planes, the token
  pruning and IVF centroids), serves JAX's ids.
* One add / delete / update sequence and an ``install_refresh`` of a JAX
  ``build_refresh`` result leave both serving the same ids.  The port's
  bruteforce state is a view of the store's W rows, where a deleted doc's
  row reads zero; JAX's state keeps the row, so its deleted docs can take
  candidate slots that the mask then empties.  Those comparisons hold the
  port to JAX's retriever with its bruteforce state re-pointed at its
  store's W rows, the port's rule.
* MUVERA: a port save round-trips bit for bit; a JAX MUVERA checkpoint (no
  projections) raises the ``ValueError`` naming both ways forward, and
  ``convert.muvera_from_numpy`` with JAX's ``_partition_params`` serves it.
* Each backend built by the port with its own draws holds recall against
  JAX's build of the same backend over the same reduction.

Scores rtol 1e-5 / atol 1e-4; ids equal but at counted near-ties (relative
gap < 1e-5), as tests/test_torch_mutation.py holds them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.anns import muvera as jmu
from repro.anns import registry as jreg
from repro.core import maxsim as jmaxsim
from repro.core.config import LemurConfig as JaxConfig
from repro.data import synthetic
from repro.lifecycle.refresh import build_refresh
from repro.retriever import LemurRetriever as JaxRetriever
from repro.retriever import SearchParams as JaxParams

from repro_torch import convert
from repro_torch.anns import registry
from repro_torch.retriever import LemurRetriever, SearchParams

RTOL, ATOL, TIE = 1e-5, 1e-4, 1e-5
DELETED = [3, 17, 42]
SAVED = ["bruteforce", "dessert", "token_pruning"]
# recall@10 the port's build of a backend may fall below JAX's build of it:
# the two draw different planes, projections and k-means starts, and on 16
# queries x 10 a recall step is 1/160
RECALL_SLACK = 0.1


def np_(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same_topk(s_ref, i_ref, s_got, i_got):
    """Scores within tolerance; differing ids only at counted near-ties."""
    s_ref, i_ref, s_got, i_got = map(np_, (s_ref, i_ref, s_got, i_got))
    assert s_got.shape == s_ref.shape
    np.testing.assert_allclose(s_got, s_ref, rtol=RTOL, atol=ATOL)
    diff = i_got != i_ref
    gap = np.abs(s_got - s_ref) / np.maximum(np.abs(s_ref), 1.0)
    assert np.all(gap[diff] < TIE), "an id differs without a near-tie"
    assert diff.sum() <= max(1, diff.size // 50), f"{diff.sum()} near-ties"


def corpus(m, seed):
    return synthetic.make_corpus(m=m, d=16, avg_tokens=8, max_tokens=12, n_centers=24,
                                 seed=seed)


def queries(c, n=10, seed=3):
    q = synthetic.queries_from_corpus_query(c, n, q_tokens=6, seed=seed).astype(np.float32)
    qm = np.random.default_rng(seed + 1).random(q.shape[:2]) > 0.25
    qm[:, 0] = True
    return q, qm


def search_both(jr, pr, q, qm, k=10):
    want = jr.search(jnp.asarray(q), jnp.asarray(qm), JaxParams(k=k))
    got = pr.search(q, qm, SearchParams(k=k))
    return (*want, *got)


def churn(r, new):
    """One add / delete / update sequence; returns the ids gone."""
    r.add(new.doc_tokens[:24], new.doc_mask[:24])
    added = np.asarray(r.last_added_ids)
    r.delete([5, int(added[2])])
    r.update([19, int(added[7])], new.doc_tokens[24:27], new.doc_mask[24:27])
    return [5, 19, int(added[2]), int(added[7])]


def reviewed(jr):
    """JAX's retriever with a bruteforce state re-pointed at its store's W
    rows (the port's rule; module docstring)."""
    if jr.backend == "bruteforce":
        jr._index = jr.index._replace(ann={"W": jr.index.W})
    return jr


def jax_parts(jr, name) -> dict:
    """The random parts of a JAX-built first stage, by the port's names."""
    ann = jr.index.ann
    if name == "muvera":
        hyper, proj, final = jmu._partition_params(ann.mcfg, jr.index.store.d)
        parts = {"hyper": hyper, "final": final}
    elif name == "dessert":
        parts = {"hyper": ann.hyper}
    elif name == "token_pruning":
        parts = {"centroids": ann.index.centroids}
    elif name == "ivf":
        parts = {"centroids": ann.centroids}
    else:
        parts = {}
    return {k: torch.as_tensor(np.array(v)) for k, v in parts.items()}


@pytest.fixture(scope="module")
def base(tiny_corpus, tmp_path_factory):
    cfg = JaxConfig(d=16, d_prime=64, m_pretrain=64, n_train=512, n_ols=256, epochs=2,
                    k=10, k_prime=48, anns="bruteforce")
    jr = JaxRetriever.build(tiny_corpus, cfg, key=jax.random.PRNGKey(0))
    jr.delete(DELETED)
    path = tmp_path_factory.mktemp("base")
    jr.save(path)
    return jr, path


@pytest.fixture(scope="module", params=SAVED)
def saved(request, base, tmp_path_factory):
    name = request.param
    jr = base[0].with_backend(name, key=jax.random.PRNGKey(1))
    path = tmp_path_factory.mktemp(f"saved_{name}")
    jr.save(path)
    return name, jr, path


def test_jax_save_serves_in_the_port(saved, tiny_corpus):
    name, jr, path = saved
    pr = LemurRetriever.load(path, device="cpu")
    assert pr.backend == name and pr.cfg.to_dict() == jr.cfg.to_dict()
    q, qm = queries(tiny_corpus)
    assert_same_topk(*search_both(jr, pr, q, qm))
    assert pr.launches() == jr.launches()
    got = set(pr.search(q, qm)[1].flatten().tolist())
    assert not got & set(DELETED)


def test_jax_loads_the_port_save(saved, tiny_corpus, tmp_path):
    name, jr, path = saved
    LemurRetriever.load(path, device="cpu").save(tmp_path)
    back = JaxRetriever.load(tmp_path)
    q, qm = queries(tiny_corpus)
    ws, wi = jr.search(jnp.asarray(q), jnp.asarray(qm))
    gs, gi = back.search(jnp.asarray(q), jnp.asarray(qm))
    assert np.array_equal(np.asarray(gi), np.asarray(wi))
    assert np.array_equal(np.asarray(gs), np.asarray(ws))


@pytest.mark.parametrize("name", ["bruteforce", "ivf", "muvera", "dessert", "token_pruning"])
def test_with_backend_given_jax_parts_serves_jax_ids(base, name, tiny_corpus):
    jr0, path = base
    jr = jr0.with_backend(name, key=jax.random.PRNGKey(2))
    pr = LemurRetriever.load(path, device="cpu").with_backend(name, parts=jax_parts(jr, name))
    assert pr.backend == name and pr.cfg.anns == name
    q, qm = queries(tiny_corpus)
    assert_same_topk(*search_both(jr, pr, q, qm))


def test_mutation_matches_jax(saved, tiny_corpus):
    name, _, path = saved
    jr, pr = JaxRetriever.load(path), LemurRetriever.load(path, device="cpu")
    new = corpus(30, 9)
    gone = churn(jr, new)
    assert churn(pr, new) == gone
    assert pr.m == jr.m and pr.version == jr.version
    jarr, jmeta = jreg.get_backend(name).pack_state(jr.index.ann)
    parr, pmeta = registry.get_backend(name).pack_state(pr.index.ann)
    assert pmeta == jmeta
    if name != "bruteforce":          # W rows: fit by two solvers, held below
        for k, v in jarr.items():
            assert np.array_equal(parr[k].numpy(), np.asarray(v)), k
    np.testing.assert_allclose(pr.index.W.numpy(), np.asarray(jr.index.W), rtol=1e-3,
                               atol=1e-3 * float(np.abs(np.asarray(jr.index.W)).max()))
    q, qm = queries(tiny_corpus)
    assert_same_topk(*search_both(reviewed(jr), pr, q, qm))
    assert not set(pr.search(q, qm)[1].flatten().tolist()) & set(gone + DELETED)


@pytest.mark.parametrize("name", ["bruteforce", "token_pruning"])
def test_install_refresh_matches_jax(base, name, tiny_corpus, tmp_path):
    """One latent and one token backend: a JAX refresh, installed after a
    churn in both (so slots [m0, m) are caught up through the backend's add)."""
    base[0].with_backend(name, key=jax.random.PRNGKey(1)).save(tmp_path)
    jr, pr = JaxRetriever.load(tmp_path), LemurRetriever.load(tmp_path, device="cpu")
    res = build_refresh(jr, seed=1)
    arrays, meta = jreg.get_backend(name).pack_state(res.ann)
    refresh = convert.refresh_from_numpy(
        name, res.m0, np.asarray(res.W), {k: np.asarray(v) for k, v in arrays.items()},
        {"chol": (np.asarray(res.solver["chol"][0]), res.solver["chol"][1]),
         "feats": np.asarray(res.solver["feats"]), "x_ols": np.asarray(res.solver["x_ols"])},
        device="cpu", ann_meta=meta)
    new = corpus(30, 19)
    churn(jr, new)
    churn(pr, new)
    jr.install_refresh(res)
    pr.install_refresh(refresh)
    assert pr.version == jr.version
    assert pr._last_refresh_caught_up == jr._last_refresh_caught_up
    if name == "token_pruning":
        ja, pa = jr.index.ann, pr.index.ann
        assert pa.m == ja.m
        assert np.array_equal(pa.index.doc_lists.numpy(), np.asarray(ja.index.doc_lists))
    q, qm = queries(tiny_corpus)
    assert_same_topk(*search_both(reviewed(jr), pr, q, qm))


def test_muvera_port_save_round_trips(base, tiny_corpus, tmp_path):
    pr = LemurRetriever.load(base[1], device="cpu").with_backend("muvera")
    pr.save(tmp_path)
    back = LemurRetriever.load(tmp_path, device="cpu")
    be = registry.get_backend("muvera")
    a, am = be.pack_state(pr.index.ann)
    b, bm = be.pack_state(back.index.ann)
    assert am == bm and set(a) == set(b) == {"dfde", "hyper", "final"}
    assert all(torch.equal(a[k], b[k]) for k in a)
    q, qm = queries(tiny_corpus)
    s0, i0 = pr.search(q, qm)
    s1, i1 = back.search(q, qm)
    assert torch.equal(i0, i1) and torch.equal(s0, s1)


def test_muvera_jax_checkpoint_is_refused(base, tiny_corpus, tmp_path):
    jr = base[0].with_backend("muvera", key=jax.random.PRNGKey(1))
    jr.save(tmp_path)
    with pytest.raises(ValueError, match=r"ann/hyper, ann/final.*with_backend\('muvera'\)"
                                         r".*muvera_from_numpy"):
        LemurRetriever.load(tmp_path, device="cpu")
    # what the message offers: the converter, given JAX's _partition_params
    pr = LemurRetriever.load(base[1], device="cpu")
    ann = jr.index.ann
    hyper, proj, final = jmu._partition_params(ann.mcfg, 16)
    state = convert.muvera_from_numpy(np.asarray(ann.dfde), ann.mcfg, np.asarray(hyper),
                                      np.asarray(final), proj, device="cpu")
    pr = LemurRetriever(pr.index._replace(cfg=pr.cfg.replace(anns="muvera"),
                                          backend="muvera", ann=state))
    q, qm = queries(tiny_corpus)
    assert_same_topk(*search_both(jr, pr, q, qm))


@pytest.mark.parametrize("name", ["bruteforce", "ivf", "muvera", "dessert", "token_pruning"])
def test_port_build_holds_recall_against_jax(base, name, tiny_corpus):
    """The port's own build of each backend (its draws) over one reduction,
    against JAX's build of it: recall@10 against exact MaxSim."""
    jr0, path = base
    jr = jr0.with_backend(name, key=jax.random.PRNGKey(3))
    pr = LemurRetriever.load(path, device="cpu").with_backend(
        name, generator=torch.Generator().manual_seed(3))
    q, qm = queries(tiny_corpus, n=16, seed=11)
    docs, dmask = jr0.index.dense_view()
    _, truth = jmaxsim.true_topk(jnp.asarray(q), jnp.asarray(qm), docs, dmask, 10)
    truth = np.asarray(truth)
    rec = lambda ids: float(np.mean([len(set(a) & set(b)) / 10  # noqa: E731
                                     for a, b in zip(np_(ids).tolist(), truth.tolist())]))
    want = rec(jr.search(jnp.asarray(q), jnp.asarray(qm))[1])
    got = rec(pr.search(q, qm)[1])
    assert got >= want - RECALL_SLACK, f"{name}: port recall {got:.3f} vs JAX {want:.3f}"

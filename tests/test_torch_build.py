"""The port's build held against the JAX build, stage by stage and whole.

Each stage gets the JAX stage's inputs, carried across as numpy: Adam and
the target standardization on the same tensors; five training steps from
JAX's ``init_phi`` params on the same batches; ``make_training_tokens`` on
the same corpus and seed; the Gram factor and the OLS output layer with
JAX's psi and OLS tokens.  The whole build is held at recall level: the
port's and JAX's builds over one synthetic corpus (m = 2,000, the paper
config's ``SMOKE`` widths) are each served and scored against exact MaxSim.

Tolerances, with their reasons:
* Adam: rtol 1e-6 / atol 1e-7 (the same fp32 formula; only libm rounding).
* Standardization: mean and std to rtol 1e-5 (fp32 reductions of 10^4
  values in different orders); ddof 0 in both.
* Training steps: params rtol 1e-4 / atol 1e-5, losses rtol 1e-5: the
  matmuls sum in other orders and Adam's sqrt(vhat) amplifies the gradient
  rounding of near-zero entries.
* train_phi: the last epoch loss within 10 % of JAX's (different init and
  permutations, same data and schedule).
* OLS W: 1e-3 x max|W| (targets agree to fp32 rounding; the Gram's
  condition number amplifies that in the solve).
* Whole build: the port's recall@10 at least JAX's minus 0.05 (the builds
  draw different random numbers; recall spreads about 0.01 over seeds).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.pytree import named_leaves
from repro.configs.lemur_paper import SMOKE
from repro.core import indexer as jax_indexer
from repro.core import model as jax_model
from repro.data import synthetic as jax_synthetic
from repro.optim import adam as jax_adam
from repro.retriever import LemurRetriever as JaxRetriever
from repro.retriever import SearchParams as JaxParams

from repro_torch.core import indexer, maxsim
from repro_torch.core.config import LemurConfig
from repro_torch.core.model import (PSI_LEAVES, Psi, TargetStats, _train_step, init_phi,
                                    standardize_targets, train_phi)
from repro_torch.data import synthetic
from repro_torch.optim.adam import adam_init, adam_update
from repro_torch.retriever import LemurRetriever, SearchParams


def T(x):
    return torch.as_tensor(np.array(x))


def port_cfg(jax_cfg) -> LemurConfig:
    return LemurConfig.from_dict(jax_cfg.to_dict())


def flat(tree) -> dict[str, np.ndarray]:
    return {n: np.array(x) for n, x in named_leaves(tree)}


def nested(leaves: dict) -> dict:
    out: dict = {}
    for name, x in leaves.items():
        node = out
        *head, last = name.split("/")
        for p in head:
            node = node.setdefault(p, {})
        node[last] = jnp.asarray(np.asarray(x))
    return out


@pytest.fixture(scope="module")
def corpus():
    return jax_synthetic.make_corpus(m=2000, d=32, avg_tokens=16, max_tokens=24,
                                     n_centers=64, seed=0)


# --------------------------------------------------------------------------
# optimizer, standardization, init
# --------------------------------------------------------------------------

@pytest.mark.parametrize("clip", [0.5, 1e6, None], ids=["clipped", "unclipped", "none"])
def test_adam_update_matches_jax(clip):
    rng = np.random.default_rng(0)
    shapes = {"out": (6, 5), "psi/dense/kernel": (4, 6), "psi/dense/bias": (6,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    jp, js = nested(params), jax_adam.adam_init(nested(params))
    tp = {k: T(v) for k, v in params.items()}
    ts = adam_init(tp)
    for _ in range(4):
        grads = {k: 3 * rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        jp, js, jm = jax_adam.adam_update(nested(grads), js, jp, lr=3e-3, grad_clip=clip)
        tp, ts, tm = adam_update({k: T(v) for k, v in grads.items()}, ts, tp, lr=3e-3,
                                 grad_clip=clip)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
    assert int(ts.step) == int(js.step) == 4
    want = flat(jp)
    for k, v in tp.items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-6, atol=1e-7, err_msg=k)
    for k, v in ts.nu.items():
        np.testing.assert_allclose(v.numpy(), flat(js.nu)[k], rtol=1e-6, atol=1e-12)


def test_standardize_targets_matches_jax():
    g = np.random.default_rng(1).gamma(2.0, 1.5, (200, 50)).astype(np.float32)
    jz, jstats = jax_model.standardize_targets(jnp.asarray(g))
    z, stats = standardize_targets(T(g))
    np.testing.assert_allclose(float(stats.mean), float(jstats.mean), rtol=1e-5)
    np.testing.assert_allclose(float(stats.std), float(jstats.std), rtol=1e-5)
    np.testing.assert_allclose(float(stats.std), g.std(ddof=0), rtol=1e-5)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-4, atol=1e-5)
    _, flat_stats = standardize_targets(torch.ones(4, 3))
    assert float(flat_stats.std) == pytest.approx(1e-6)


def test_init_phi_distribution():
    """The output layer is a normal truncated at +-2 times sqrt(1/d'): std
    0.8796 / sqrt(d'), no value beyond 2 / sqrt(d')."""
    d, dp, m_out = 32, 256, 512
    p = init_phi(d, dp, m_out, torch.Generator().manual_seed(0), device="cpu")
    assert set(p) == {*PSI_LEAVES, "out"} and p["out"].shape == (dp, m_out)
    out = p["out"] * dp ** 0.5
    assert float(out.std()) == pytest.approx(0.8796, abs=0.01)
    assert float(out.abs().max()) <= 2.0
    j = flat(jax_model.init_phi(jax.random.PRNGKey(0), d, dp, m_out))
    assert float(np.std(j["out"]) * dp ** 0.5) == pytest.approx(0.8796, abs=0.01)
    for k in PSI_LEAVES:
        assert p[k].shape == j[k].shape


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def _train_data(seed=2, n=1024, d=32, m_out=96):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    g = (x @ rng.standard_normal((d, m_out)).astype(np.float32)) ** 2
    return x, g.astype(np.float32)


def test_train_steps_match_jax():
    x, g = _train_data()
    cfg = SMOKE
    jparams = jax_model.init_phi(jax.random.PRNGKey(3), x.shape[1], cfg.d_prime, g.shape[1])
    jstate = jax_adam.adam_init(jparams)
    params = {k: T(v) for k, v in flat(jparams).items()}
    state = adam_init(params)
    rng = np.random.default_rng(4)
    for _ in range(5):
        idx = rng.choice(x.shape[0], cfg.batch_size, replace=False)
        jparams, jstate, jloss = jax_model._train_step(
            jparams, jstate, jnp.asarray(x[idx]), jnp.asarray(g[idx]), cfg.lr, cfg.grad_clip)
        params, state, loss = _train_step(params, state, T(x[idx]), T(g[idx]),
                                          cfg.lr, cfg.grad_clip)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = flat(jparams)
    for k, v in params.items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-4, atol=1e-5, err_msg=k)


def test_train_phi_lowers_the_loss_like_jax():
    x, g = _train_data(seed=5)
    cfg = SMOKE.replace(epochs=8)
    _, jstats, jlosses = jax_model.train_phi(jax.random.PRNGKey(0), jnp.asarray(x),
                                             jnp.asarray(g), cfg)
    params, stats, losses = train_phi(T(x), T(g), port_cfg(cfg),
                                      generator=torch.Generator().manual_seed(0))
    assert len(losses) == 8 and losses[-1] < losses[0]
    assert abs(losses[-1] - jlosses[-1]) <= 0.1 * jlosses[-1], (losses, jlosses)
    np.testing.assert_allclose(float(stats.std), float(jstats.std), rtol=1e-5)
    assert params["out"].shape == (cfg.d_prime, g.shape[1])


def test_train_phi_from_an_injected_init_is_deterministic():
    x, g = _train_data(seed=6, n=600)
    cfg = port_cfg(SMOKE.replace(epochs=2))
    init = flat(jax_model.init_phi(jax.random.PRNGKey(1), 32, cfg.d_prime, g.shape[1]))
    a = train_phi(T(x), T(g), cfg, generator=torch.Generator().manual_seed(9), init=init)
    b = train_phi(T(x), T(g), cfg, generator=torch.Generator().manual_seed(9), init=init)
    assert a[2] == b[2] and all(torch.equal(a[0][k], b[0][k]) for k in a[0])


# --------------------------------------------------------------------------
# indexer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", ["corpus-query", "corpus", "query"])
@pytest.mark.parametrize("arrays", ["numpy", "tensor"])
def test_make_training_tokens_equal_jax(corpus, strategy, arrays):
    cfg = SMOKE.replace(query_strategy=strategy, n_train=1000)
    want = jax_indexer.make_training_tokens(corpus, cfg, seed=3)
    src = corpus
    if arrays == "tensor":
        src = synthetic.MultiVectorCorpus(*(T(a) for a in (
            corpus.doc_tokens, corpus.doc_mask, corpus.topics, corpus.centers)))
    got = indexer.make_training_tokens(src, port_cfg(cfg), seed=3)
    assert got.dtype == np.float32 and got.shape == want.shape == (1000, 32)
    np.testing.assert_array_equal(got, want)


def test_make_corpus_equals_jax():
    a = jax_synthetic.make_corpus(m=50, d=8, avg_tokens=6, max_tokens=9, n_centers=5, seed=4)
    b = synthetic.make_corpus(m=50, d=8, avg_tokens=6, max_tokens=9, n_centers=5, seed=4)
    for f in ("doc_tokens", "doc_mask", "topics", "centers"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f))


@pytest.fixture(scope="module")
def jax_solver(corpus):
    """JAX's psi (an init draw) and OLS tokens, with JAX's W for them."""
    cfg = SMOKE
    psi = jax_model.init_psi(jax.random.PRNGKey(7), 32, cfg.d_prime)
    x = jax_indexer.make_training_tokens(corpus, cfg, seed=0)[:cfg.n_ols]
    docs, mask = jnp.asarray(corpus.doc_tokens[:300]), jnp.asarray(corpus.doc_mask[:300])
    stats = jax_model.TargetStats(jnp.float32(0.2), jnp.float32(0.3))
    state = jax_indexer.ols_solver_state(psi, jnp.asarray(x), cfg)
    W = jax_indexer.fit_output_layer_ols(psi, jnp.asarray(x), docs, mask, cfg, stats,
                                         doc_block=128, solver_state=state)
    return psi, x, stats, np.asarray(W), state


def test_ols_matches_jax(corpus, jax_solver):
    jpsi, x, jstats, jW, jstate = jax_solver
    p = flat(jpsi)
    psi = Psi.from_arrays(*(p[k.removeprefix("psi/")] for k in PSI_LEAVES), device="cpu")
    cfg = port_cfg(SMOKE)
    chol, feats = indexer.gram_factor(psi, T(x), cfg.ridge)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jstate["feats"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose((chol @ chol.T).numpy(),
                               np.asarray(jstate["chol"][0].T @ jstate["chol"][0]),
                               rtol=1e-4, atol=1e-3)
    stats = TargetStats(*(T(v) for v in jstats))
    docs, mask = T(corpus.doc_tokens[:300]), T(corpus.doc_mask[:300])
    tol = 1e-3 * np.abs(jW).max()
    W = indexer.fit_output_layer_ols(psi, T(x), docs, mask, cfg, stats, doc_block=128)
    np.testing.assert_allclose(W.numpy(), jW, rtol=0, atol=tol)
    state = indexer.ols_solver_state(psi, T(x), cfg)
    np.testing.assert_allclose(indexer.fit_docs(state, docs[40:90], mask[40:90], stats).numpy(),
                               jW[40:90], rtol=0, atol=tol)


# --------------------------------------------------------------------------
# the whole build
# --------------------------------------------------------------------------

def test_build_recall_matches_jax(corpus):
    """Both builds over one corpus, served with k = 10 and scored against
    exact MaxSim top-10 (recall@10 = top-10 overlap)."""
    jr = JaxRetriever.build(corpus, SMOKE, key=jax.random.PRNGKey(0))
    r = LemurRetriever.build(corpus, port_cfg(SMOKE), device="cpu",
                             generator=torch.Generator().manual_seed(0))
    q = synthetic.queries_from_corpus_query(corpus, 128, q_tokens=8, seed=7)
    qm = np.ones(q.shape[:2], bool)
    _, truth = maxsim.true_topk(T(q), T(qm), T(corpus.doc_tokens), T(corpus.doc_mask), 10)
    _, jids = jr.search(jnp.asarray(q), jnp.asarray(qm), JaxParams(k=10))
    _, ids = r.search(q, qm, SearchParams(k=10))
    jrec = float(maxsim.recall_at(T(jids), truth).mean())
    rec = float(maxsim.recall_at(ids, truth).mean())
    assert rec >= jrec - 0.05, (rec, jrec)
    assert rec > 5 * SMOKE.k_prime / corpus.m        # far above a blind first stage
    log = r.build_log
    assert set(log["seconds"]) == {"tokens", "g_pre", "train_phi", "gram", "ols", "ivf",
                                   "pages"}
    assert log["steps"] == SMOKE.epochs * (SMOKE.n_train // SMOKE.batch_size)
    assert len(log["losses"]) == SMOKE.epochs and log["losses"][-1] < log["losses"][0]
    assert r.m == corpus.m and r.x_ols.shape == (SMOKE.n_ols, 32)
    assert r.index.ann.nlist == 128 and r.index.ann.scales is not None
    np.testing.assert_allclose(r.index.store.W[:r.m].numpy(),
                               indexer.fit_docs(r.solver_state, T(corpus.doc_tokens),
                                                T(corpus.doc_mask), r.index.stats).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_build_refuses_what_is_not_ported(corpus):
    """What was refused before it was ported now builds what it names: the
    other first-stage backends (a MUVERA build serves its docs) and the
    residual tier's options (token codec, residual IVF lists, token
    pooling)."""
    small = synthetic.MultiVectorCorpus(corpus.doc_tokens[:50], corpus.doc_mask[:50],
                                        corpus.topics[:50], corpus.centers)
    cfg = port_cfg(SMOKE).replace(epochs=1)
    mv = LemurRetriever.build(small, cfg.replace(anns="muvera"), device="cpu")
    assert mv.backend == "muvera" and mv.index.ann.dfde.shape == (50, cfg.muvera.final_dim)
    _, ids = mv.search(small.doc_tokens[:4, :8], small.doc_mask[:4, :8], SearchParams(k=5))
    assert ((ids >= 0) & (ids < 50)).all()
    build = lambda c: LemurRetriever.build(small, c, device="cpu").index  # noqa: E731
    tier = cfg.residual.replace(enabled=True, ncent=32)
    assert build(cfg.replace(residual=tier)).store.codec.bits == 4
    assert build(cfg.replace(ivf=cfg.ivf.replace(residual_bits=4))).ann.residual
    index = build(cfg.replace(residual=cfg.residual.replace(token_budget=8)))
    assert not index.store.residual and int(index.store.n_tokens.max()) == 8

"""Checkpoints across the two packages, both directions.

* A port build, saved by the port, is loaded by the JAX package's
  ``LemurRetriever.load``; JAX's search returns the port's ids.
* A JAX build, saved by JAX, loaded and saved again by the port, gives the
  same leaves (names, shapes, dtypes, values) and a manifest whose ``cfg``
  JAX's ``LemurConfig.from_dict`` reads back to the build config.
* The port's own round trip is bit-identical, OLS tokens included, and the
  writer keeps the JAX crash order (staging directory, marker, rename).

Builds run on the CPU at the paper config's ``SMOKE`` widths.  Tolerance:
the frameworks sum the same fp32 products in different orders, so scores
agree to rtol 1e-5 / atol 1e-4; an id may differ only at a near-tie
(relative score gap < 1e-5), counted and rare.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.lemur_paper import SMOKE
from repro.core.config import LemurConfig as JaxConfig
from repro.data import synthetic as jax_synthetic
from repro.retriever import LemurRetriever as JaxRetriever
from repro.retriever import SearchParams as JaxParams

from repro_torch.checkpoint import manager
from repro_torch.core.config import LemurConfig
from repro_torch.data import synthetic
from repro_torch.retriever import LemurRetriever, SearchParams

RTOL, ATOL, TIE = 1e-5, 1e-4, 1e-5
CFG = SMOKE.replace(m_pretrain=128, n_train=1024, n_ols=256, k_prime=48)


@pytest.fixture(scope="module")
def corpus():
    return jax_synthetic.make_corpus(m=600, d=32, avg_tokens=12, max_tokens=20,
                                     n_centers=32, seed=1)


@pytest.fixture(scope="module")
def queries(corpus):
    q = synthetic.queries_from_corpus_query(corpus, 16, q_tokens=6, seed=5)
    qm = np.random.default_rng(6).random(q.shape[:2]) > 0.2
    qm[:, 0] = True
    return q, qm


@pytest.fixture(scope="module")
def port_saved(corpus, tmp_path_factory):
    r = LemurRetriever.build(corpus, LemurConfig.from_dict(CFG.to_dict()), device="cpu",
                             generator=torch.Generator().manual_seed(2))
    path = tmp_path_factory.mktemp("port_ckpt")
    r.save(path)
    return r, path


def _leaves(path):
    step = manager.latest_step(path)
    with np.load(path / f"step_{step:08d}" / "shard_00000.npz") as data:
        leaves = {k.replace("__", "/"): data[k] for k in data.files}
    return leaves, json.loads((path / f"step_{step:08d}" / "manifest.json").read_text())


def assert_same_ids(s_ref, i_ref, s_got, i_got):
    s_ref, i_ref, s_got, i_got = map(np.asarray, (s_ref, i_ref, s_got, i_got))
    np.testing.assert_allclose(s_got, s_ref, rtol=RTOL, atol=ATOL)
    diff = i_got != i_ref
    gap = np.abs(s_got - s_ref) / np.maximum(np.abs(s_ref), 1.0)
    assert np.all(gap[diff] < TIE), "an id differs without a near-tie"
    assert diff.sum() <= max(1, diff.size // 50), f"{diff.sum()} near-ties"


@pytest.mark.parametrize("k", [10, 60])     # 60 > k' = 48: padded rows
def test_port_save_serves_under_jax(port_saved, queries, k):
    r, path = port_saved
    q, qm = queries
    jr = JaxRetriever.load(path)
    assert jr.m == r.m and jr.cfg.to_dict() == CFG.to_dict()
    want_s, want_i = r.search(q, qm, SearchParams(k=k))
    got_s, got_i = jr.search(jnp.asarray(q), jnp.asarray(qm), JaxParams(k=k))
    assert_same_ids(want_s, want_i, got_s, got_i)
    np.testing.assert_array_equal(np.asarray(jr._x_ols), r.x_ols.numpy())


def test_port_round_trip_is_bit_identical(port_saved, queries, tmp_path):
    r, path = port_saved
    q, qm = queries
    back = LemurRetriever.load(path, device="cpu")
    assert torch.equal(back.x_ols, r.x_ols)
    back.save(tmp_path)
    a, ma = _leaves(path)
    b, mb = _leaves(tmp_path)
    assert ma["leaves"] == mb["leaves"] and ma["extra"] == mb["extra"]
    for name in a:
        np.testing.assert_array_equal(b[name], a[name], err_msg=name)
    s0, i0 = r.search(q, qm)
    s1, i1 = back.search(q, qm)
    assert torch.equal(i0, i1) and torch.equal(s0, s1)


def test_jax_checkpoint_round_trips_through_the_port(corpus, tmp_path):
    cfg = CFG.replace(ivf=CFG.ivf.replace(sq8=False))
    jr = JaxRetriever.build(corpus, cfg, key=jax.random.PRNGKey(4))
    jr.delete([5, 77])
    jr.save(tmp_path / "jax")
    LemurRetriever.load(tmp_path / "jax", device="cpu").save(tmp_path / "port")
    a, ma = _leaves(tmp_path / "jax")
    b, mb = _leaves(tmp_path / "port")
    assert sorted(a) == sorted(b) and "solver/x_ols" in b
    assert ma["leaves"] == mb["leaves"]
    for name in a:
        assert b[name].dtype == a[name].dtype, name
        np.testing.assert_array_equal(b[name], a[name], err_msg=name)
    assert JaxConfig.from_dict(mb["extra"]["cfg"]) == cfg
    assert {k: mb["extra"][k] for k in ("format", "backend", "ann_meta")} == {
        "format": "lemur-retriever-v1", "backend": "ivf", "ann_meta": {}}


def test_writer_keeps_the_crash_order(tmp_path):
    """A stale staging directory is replaced, an uncommitted step is never
    the latest, and a second save of a step replaces it whole."""
    leaves = {"a/b": np.arange(3, dtype=np.int32), "c": np.float32(2.5)}
    (tmp_path / "step_00000001.tmp").mkdir()
    (tmp_path / "step_00000001.tmp" / "junk").write_text("x")
    d = manager.save(tmp_path, 1, leaves, {"k": 1})
    assert sorted(p.name for p in d.iterdir()) == ["_COMMITTED", "manifest.json",
                                                   "shard_00000.npz"]
    assert not (tmp_path / "step_00000001.tmp").exists()
    (tmp_path / "step_00000002").mkdir()                 # a save cut before its marker
    assert manager.latest_step(tmp_path) == 1
    back, manifest = manager.restore(tmp_path)
    assert manifest["extra"] == {"k": 1} and manifest["leaves"]["c"]["shape"] == []
    np.testing.assert_array_equal(back["a/b"], leaves["a/b"])
    manager.save(tmp_path, 1, {"z": np.ones(2, np.float32)})
    assert list(manager.restore(tmp_path, 1)[0]) == ["z"]

"""The port's recsys models (``repro_torch/models/recsys.py``) held to the
JAX package's at SMOKE widths: JAX's ``init_recsys`` draw carried across by
``convert.params_from_numpy``, the same numpy click batches.

Tolerances (fp32; ``tests/_torch_lm_parity.py``'s): forwards rtol 1e-4 /
atol 1e-5, losses rtol 1e-5, gradients each leaf within 1e-4 x max |JAX
grad of that leaf| + 1e-7 (the dense embedding gradient adds duplicate ids'
rows in another order than JAX's scatter-add), one Adam step by
``_torch_model_parity.check_step``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_parity import close, one_torch_thread, to_np  # noqa: F401 (fixture)
from _torch_model_parity import T, check_grads, check_step, port_batch
from repro.common.pytree import named_leaves as jnamed
from repro.configs import registry as jregistry
from repro.data import synthetic as jsynthetic
from repro.models import gnn as jgnn
from repro.models import recsys as jrecsys
from repro.optim import adam as jadam

from repro_torch.common.pytree import named_leaves, value_and_grad
from repro_torch.configs import registry
from repro_torch.convert import adam_state_from_numpy, params_from_numpy
from repro_torch.models import gnn, recsys
from repro_torch.optim.adam import adam_init

RECSYS_ARCHS = ["deepfm", "xdeepfm", "bst", "two-tower-retrieval"]


# ---------------------------------------------------------------------------
# recsys
# ---------------------------------------------------------------------------

def recsys_setup(arch, seed=0, batch=32):
    jcfg = jregistry.get_arch(arch).SMOKE
    cfg = recsys.RecsysConfig.from_dict(jcfg.to_dict())
    assert cfg == registry.get_arch(arch).SMOKE
    jparams = jax.jit(jrecsys.init_recsys, static_argnums=1)(jax.random.PRNGKey(seed), jcfg)
    params = params_from_numpy(to_np(jparams), device="cpu", dtype=torch.float32)
    d = jsynthetic.make_clicks(batch, max(jcfg.n_fields, 1),
                               np.array(jcfg.vocab_sizes or [10]), seed=seed,
                               hist_len=jcfg.seq_len, n_items=jcfg.n_items)
    if jcfg.model == "bst":
        b = {"history": d["history"], "target_item": d["target_item"], "labels": d["labels"]}
    elif jcfg.model == "two_tower":
        b = {"ids": d["ids"][:, :jcfg.n_fields], "item": d["target_item"],
             "labels": d["labels"]}
    else:
        b = {"ids": d["ids"][:, :jcfg.n_fields], "labels": d["labels"]}
    return jcfg, cfg, jparams, params, b


def recsys_loss(mod, model):
    return mod.two_tower_loss if model == "two_tower" else mod.ctr_loss


@pytest.mark.parametrize("arch", RECSYS_ARCHS)
def test_recsys_forward_loss_grads_match_jax(arch):
    jcfg, cfg, jparams, params, b = recsys_setup(arch)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jit = lambda f, *a: jax.jit(lambda p: f(p, *a, jcfg))(jparams)
    if cfg.model == "bst":
        close(recsys.bst_forward(params, T(b["history"]), T(b["target_item"]), cfg),
              jit(jrecsys.bst_forward, jb["history"], jb["target_item"]))
    elif cfg.model == "two_tower":
        close(recsys.two_tower_user(params, T(b["ids"]), cfg),
              jit(jrecsys.two_tower_user, jb["ids"]))
        close(recsys.two_tower_item(params, T(b["item"]), cfg),
              jit(jrecsys.two_tower_item, jb["item"]))
    else:
        close(recsys.FORWARDS[cfg.model](params, T(b["ids"]), cfg),
              jit(jrecsys.FORWARDS[jcfg.model], jb["ids"]))
    jlf = recsys_loss(jrecsys, jcfg.model)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jlf(p, jb, jcfg)))(jparams)
    lf = recsys_loss(recsys, cfg.model)
    loss, grads = value_and_grad(lambda p: lf(p, port_batch(b), cfg), params)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    check_grads(grads, jg)


@pytest.mark.parametrize("arch", RECSYS_ARCHS)
def test_recsys_train_step_matches_jax(arch):
    jcfg, cfg, jparams, params, b = recsys_setup(arch, seed=1)
    jopt = jadam.adam_init(jparams)
    jp2, jo2, jm = jax.jit(jrecsys.make_train_step(jcfg))(
        jparams, jopt, {k: jnp.asarray(v) for k, v in b.items()})
    p2, o2, m = recsys.make_train_step(cfg)(params, adam_state_from_numpy(
        to_np(jopt), device="cpu"), port_batch(b))
    check_step(p2, o2, m, jp2, jo2, jm)


def test_two_tower_logq_matches_jax():
    jcfg, cfg, jparams, params, b = recsys_setup("two-tower-retrieval", seed=2)
    b["logq"] = np.log(np.random.default_rng(2).uniform(1e-4, 1e-2, len(b["labels"]))
                       ).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jl = jax.jit(lambda p: jrecsys.two_tower_loss(p, jb, jcfg))(jparams)
    np.testing.assert_allclose(float(recsys.two_tower_loss(params, port_batch(b), cfg)),
                               float(jl), rtol=1e-5)


def test_dense_embedding_gradient_moves_untouched_rows():
    """JAX's gradient of ``jnp.take`` is dense, so Adam moves a row on the
    second step that only the first step's batch touched (its first moment
    decays); the port's does the same, two steps held to JAX."""
    jcfg, cfg, jparams, params, b1 = recsys_setup("deepfm", seed=3, batch=8)
    b2 = dict(b1, ids=(b1["ids"] + 7) % 100)
    rows1 = set((b1["ids"] + jcfg.field_offsets[None, :jcfg.n_fields]).ravel().tolist())
    rows2 = set((b2["ids"] + jcfg.field_offsets[None, :jcfg.n_fields]).ravel().tolist())
    only1 = sorted(rows1 - rows2)
    assert only1
    jstep, step = jax.jit(jrecsys.make_train_step(jcfg)), recsys.make_train_step(cfg)
    jp, jo = jparams, jadam.adam_init(jparams)
    p, o = params, adam_state_from_numpy(to_np(jo), device="cpu")
    tables = []
    for b in (b1, b2):
        tables.append(p["table"]["embedding"])
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
        p, o, m = step(p, o, port_batch(b))
    check_step(p, o, m, jp, jo, jm)
    moved = (p["table"]["embedding"][only1] != tables[1][only1]).any(1)
    assert bool(moved.all())
    jmoved = np.asarray(jp["table"]["embedding"])[only1] != np.asarray(
        jax.jit(jrecsys.make_train_step(jcfg))(jparams, jadam.adam_init(jparams), {
            k: jnp.asarray(v) for k, v in b1.items()})[0]["table"]["embedding"])[only1]
    assert jmoved.any(1).all()


def test_embedding_bag_matches_manual():
    table = torch.as_tensor(np.random.default_rng(0).standard_normal((50, 8)), dtype=torch.float32)
    ids = torch.as_tensor([[1, 2, 0, 0], [3, 0, 0, 0]])  # 0 = pad
    out = recsys.embedding_bag(table, ids, combiner="mean")
    torch.testing.assert_close(out[0], (table[1] + table[2]) / 2, rtol=1e-5, atol=0)
    torch.testing.assert_close(out[1], table[3], rtol=1e-5, atol=0)
    for combiner in ("mean", "sum"):
        want = jrecsys.embedding_bag(jnp.asarray(table.numpy()), jnp.asarray(ids.numpy()),
                                     combiner=combiner)
        close(recsys.embedding_bag(table, ids, combiner=combiner), want)


@pytest.mark.parametrize("arch", RECSYS_ARCHS)
def test_serve_step_chunked_matches_unchunked_and_jax(arch):
    jcfg, cfg, jparams, params, b = recsys_setup(arch, seed=4)
    whole = recsys.make_serve_step(cfg)(params, port_batch(b))
    tiled = recsys.make_serve_step(cfg, chunk=8)(params, port_batch(b))
    torch.testing.assert_close(tiled, whole, rtol=1e-6, atol=1e-6)
    close(tiled, jrecsys.make_serve_step(jcfg, chunk=8)(
        jparams, {k: jnp.asarray(v) for k, v in b.items()}))


def test_cin_chunks_match_the_whole_product(monkeypatch):
    """xDeepFM's CIN a chunk of rows at a time (under checkpoint) gives the
    one-shot product's logits and gradients."""
    _, cfg, _, params, b = recsys_setup("xdeepfm", seed=5)
    lf = lambda p: recsys.ctr_loss(p, port_batch(b), cfg)
    loss, grads = value_and_grad(lf, params)
    monkeypatch.setattr(recsys, "CIN_CHUNK_ELEMS", 7 * 16 * 8 * 8)     # 7 rows a chunk
    loss_c, grads_c = value_and_grad(lf, params)
    np.testing.assert_allclose(float(loss_c), float(loss), rtol=1e-6)
    for (n, a), (_, c) in zip(named_leaves(grads), named_leaves(grads_c)):
        torch.testing.assert_close(c, a, rtol=1e-5, atol=1e-7, msg=n)


@pytest.mark.parametrize("arch", RECSYS_ARCHS + ["meshgraphnet"])
def test_init_in_law(arch):
    """init_recsys / init_gnn give JAX's tree (names, shapes, dtypes); each
    leaf's std within 4 / sqrt(n) of JAX's, relative (only the law can
    agree: torch.Generator against Threefry); a seed gives one draw."""
    jcfg = jregistry.get_arch(arch).SMOKE
    cfg = registry.get_arch(arch).SMOKE
    init, jinit = ((gnn.init_gnn, jgnn.init_gnn) if arch == "meshgraphnet"
                   else (recsys.init_recsys, jrecsys.init_recsys))
    port = named_leaves(init(torch.Generator().manual_seed(0), cfg, device="cpu"))
    ref = jnamed(jax.jit(jinit, static_argnums=1)(jax.random.PRNGKey(0), jcfg))
    assert [n for n, _ in port] == [n for n, _ in ref]
    for (n, a), (_, b) in zip(port, ref):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32, n
        if b.std() == 0:
            assert np.array_equal(a.numpy(), b), n
        else:
            assert abs(float(a.std()) / float(b.std()) - 1) < 4 / np.sqrt(b.size), n
    again = named_leaves(init(torch.Generator().manual_seed(0), cfg, device="cpu"))
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(port, again))


@pytest.mark.parametrize("arch", RECSYS_ARCHS)
def test_recsys_smoke_train_step(arch):
    """Twin of ``test_models_smoke.test_recsys_smoke_train_step``: five steps
    of the port's own init, the loss finite throughout."""
    _, cfg, _, _, b = recsys_setup(arch)
    p = recsys.init_recsys(torch.Generator().manual_seed(0), cfg, device="cpu")
    o = adam_init(p)
    step = recsys.make_train_step(cfg)
    for _ in range(5):
        p, o, m = step(p, o, port_batch(b))
        assert np.isfinite(float(m["loss"])), arch



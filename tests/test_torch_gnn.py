"""The port's GNN (``repro_torch/models/gnn.py``), the six configs and the
registry held to the JAX package's at SMOKE widths: JAX's ``init_gnn`` draw
carried across by ``convert.params_from_numpy``, the same numpy graphs.

Tolerances as ``tests/test_torch_recsys.py``'s; the sampler is held bit for
bit on JAX's uniforms, the configs field by field.
"""
from __future__ import annotations

import dataclasses

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
from repro.optim import adam as jadam

from repro_torch.common.pytree import value_and_grad
from repro_torch.configs import registry
from repro_torch.convert import adam_state_from_numpy, params_from_numpy
from repro_torch.data import synthetic
from repro_torch.models import gnn, recsys
from repro_torch.optim.adam import adam_init

CONFIG_MODULES = ["deepfm", "xdeepfm", "bst", "two_tower", "meshgraphnet", "lemur_paper"]


# ---------------------------------------------------------------------------
# gnn
# ---------------------------------------------------------------------------

def gnn_setup(jcfg, n=60, seed=0, isolate=False):
    cfg = gnn.GNNConfig.from_dict(jcfg.to_dict())
    g = jsynthetic.make_mesh_graph(n, d_feat=jcfg.d_node_in, d_edge=jcfg.d_edge_in,
                                   d_out=max(jcfg.d_out, 1), seed=seed)
    keep = g.receivers != n - 1 if isolate else np.ones(len(g.senders), bool)
    b = {"node_feat": g.node_feat, "edge_feat": g.edge_feat[keep],
         "senders": g.senders[keep], "receivers": g.receivers[keep],
         "labels": g.labels}
    rng = np.random.default_rng(seed)
    if jcfg.task == "classification":
        b["labels"] = rng.integers(0, jcfg.d_out, n).astype(np.int32)
        b["label_mask"] = (rng.random(n) < 0.5).astype(np.float32)
    if jcfg.graph_readout:
        b["graph_ids"] = np.repeat(np.arange(6, dtype=np.int32), n // 6)
        b["graph_labels"] = rng.standard_normal((6, jcfg.d_out)).astype(np.float32)
    jparams = jax.jit(jgnn.init_gnn, static_argnums=1)(jax.random.PRNGKey(seed), jcfg)
    params = params_from_numpy(to_np(jparams), device="cpu", dtype=torch.float32)
    return cfg, jparams, params, b


GNN_SMOKE = jregistry.get_arch("meshgraphnet").SMOKE
GNN_CASES = {
    "sum": GNN_SMOKE,
    "max": GNN_SMOKE.replace(aggregator="max"),
    "mean": GNN_SMOKE.replace(aggregator="mean"),
    "classification_masked": GNN_SMOKE.replace(task="classification", d_out=3),
    "molecule": GNN_SMOKE.replace(d_out=1, graph_readout=True),
}


@pytest.mark.parametrize("case", list(GNN_CASES))
def test_gnn_loss_and_grads_match_jax(case):
    jcfg = GNN_CASES[case]
    cfg, jparams, params, b = gnn_setup(jcfg)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    def jloss(p):
        out = jgnn.forward(p, jb["node_feat"], jb["edge_feat"], jb["senders"],
                           jb["receivers"], jcfg)
        return jgnn._loss_from_out(out, jb, jcfg), out

    (jl, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)
    close(gnn.forward(params, *(T(b[k]) for k in ("node_feat", "edge_feat", "senders",
                                                   "receivers")), cfg), jout)
    loss, grads = value_and_grad(lambda p: gnn.loss_fn(p, port_batch(b), cfg), params)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    check_grads(grads, jg)


def test_gnn_train_step_matches_jax():
    cfg, jparams, params, b = gnn_setup(GNN_SMOKE, seed=1)
    jopt = jadam.adam_init(jparams)
    jp2, jo2, jm = jax.jit(jgnn.make_train_step(GNN_SMOKE))(
        jparams, jopt, {k: jnp.asarray(v) for k, v in b.items()})
    p2, o2, m = gnn.make_train_step(cfg)(params, adam_state_from_numpy(to_np(jopt),
                                                                       device="cpu"),
                                         port_batch(b))
    check_step(p2, o2, m, jp2, jo2, jm)


def test_segment_max_leaves_an_isolated_node_at_minus_inf():
    """A node with no incoming edge: ``jax.ops.segment_max`` leaves it at
    -inf, and so does the port, so the max aggregator's forward carries the
    same non-finite rows as JAX's (its own and, through its messages, the
    nodes it sends to)."""
    jcfg = GNN_CASES["max"]
    cfg, jparams, params, b = gnn_setup(jcfg, isolate=True)
    msgs = np.random.default_rng(0).standard_normal((len(b["receivers"]), 5)).astype(
        np.float32)
    want = np.asarray(jax.ops.segment_max(jnp.asarray(msgs), jnp.asarray(b["receivers"]),
                                          num_segments=60))
    got = gnn.segment_max(T(msgs), T(b["receivers"]), 60).numpy()
    assert np.isneginf(got[59]).all() and np.isneginf(want[59]).all()
    np.testing.assert_array_equal(got, want)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    out = gnn.forward(params, *(T(b[k]) for k in ("node_feat", "edge_feat", "senders",
                                                   "receivers")), cfg).numpy()
    jout = np.asarray(jax.jit(lambda p: jgnn.forward(
        p, jb["node_feat"], jb["edge_feat"], jb["senders"], jb["receivers"], jcfg))(jparams))
    bad = ~np.isfinite(jout).all(1)        # node 59 and the nodes it sends to
    assert bad[59] and bad.sum() < 60
    np.testing.assert_array_equal(~np.isfinite(out).all(1), bad)
    np.testing.assert_allclose(out[~bad], jout[~bad], rtol=1e-4, atol=1e-5)
    for agg in ("sum", "mean"):        # the other aggregators leave it at 0
        c = cfg.replace(aggregator=agg)
        assert float(gnn._aggregate(c, T(msgs), T(b["receivers"]), 60)[59].abs().max()) == 0


def test_sampler_matches_jax_on_its_uniforms():
    g = jsynthetic.make_mesh_graph(80, seed=1)
    rp, ci = jnp.asarray(g.row_ptr), jnp.asarray(g.col_idx)
    nodes = np.concatenate([np.arange(20), [79, 0, 79]]).astype(np.int32)
    for fanout, key in ((5, 0), (15, 3)):
        k = jax.random.PRNGKey(key)
        want = jgnn.sample_neighbors(k, rp, ci, jnp.asarray(nodes), fanout)
        u = jax.random.uniform(k, (len(nodes), fanout))
        got = gnn.neighbors_from_uniforms(T(u), T(g.row_ptr), T(g.col_idx), T(nodes))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a zero-degree node self-loops; an index past the edges is clamped
    rp, ci = T([0, 2, 2, 3]), T([4, 5, 6])
    got = gnn.neighbors_from_uniforms(T([[0.0, 0.99, 0.5]] * 3), rp, ci, T([0, 1, 2]))
    assert got.tolist() == [[4, 5, 5], [1, 1, 1], [6, 6, 6]]


def test_gnn_sampler_respects_graph():
    """Twin of ``test_models_smoke.test_gnn_sampler_respects_graph`` for the
    port's own draw."""
    g = synthetic.make_mesh_graph(80, seed=1)
    nodes = torch.arange(20)
    nbrs = gnn.sample_neighbors(torch.Generator().manual_seed(0), T(g.row_ptr),
                                T(g.col_idx), nodes, 5)
    assert nbrs.shape == (20, 5)
    rp, ci = g.row_ptr, g.col_idx
    for i, v in enumerate(nodes.tolist()):
        allowed = set(ci[rp[v]:rp[v + 1]].tolist()) | {v}
        assert set(nbrs[i].tolist()) <= allowed


def sampled_setup(seed=2):
    jcfg = GNN_SMOKE.replace(task="classification", d_out=3)
    cfg = gnn.GNNConfig.from_dict(jcfg.to_dict())
    g = jsynthetic.make_mesh_graph(120, d_feat=jcfg.d_node_in, d_edge=jcfg.d_edge_in,
                                   d_out=2)
    b = {"row_ptr": g.row_ptr, "col_idx": g.col_idx, "node_feat": g.node_feat,
         "seeds": np.arange(8, dtype=np.int32),
         "labels": np.random.default_rng(seed).integers(0, 3, 8).astype(np.int32)}
    jparams = jax.jit(jgnn.init_gnn, static_argnums=1)(jax.random.PRNGKey(seed), jcfg)
    params = params_from_numpy(to_np(jparams), device="cpu", dtype=torch.float32)
    key = jax.random.PRNGKey(seed + 10)
    k1, k2 = jax.random.split(key)
    f1, f2 = jcfg.fanout
    u = (T(jax.random.uniform(k1, (8, f1))), T(jax.random.uniform(k2, (8, f1, f2))))
    return jcfg, cfg, jparams, params, b, key, u


def test_sampled_forward_and_step_match_jax():
    """``sampled_forward`` and its train step on JAX's uniforms (the two
    draws of ``jax.random.split(key)``) against JAX on ``key``."""
    jcfg, cfg, jparams, params, b, key, u = sampled_setup()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    close(gnn.sampled_forward(params, u, port_batch(b), cfg),
          jax.jit(lambda p: jgnn.sampled_forward(p, key, jb, jcfg))(jparams))
    jopt = jadam.adam_init(jparams)
    jp2, jo2, jm = jax.jit(jgnn.make_sampled_train_step(jcfg))(jparams, jopt, key, jb)
    p2, o2, m = gnn.make_sampled_train_step(cfg)(
        params, adam_state_from_numpy(to_np(jopt), device="cpu"), u, port_batch(b))
    check_step(p2, o2, m, jp2, jo2, jm)


def test_gnn_smoke_full_and_sampled():
    """Twin of ``test_models_smoke.test_gnn_smoke_full_and_sampled`` on the
    port's own init and draw."""
    cfg = registry.get_arch("meshgraphnet").SMOKE
    g = synthetic.make_mesh_graph(120, d_feat=cfg.d_node_in, d_edge=cfg.d_edge_in,
                                  d_out=cfg.d_out)
    params = gnn.init_gnn(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = {k: T(getattr(g, k)) for k in ("node_feat", "edge_feat", "senders",
                                           "receivers", "labels")}
    _, _, m = gnn.make_train_step(cfg)(params, adam_init(params), batch)
    assert np.isfinite(float(m["loss"]))
    scfg = cfg.replace(task="classification", d_out=3)
    sp = gnn.init_gnn(torch.Generator().manual_seed(0), scfg, device="cpu")
    sb = {"row_ptr": T(g.row_ptr), "col_idx": T(g.col_idx), "node_feat": T(g.node_feat),
          "seeds": torch.arange(8), "labels": torch.zeros(8, dtype=torch.int32)}
    _, _, sm = gnn.make_sampled_train_step(scfg)(sp, adam_init(sp),
                                                 torch.Generator().manual_seed(2), sb)
    assert np.isfinite(float(sm["loss"]))


# ---------------------------------------------------------------------------
# configs and the registry
# ---------------------------------------------------------------------------

def _plain(x):
    """Configs as dicts, the rest as it is, for a field-by-field comparison."""
    if dataclasses.is_dataclass(x):
        return {"__cls__": type(x).__name__, **x.to_dict()}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


@pytest.mark.parametrize("name", CONFIG_MODULES)
def test_config_matches_jax(name):
    import importlib

    jmod = importlib.import_module(f"repro.configs.{name}")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    assert mod.FAMILY == jmod.FAMILY
    for attr in ("CONFIG", "SMOKE"):
        assert _plain(getattr(mod, attr)) == _plain(getattr(jmod, attr)), attr
        assert type(getattr(mod, attr)).__module__.startswith("repro_torch.")
    assert _plain(mod.SHAPES) == _plain(jmod.SHAPES)
    if hasattr(jmod, "VOCABS"):
        assert mod.VOCABS == jmod.VOCABS and sum(mod.VOCABS) == 16_262_144


def test_all_archs_registered():
    """Twin of ``test_models_smoke.test_all_archs_registered``; the matrix of
    cells equals JAX's."""
    assert registry.list_archs() == jregistry.list_archs() and len(registry.ARCHS) == 11
    for arch in registry.ARCHS:
        mod = registry.get_arch(arch)
        assert mod.__name__.startswith("repro_torch.configs.")
        assert hasattr(mod, "CONFIG") and hasattr(mod, "SHAPES") and hasattr(mod, "SMOKE")
        assert len(mod.SHAPES) >= 2
    assert registry.all_cells() == jregistry.all_cells()
    with pytest.raises(KeyError):
        registry.get_arch("gpt-5")


def test_build_cell_raises_until_the_sharding_rules():
    """build_cell checks the arch and the shape as the JAX twin does, and
    now builds every cell of ``all_cells()`` (meta arguments, partition
    specs) on the single-pod layout."""
    from repro_torch.launch.cells import Cell

    with pytest.raises(KeyError):
        registry.build_cell("deepfm", "no_such_shape", None)
    for arch, shape in registry.all_cells():
        cell = registry.build_cell(arch, shape, {"data": 16, "model": 16})
        assert isinstance(cell, Cell) and cell.arch == arch and len(cell.args) == len(
            cell.in_shardings)


def _recsys_case(name):
    cfg = registry.get_arch(name).SMOKE
    p = recsys.init_recsys(0, cfg, device="cpu")
    g = torch.Generator().manual_seed(1)
    B = 8
    if cfg.model == "bst":
        b = {"history": torch.randint(0, cfg.n_items, (B, cfg.seq_len), generator=g),
             "target_item": torch.randint(0, cfg.n_items, (B,), generator=g)}
    else:
        b = {"ids": torch.stack([torch.randint(0, v, (B,), generator=g)
                                 for v in cfg.vocab_sizes], 1)}
    if cfg.model == "two_tower":
        b["item"] = torch.randint(0, cfg.n_items, (B,), generator=g)
    b["labels"] = (torch.rand(B, generator=g) < 0.5).float()
    return cfg, p, b


def _gnn_case():
    g = synthetic.make_mesh_graph(32, d_feat=8, d_edge=4, d_out=2, seed=0)
    cfg = gnn.GNNConfig(n_layers=2, d_hidden=16, d_node_in=8, d_edge_in=4, d_out=2)
    b = {"node_feat": torch.as_tensor(g.node_feat), "edge_feat": torch.as_tensor(g.edge_feat),
         "senders": torch.as_tensor(g.senders).long(),
         "receivers": torch.as_tensor(g.receivers).long(),
         "labels": torch.randn(32, 2, generator=torch.Generator().manual_seed(2))}
    return cfg, gnn.init_gnn(0, cfg, device="cpu"), b


def _same(a, b):
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        assert torch.allclose(torch.as_tensor(x), torch.as_tensor(y), rtol=1e-5, atol=1e-6)


def _train(cfg, p, b, mesh):
    return recsys.make_train_step(cfg, mesh)(p, adam_init(p), b)[0]


MESH_CALLS = {
    "embedding_lookup": lambda m: recsys.embedding_lookup(
        torch.arange(6.0).reshape(3, 2), torch.tensor([[2, 0]]), m),
    "sharded_embedding_lookup": lambda m: recsys.sharded_embedding_lookup(
        torch.arange(6.0).reshape(3, 2), torch.tensor([[2, 0]]), m) if m else
    torch.arange(6.0).reshape(3, 2)[torch.tensor([[2, 0]])],
    "recsys_train_step": lambda m: _train(*_recsys_case("deepfm"), m),
    "recsys_serve_step": lambda m: (lambda c, p, b: recsys.make_serve_step(c, m)(
        p, {"history": b["history"], "target_item": b["target_item"]}))(*_recsys_case("bst")),
    "retrieval_step": lambda m: (lambda c, p, b: recsys.make_retrieval_step(c, m, k=5)(
        p, {"ids": b["ids"][:1]}, torch.randn(64, c.out_dim,
                                              generator=torch.Generator().manual_seed(3))))(
        *_recsys_case("two-tower-retrieval")),
    "gnn_forward": lambda m: (lambda c, p, b: gnn.forward(
        p, b["node_feat"], b["edge_feat"], b["senders"], b["receivers"], c, m))(*_gnn_case()),
    "gnn_loss": lambda m: (lambda c, p, b: gnn.loss_fn(p, b, c, m))(*_gnn_case()),
    "gnn_train_step": lambda m: (lambda c, p, b: gnn.make_train_step(c, m)(
        p, adam_init(p), b)[0])(*_gnn_case()),
}


@pytest.mark.parametrize("call", list(MESH_CALLS))
def test_mesh_forms_raise_until_the_sharding_rules(call, tmp_path):
    """The mesh forms came with the sharding rules: on a one-rank (1, 1)
    gloo mesh each equals its single-device form (the eight-rank forms are
    held to JAX's in ``tests/test_torch_dist_models.py``)."""
    from _torch_one_rank import one_rank_mesh

    with one_rank_mesh(tmp_path) as mesh:
        got = MESH_CALLS[call](mesh)
    _same(got, MESH_CALLS[call](None))


def test_inits_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: recsys.init_recsys(0, registry.get_arch("deepfm").SMOKE),
                 lambda: gnn.init_gnn(0, GNN_SMOKE)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()

"""The port's training path held to the JAX package's: the new data
generators (bit for bit), the loader and slicer (twins of
``tests/test_data.py``), the checkpoint manager's tree forms (twins of
``tests/test_checkpoint.py``), the trainer (twins of ``tests/test_trainer.py``)
and checkpoints crossing between the two packages' ``TrainLoop``s.

Tolerances: a resumed step's loss rtol 1e-5 and its Adam step by
``_torch_model_parity.check_step``; restored leaves bit for bit.
"""
from __future__ import annotations

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_parity import one_torch_thread, to_np  # noqa: F401 (fixture)
from _torch_model_parity import check_step
from repro.checkpoint import manager as jmanager
from repro.common.pytree import named_leaves as jnamed
from repro.configs import registry as jregistry
from repro.data import synthetic as jsynthetic
from repro.models import recsys as jrecsys
from repro.optim import adam as jadam
from repro.train import TrainerConfig as JTrainerConfig
from repro.train import TrainLoop as JTrainLoop

from repro_torch.checkpoint import CheckpointManager, manager, restore_tree, save
from repro_torch.checkpoint.manager import latest_step
from repro_torch.common.pytree import named_leaves, tree_leaves, tree_map, value_and_grad
from repro_torch.configs import registry
from repro_torch.data import loader, synthetic
from repro_torch.models import recsys
from repro_torch.optim import adam_init, adam_update
from repro_torch.train import TrainerConfig, TrainLoop

# ---------------------------------------------------------------------------
# data: generators and loader
# ---------------------------------------------------------------------------


def test_mesh_graph_csr_consistent():
    g = synthetic.make_mesh_graph(100, seed=0)
    assert g.row_ptr[-1] == len(g.col_idx)
    assert (np.diff(g.receivers) >= 0).all()           # CSR by receiver
    deg = np.diff(g.row_ptr)
    assert (deg >= 0).all() and deg.sum() == len(g.senders)


def test_clicks_labels_and_vocab_bounds():
    vs = np.array([50, 100, 10])
    d = synthetic.make_clicks(200, 3, vs, hist_len=5, n_items=77)
    assert d["ids"].shape == (200, 3)
    for f in range(3):
        assert d["ids"][:, f].max() < vs[f]
    assert set(np.unique(d["labels"])) <= {0.0, 1.0}
    assert d["history"].max() < 77


def test_lm_token_batches():
    batches = list(synthetic.lm_token_batches(100, 4, 16, 3))
    assert len(batches) == 3
    toks, labels = batches[0]
    assert toks.shape == (4, 16) and labels.shape == (4, 16)
    assert (labels[:, :-1] == toks[:, 1:]).all()


GENERATORS = {
    "lm_token_batches": lambda m: list(m.lm_token_batches(300, 3, 9, 2, seed=5)),
    "make_mesh_graph": lambda m: m.make_mesh_graph(150, avg_degree=8, d_feat=5, d_edge=3,
                                                   d_out=1, seed=2),
    "make_clicks": lambda m: m.make_clicks(64, 5, np.array([9, 1000, 3, 70, 5]), seed=3,
                                           hist_len=6, n_items=40),
}


@pytest.mark.parametrize("name", list(GENERATORS))
def test_generators_match_jax_bit_for_bit(name):
    got, want = GENERATORS[name](synthetic), GENERATORS[name](jsynthetic)
    flat = lambda x: (x if isinstance(x, (list, tuple)) else
                      [x[k] for k in sorted(x)] if isinstance(x, dict) else
                      [getattr(x, f) for f in x.__dataclass_fields__])
    a, b = flat(got), flat(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for u, v in (zip(x, y) if isinstance(x, tuple) else [(x, y)]):
            assert u.dtype == v.dtype and np.array_equal(u, v)


def test_sharded_loader_prefetch():
    batches = [np.full((4,), i, np.float32) for i in range(5)]
    out = list(loader.ShardedLoader(iter(batches), prefetch=2, device="cpu"))
    assert len(out) == 5
    for i, b in enumerate(out):
        assert isinstance(b, torch.Tensor) and float(b[0]) == i


def test_loader_places_trees_and_raises_the_producers_error():
    def gen():
        yield {"ids": np.arange(3, dtype=np.int32), "y": [np.ones(2, np.float32)]}
        raise OSError("disk gone")

    it = iter(loader.ShardedLoader(gen(), device="cpu"))
    first = next(it)
    assert first["ids"].dtype == torch.int32 and first["y"][0].tolist() == [1.0, 1.0]
    with pytest.raises(OSError, match="disk gone"):
        next(it)


def test_loader_refuses_shardings_and_defaults_to_the_card(monkeypatch, tmp_path):
    """``shardings`` needs the mesh its specs refer to; with it each leaf
    comes as the rank's block (of a one-rank gloo mesh here)."""
    from _torch_one_rank import one_rank_mesh
    from repro_torch.dist.sharding import P

    with pytest.raises(ValueError, match="mesh"):
        loader.ShardedLoader([], shardings={"x": None}, device="cpu")
    batch = {"x": np.arange(8).reshape(4, 2), "y": np.ones(3)}
    with one_rank_mesh(tmp_path) as mesh:
        got = next(iter(loader.ShardedLoader([batch], {"x": P(("data",), None), "y": P()},
                                             mesh=mesh, device="cpu")))
    assert torch.equal(got["x"], torch.as_tensor(batch["x"])) and got["y"].shape == (3,)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        loader.ShardedLoader([])


def test_local_batch_slicer():
    g = np.arange(12)
    assert (loader.local_batch_slicer(g, 1, 3) == np.array([4, 5, 6, 7])).all()


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------

def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "layer": {"w": torch.as_tensor(rng.standard_normal((4, 8)), dtype=torch.float32),
                  "b": torch.as_tensor(rng.standard_normal(8)).to(torch.bfloat16)},
        "step_count": torch.tensor(7, dtype=torch.int32),
    }


def _zeros(tree):
    return tree_map(torch.zeros_like, tree)


def _equal(a, b):
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_roundtrip_identity(tmp_path):
    tree = _tree()
    save(tmp_path, 10, tree)
    restored, step = restore_tree(tmp_path, _zeros(tree))
    assert step == 10 and _equal(tree, restored)
    # JAX's layout and names: bf16 stored as fp32, read by the JAX manager
    jtree, jstep = jmanager.restore(tmp_path, {
        "layer": {"w": jnp.zeros((4, 8)), "b": jnp.zeros(8, jnp.bfloat16)},
        "step_count": jnp.zeros((), jnp.int32)})
    assert jstep == 10 and jtree["layer"]["b"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(jtree["layer"]["b"], np.float32),
                                  tree["layer"]["b"].float().numpy())


def test_uncommitted_checkpoints_ignored(tmp_path):
    save(tmp_path, 5, _tree())
    d = tmp_path / "step_00000009"
    d.mkdir()
    (d / "manifest.json").write_text("{}")
    assert latest_step(tmp_path) == 5


def test_restore_validates_shapes_and_leaves(tmp_path):
    save(tmp_path, 1, _tree())
    bad = {"layer": {"w": torch.zeros((3, 3)), "b": torch.zeros(8, dtype=torch.bfloat16)},
           "step_count": torch.zeros((), dtype=torch.int32)}
    with pytest.raises(ValueError):
        restore_tree(tmp_path, bad)
    with pytest.raises(KeyError):
        restore_tree(tmp_path, dict(_zeros(_tree()), extra=torch.zeros(1)))
    with pytest.raises(FileNotFoundError):
        restore_tree(tmp_path / "none", _tree())


def test_async_save_and_retention(tmp_path):
    mgr = CheckpointManager(tmp_path, keep_last=2)
    tree = _tree()
    for s in (1, 2, 3, 4):
        mgr.save_async(s, tree)
    mgr.wait()
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.iterdir()
                   if p.name.startswith("step_"))
    assert steps == [3, 4]
    restored, step = mgr.restore_latest(_zeros(tree))
    assert step == 4 and _equal(tree, restored)


def test_save_async_takes_a_copy(tmp_path):
    """The snapshot is a copy: a write to the live tensors after
    ``save_async`` returns (on the CPU ``.numpy()`` would alias them) does
    not reach the checkpoint."""
    mgr = CheckpointManager(tmp_path)
    tree = _tree()
    want = tree_map(torch.clone, tree)
    mgr.save_async(1, tree)
    for t in tree_leaves(tree):
        t.add_(1)
    mgr.wait()
    assert _equal(mgr.restore_latest(_zeros(tree))[0], want)


def _simulate_crash_mid_save(directory, step):
    directory = pathlib.Path(directory)
    staged = directory / f"step_{step:08d}.tmp"
    staged.mkdir(parents=True)
    (staged / "shard_00000.npz").write_bytes(b"PK\x03\x04 truncated")
    bare = directory / f"step_{step + 1:08d}"
    bare.mkdir(parents=True)
    (bare / "shard_00000.npz").write_bytes(b"PK\x03\x04 truncated")
    (bare / "manifest.json").write_text("{")


def test_crash_mid_save_restores_last_complete(tmp_path):
    tree = _tree()
    save(tmp_path, 5, tree)
    _simulate_crash_mid_save(tmp_path, 6)
    assert latest_step(tmp_path) == 5
    restored, step = restore_tree(tmp_path, _zeros(tree))
    assert step == 5 and _equal(tree, restored)


def test_crash_mid_save_then_resave_recovers(tmp_path):
    save(tmp_path, 5, _tree())
    _simulate_crash_mid_save(tmp_path, 5)
    d = save(tmp_path, 5, _tree(seed=1))
    assert d.name == "step_00000005" and latest_step(tmp_path) == 5
    restored, _ = restore_tree(tmp_path, _zeros(_tree()), step=5)
    assert _equal(_tree(seed=1), restored)


def test_retriever_load_survives_crash_mid_save(tmp_path):
    from repro_torch.core.config import LemurConfig
    from repro_torch.retriever import LemurRetriever, SearchParams

    corpus = synthetic.make_corpus(m=48, d=8, avg_tokens=6, max_tokens=8, n_centers=6,
                                   seed=0)
    cfg = LemurConfig(d=8, d_prime=16, m_pretrain=32, n_train=512, n_ols=128, epochs=1,
                      k=5, k_prime=24, anns="bruteforce")
    r = LemurRetriever.build(corpus, cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    r.save(tmp_path)
    _simulate_crash_mid_save(tmp_path, 0)
    r2 = LemurRetriever.load(tmp_path, device="cpu")
    q, qm = torch.as_tensor(corpus.doc_tokens[:4]), torch.as_tensor(corpus.doc_mask[:4])
    p = SearchParams(k=5, k_prime=24)
    s1, i1 = r.search(q, qm, p)
    s2, i2 = r2.search(q, qm, p)
    assert torch.equal(i1, i2) and torch.equal(s1, s2)


def test_elastic_restore_onto_the_targets_device_and_dtype(tmp_path):
    """The one-process counterpart of JAX's elastic restore: each leaf lands
    on its target leaf's device and dtype (a bf16 leaf saved as fp32 comes
    back bit for bit; fp32 into an fp64 target widens exactly), and a
    re-shard onto a mesh needs the mesh its specs refer to."""
    tree = _tree()
    save(tmp_path, 3, tree)
    target = {"layer": {"w": torch.zeros((4, 8), dtype=torch.float64),
                        "b": torch.zeros(8, dtype=torch.bfloat16)},
              "step_count": torch.zeros((), dtype=torch.int64)}
    restored, _ = restore_tree(tmp_path, target)
    assert restored["layer"]["w"].dtype == torch.float64
    assert torch.equal(restored["layer"]["w"], tree["layer"]["w"].double())
    assert torch.equal(restored["layer"]["b"], tree["layer"]["b"])
    assert all(t.device.type == "cpu" for t in tree_leaves(restored))
    with pytest.raises(ValueError, match="mesh"):
        CheckpointManager(tmp_path).restore_latest(target, shardings=target)
    from _torch_one_rank import one_rank_mesh
    from repro_torch.dist.sharding import P

    specs = {"layer": {"w": P(None, "model"), "b": P()}, "step_count": P()}
    with one_rank_mesh(tmp_path.parent) as mesh:
        blocks, _ = CheckpointManager(tmp_path).restore_latest(target, specs, mesh=mesh)
    assert torch.equal(blocks["layer"]["w"], tree["layer"]["w"].double())


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------

def _setup(tmp_path, **kw):
    params = {"w": torch.tensor([1.0, -1.0])}

    def step_fn(params, opt, batch):
        loss, grads = value_and_grad(lambda p: torch.mean(torch.square(p["w"] - batch)),
                                     params)
        params, opt, m = adam_update(grads, opt, params, lr=0.05, grad_clip=None)
        return params, opt, {"loss": loss, **m}

    cfg = TrainerConfig(checkpoint_dir=str(tmp_path), log_every=0, **kw)
    return cfg, step_fn, params, adam_init(params)


def _batches(n):
    return [torch.tensor([0.5, 0.5])] * n


def test_loop_trains(tmp_path):
    cfg, step_fn, p, o = _setup(tmp_path, total_steps=20, checkpoint_every=10)
    out = TrainLoop(cfg, step_fn, p, o, logger=lambda s: None).run(_batches(20))
    assert out["final_step"] == 20
    assert out["history"][-1]["loss"] < out["history"][0]["loss"]


def test_retry_on_transient_failure(tmp_path):
    cfg, step_fn, p, o = _setup(tmp_path, total_steps=10, checkpoint_every=5, max_retries=2)
    fails = {"count": 0}

    def fault_hook(step):
        if step == 3 and fails["count"] < 2:
            fails["count"] += 1
            raise RuntimeError("simulated interconnect fault")

    loop = TrainLoop(cfg, step_fn, p, o, fault_hook=fault_hook, logger=lambda s: None)
    out = loop.run(_batches(10))
    assert out["final_step"] == 10 and out["retries"] == 2


def test_nan_guard_skips_update(tmp_path):
    params = {"w": torch.tensor([1.0])}
    calls = {"n": 0}

    def step_fn(params, opt, batch):
        calls["n"] += 1
        loss = torch.tensor(float("nan")) if calls["n"] == 2 else torch.tensor(0.5)
        return tree_map(lambda x: x - 0.1, params), opt, {"loss": loss}

    cfg = TrainerConfig(checkpoint_dir=str(tmp_path), total_steps=3, checkpoint_every=0,
                        log_every=0)
    loop = TrainLoop(cfg, step_fn, params, adam_init(params), logger=lambda s: None)
    out = loop.run(_batches(3))
    assert out["nan_skips"] == 1
    np.testing.assert_allclose(float(loop.params["w"][0]), 1.0 - 0.2, rtol=1e-5)


def test_restart_resumes_from_checkpoint(tmp_path):
    cfg, step_fn, p, o = _setup(tmp_path, total_steps=10, checkpoint_every=5)
    TrainLoop(cfg, step_fn, p, o, logger=lambda s: None).run(_batches(7))
    cfg2, step_fn2, p2, o2 = _setup(tmp_path, total_steps=10, checkpoint_every=5)
    loop2 = TrainLoop(cfg2, step_fn2, p2, o2, logger=lambda s: None)
    assert loop2.try_restore() and loop2.step == 7
    assert loop2.run(_batches(3))["final_step"] == 10


@pytest.mark.parametrize("with_checkpoint", [False, True])
def test_exhausted_retries_raise_or_restore_as_jax(tmp_path, with_checkpoint):
    """A step failing on every attempt: without a checkpoint the loop raises
    (as JAX's); with one it re-restores the newest step from disk and goes
    on.  JAX's loop reads the directory without waiting for its own save in
    flight, so its saves are made to wait here; the port's manager waits."""
    results = {}
    for pkg, (Cfg, Loop, mk) in {
        "port": (TrainerConfig, TrainLoop, lambda: ({"w": torch.ones(2)},
                                                    lambda p: adam_init(p))),
        "jax": (JTrainerConfig, JTrainLoop, lambda: ({"w": jnp.ones(2)},
                                                     lambda p: jadam.adam_init(p))),
    }.items():
        d = tmp_path / pkg
        params, init = mk()
        step = lambda p, o, b: (p, o, {"loss": 0.0})
        cfg = Cfg(checkpoint_dir=str(d), total_steps=4, checkpoint_every=1, log_every=0,
                  max_retries=1)
        hook = lambda s: (_ for _ in ()).throw(RuntimeError("down")) if s == 2 else None
        loop = Loop(cfg, step, params, init(params), fault_hook=hook, logger=lambda s: None)
        if not with_checkpoint:
            loop.ckpt.save_async = lambda *a, **k: None
            with pytest.raises(RuntimeError, match="down"):
                loop.run([0] * 4)
            results[pkg] = "raised"
        else:
            if pkg == "jax":
                save = loop.ckpt.save_async
                loop.ckpt.save_async = lambda *a, **k: (save(*a, **k), loop.ckpt.wait())
            out = loop.run([0] * 4)
            results[pkg] = (out["final_step"], out["retries"], out["restores"])
    assert results["port"] == results["jax"]
    if with_checkpoint:
        assert results["port"] == (4, 2, 1)


def test_latest_step_waits_for_a_save_in_flight(tmp_path, monkeypatch):
    """A restore right after ``save_async`` finds that step, however slow
    its write: the manager waits for the save in flight."""
    import time

    write = manager._write_step
    monkeypatch.setattr(manager, "_write_step",
                        lambda *a, **k: (time.sleep(0.3), write(*a, **k))[1])
    mgr = CheckpointManager(tmp_path)
    tree = _tree()
    save(tmp_path, 1, tree)
    mgr.save_async(2, _tree(seed=1))
    assert mgr.latest_step() == 2
    mgr.save_async(3, tree)
    restored, step = mgr.restore_latest(_zeros(tree))
    assert step == 3 and _equal(tree, restored)


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------

CROSS_ARCHS = ["deepfm", "xdeepfm", "bst", "two-tower-retrieval"]


def _cross_setup(arch, tmp_path):
    jcfg = jregistry.get_arch(arch).SMOKE
    cfg = registry.get_arch(arch).SMOKE
    d = jsynthetic.make_clicks(16, max(jcfg.n_fields, 1), np.array(jcfg.vocab_sizes or [10]),
                               seed=0, hist_len=jcfg.seq_len, n_items=jcfg.n_items)
    keys = {"bst": ("history", "target_item", "labels"),
            "two_tower": ("ids", "target_item", "labels")}.get(jcfg.model, ("ids", "labels"))
    b = {("item" if k == "target_item" and jcfg.model == "two_tower" else k):
         (d[k][:, :jcfg.n_fields] if k == "ids" else d[k]) for k in keys}
    tc = dict(checkpoint_dir=str(tmp_path), total_steps=2, checkpoint_every=0, log_every=0)
    return jcfg, cfg, b, tc


def _jax_loop(jcfg, tc, seed):
    p = jax.jit(jrecsys.init_recsys, static_argnums=1)(jax.random.PRNGKey(seed), jcfg)
    return JTrainLoop(JTrainerConfig(**tc), jax.jit(jrecsys.make_train_step(jcfg)), p,
                      jadam.adam_init(p), logger=lambda s: None)


def _port_loop(cfg, tc, seed):
    p = recsys.init_recsys(torch.Generator().manual_seed(seed), cfg, device="cpu")
    return TrainLoop(TrainerConfig(**tc), recsys.make_train_step(cfg), p, adam_init(p),
                     logger=lambda s: None)


def _state_equal(port_state, jax_state):
    got, want = named_leaves(port_state), jnamed(jax_state)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, a), (_, b) in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b)), n


@pytest.mark.parametrize("arch", CROSS_ARCHS)
def test_jax_checkpoint_resumes_in_the_port(arch, tmp_path):
    """A JAX ``TrainLoop`` trains two steps and saves; the port's loop
    (another init) restores it bit for bit and resumes at step 2, and its
    next step matches JAX's next step on the same batch."""
    jcfg, cfg, b, tc = _cross_setup(arch, tmp_path)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jloop = _jax_loop(jcfg, tc, 0)
    jloop.run([jb] * 2)
    loop = _port_loop(cfg, tc, 1)
    assert loop.try_restore() and loop.step == 2
    _state_equal((loop.params, loop.opt_state), (jloop.params, jloop.opt_state))
    jp, jo, jm = jax.jit(jrecsys.make_train_step(jcfg))(jloop.params, jloop.opt_state, jb)
    p, o, m = loop.step_fn(loop.params, loop.opt_state, {k: torch.as_tensor(v)
                                                         for k, v in b.items()})
    check_step(p, o, m, jp, jo, jm)


@pytest.mark.parametrize("arch", CROSS_ARCHS)
def test_port_checkpoint_resumes_in_jax(arch, tmp_path):
    """The reverse: the port's loop trains and saves, JAX's loop restores it
    bit for bit, and the two next steps agree."""
    jcfg, cfg, b, tc = _cross_setup(arch, tmp_path)
    pb = {k: torch.as_tensor(v) for k, v in b.items()}
    loop = _port_loop(cfg, tc, 0)
    loop.run([pb] * 2)
    jloop = _jax_loop(jcfg, tc, 1)
    assert jloop.try_restore() and jloop.step == 2
    _state_equal((loop.params, loop.opt_state), (jloop.params, jloop.opt_state))
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jp, jo, jm = jax.jit(jrecsys.make_train_step(jcfg))(jloop.params, jloop.opt_state, jb)
    p, o, m = loop.step_fn(loop.params, loop.opt_state, pb)
    check_step(p, o, m, jp, jo, jm)

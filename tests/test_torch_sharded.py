"""The port's corpus-sharded serving held against the JAX sharded facade.

A JAX ``LemurRetriever`` is built on a 90-doc corpus (IVF first stage, a
few docs deleted) and saved; the port loads the checkpoint on the CPU and
shards it with ``LemurRetriever.shard`` over a gloo ``DeviceMesh``:

* one shard, in this process (world size 1, ``("model",)``): every route
  (SQ8 or fp32 state x ``use_fused_gather`` x ``use_one_launch``) returns
  the ids and scores of JAX's ``r.shard(make_mesh((1,), ("model",)))``;
  k above the pool pads to k, a residual (4-bit) retriever shards, a port
  save is served by the JAX sharded facade;
* eight ranks (one ``torch.multiprocessing.spawn`` of 8 gloo processes, a
  (2, 4) ``("data", "model")`` mesh, ``tests/_torch_sharded_ranks.py``):
  fp32 and SQ8 on three routes against the JAX sharded facade on 8 forced
  host devices (an ``AxisType.Auto`` (2, 4) mesh), every rank returning the
  merged result; and ``make_index_step``'s W rows against JAX's.

With m = 90 rows on 8 shards the pool is padded (16 rows a shard), and the
per-shard budget k'_loc = max(k, 4 k' / n) is below the rows on one shard
and on eight, so the latent top-k' matters.

Tolerance: the frameworks sum fp32 products in other orders, so scores
agree to rtol 1e-5 / atol 1e-4 and ids up to counted near-ties (relative
score gap < 1e-5); the index step's W to 1e-3 x max|W| (two Cholesky
factors, lower and upper, of one Gram matrix).
"""
import pathlib
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as tdist
from torch.distributed.device_mesh import init_device_mesh

from repro.anns.params import IVFBackendConfig as JaxIVFConfig
from repro.anns.params import ResidualConfig as JaxResidual
from repro.common import compat
from repro.core.config import LemurConfig as JaxConfig
from repro.data import synthetic
from repro.retriever import LemurRetriever as JaxRetriever
from repro.retriever import SearchParams as JaxParams
from repro.retriever import ShardedLemurRetriever as JaxSharded

from repro_torch import dist as pdist
from repro_torch.retriever import LemurRetriever, SearchParams, ShardedLemurRetriever

RTOL, ATOL, TIE = 1e-5, 1e-4, 1e-5
M, K, K_PRIME = 90, 5, 16
DELETED = [4, 31, 77]
RANKS = pathlib.Path(__file__).with_name("_torch_sharded_ranks.py")


def jax_cfg(residual: bool = False) -> JaxConfig:
    extra = {}
    if residual:
        extra = dict(ivf=JaxIVFConfig(nprobe=4, residual_bits=4),
                     residual=JaxResidual(enabled=True, bits=4, ncent=16, kmeans_iters=3))
    return JaxConfig(d=16, d_prime=32, m_pretrain=64, n_train=512, n_ols=256, epochs=3,
                     k=K, k_prime=K_PRIME, anns="ivf", **extra)


def build_and_save(path, residual: bool = False):
    corpus = synthetic.make_corpus(m=M, d=16, avg_tokens=8, max_tokens=8, n_centers=16,
                                   seed=0)
    r = JaxRetriever.build(corpus, jax_cfg(residual), key=jax.random.PRNGKey(0))
    r.delete(DELETED)
    r.save(path)
    q = synthetic.queries_from_corpus_query(corpus, 6, q_tokens=5, seed=3).astype(np.float32)
    qm = np.random.default_rng(4).random(q.shape[:2]) > 0.25
    qm[:, 0] = True
    return r, q, qm


def assert_same_topk(s_ref, i_ref, s_got, i_got):
    """Scores within tolerance; differing ids only at counted near-ties."""
    s_ref, i_ref = np.asarray(s_ref), np.asarray(i_ref)
    s_got, i_got = np.asarray(s_got), np.asarray(i_got)
    assert s_got.shape == s_ref.shape and i_got.shape == i_ref.shape
    np.testing.assert_allclose(s_got, s_ref, rtol=RTOL, atol=ATOL)
    diff = i_got != i_ref
    gap = np.abs(s_got - s_ref) / np.maximum(np.abs(s_ref), 1.0)
    assert np.all(gap[diff] < TIE), "an id differs without a near-tie"
    assert diff.sum() <= max(1, diff.size // 50), f"{diff.sum()} near-ties"


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """A gloo process group of world size 1 and its ("model",) mesh."""
    store = tmp_path_factory.mktemp("pg") / "store"
    tdist.init_process_group("gloo", init_method=f"file://{store}", world_size=1, rank=0)
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("model",))
    finally:
        tdist.destroy_process_group()


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    path = tmp_path_factory.mktemp("sharded")
    r, q, qm = build_and_save(path)
    return r, LemurRetriever.load(path, device="cpu"), path, q, qm


MESH1 = compat.make_mesh((1,), ("model",))
# JAX's sharded mutation scatters without an out_sharding, which resolves
# only on an Auto mesh (ROADMAP Queue 3, item 2)
MESH1_AUTO = compat.make_mesh((1,), ("model",), axis_types=(compat.AxisType.Auto,))


@pytest.mark.parametrize("one_launch", [False, True], ids=["scan", "one_launch"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "legacy"])
@pytest.mark.parametrize("sq8", [True, False], ids=["sq8", "fp32"])
def test_one_shard_route_matches_jax(built, mesh, sq8, fused, one_launch):
    r, port, _, q, qm = built
    want = r.shard(MESH1, sq8=sq8).search(
        jnp.asarray(q), jnp.asarray(qm),
        JaxParams(use_fused_gather=fused, use_one_launch=one_launch))
    sr = port.shard(mesh, sq8=sq8)
    got = sr.search(q, qm, SearchParams(use_fused_gather=fused, use_one_launch=one_launch))
    assert got[1].dtype == torch.int32 and got[0].shape == (q.shape[0], K)
    assert_same_topk(*want, *got)
    assert not np.isin(got[1].numpy(), DELETED).any() and (got[1] >= 0).all()
    assert sr.rows_per_shard == 128 and sr.sq8 == sq8


@pytest.mark.parametrize("sq8", [True, False], ids=["sq8", "fp32"])
def test_k_above_the_pool_pads_to_k(built, mesh, sq8):
    """k = 200 over a 128-row pool: the merge's 128 columns, then (NEG, -1),
    and free or tombstoned rows never come out with an id."""
    r, port, _, q, qm = built
    want = r.shard(MESH1, sq8=sq8).search(jnp.asarray(q), jnp.asarray(qm),
                                          JaxParams(k=200, k_prime=400))
    got = port.shard(mesh, sq8=sq8).search(q, qm, SearchParams(k=200, k_prime=400))
    assert got[0].shape == (q.shape[0], 200)
    assert_same_topk(*want, *got)
    ids = got[1].numpy()
    live = M - len(DELETED)
    assert (ids[:, :live] >= 0).all() and (ids[:, live:] == -1).all()
    assert (got[0].numpy()[:, live:] == -1e30).all()


def test_residual_retriever_shards(mesh, tmp_path):
    """A residual (4-bit) base store is decoded into the block
    (``pages.gather_docs``) and served as JAX serves it."""
    r, q, qm = build_and_save(tmp_path, residual=True)
    port = LemurRetriever.load(tmp_path, device="cpu")
    assert port.index.store.residual
    for sq8 in (True, False):
        want = r.shard(MESH1, sq8=sq8).search(jnp.asarray(q), jnp.asarray(qm))
        got = port.shard(mesh, sq8=sq8).search(q, qm)
        assert_same_topk(*want, *got)


def test_sharded_save_is_served_by_jax(built, mesh, tmp_path):
    _, port, _, q, qm = built
    sr = port.shard(mesh)
    sr.save(tmp_path)
    want = JaxSharded.load(tmp_path, MESH1).search(jnp.asarray(q), jnp.asarray(qm))
    assert_same_topk(*want, *sr.search(q, qm))
    again = ShardedLemurRetriever.load(tmp_path, mesh)
    assert all(torch.equal(a, b) for a, b in zip(again.search(q, qm), sr.search(q, qm)))
    assert repr(again) == f"ShardedLemurRetriever(m={M}, mesh=1, sq8=True)"


# --------------------------------------------------------------------------
# mutation, one shard in this process
# --------------------------------------------------------------------------

def mutate(sr, new):
    """The mutation sequence of both sharded facades: an add into free rows,
    a delete, an update, then an add past the pool's free rows (a rebuild
    in the next bucket).  Returns the block's state after each phase."""
    sr.add(new.doc_tokens[:10], new.doc_mask[:10])
    sr.delete([5, 91])
    sr.update([6, 94], new.doc_tokens[10:13], new.doc_mask[10:13])
    first = {k: np.asarray(v) for k, v in sr.state._asdict().items()
             if k != "psi" and v is not None}
    sr.add(new.doc_tokens[13:53], new.doc_mask[13:53])
    return first


def block_equal(want: dict, got: dict, rows: slice, sq8: bool):
    """This rank's rows of JAX's sharded state: the slot map, the masks and
    the token codes and scales bit for bit (the tokens come from the same
    pages), W within 1e-3 x max|W| (the new rows are two frameworks' fits;
    for SQ8 dequantized, plus one code step of the row, since a fit that
    differs in the last bits can round to the next code)."""
    for k in ("row_ids", "row_valid", "doc_mask", "doc_tokens", "doc_scales"):
        if k in want:
            assert np.array_equal(got[k], want[k][rows]), k
    W = want["W"][rows].astype(np.float32)
    Wg = got["W"].astype(np.float32)
    step = 0.0
    if sq8:
        W, Wg = W * want["W_scales"][rows][:, None], Wg * got["W_scales"][:, None]
        step = np.maximum(want["W_scales"][rows], got["W_scales"])[:, None]
    assert (np.abs(Wg - W) <= 1e-3 * max(1e-6, np.abs(W).max()) + step).all()


@pytest.mark.parametrize("sq8", [True, False], ids=["sq8", "fp32"])
def test_one_shard_mutation_matches_jax(built, mesh, sq8):
    """The same mutations on JAX's sharded facade and the port's, one shard:
    the block row for row after the in-place phase and after the rebuild,
    the searches after it, the version and the compile accounting."""
    _, _, path, q, qm = built
    new = synthetic.make_corpus(m=60, d=16, avg_tokens=8, max_tokens=8, n_centers=16, seed=5)
    js = JaxSharded.load(path, MESH1_AUTO, sq8=sq8)
    ps = ShardedLemurRetriever.load(path, mesh, sq8=sq8)
    for sr, cast in ((js, jnp.asarray), (ps, lambda x: x)):
        sr.search(cast(q), cast(qm))
    want1, got1 = mutate(js, new), mutate(ps, new)
    block_equal(want1, got1, slice(0, 128), sq8)
    want2 = {k: np.asarray(v) for k, v in js.state._asdict().items()
             if k != "psi" and v is not None}
    got2 = {k: v.numpy() for k, v in ps.state._asdict().items()
            if k != "psi" and v is not None}
    assert ps.rows_per_shard == js.rows_per_shard == 256
    block_equal(want2, got2, slice(0, 256), sq8)
    assert ps._row_of == js._row_of and ps._free_rows == js._free_rows
    assert ps.version == js.version == 4 and np.array_equal(ps.last_added_ids,
                                                            np.asarray(js.last_added_ids))
    for params in ({}, {"use_one_launch": True}):
        want = js.search(jnp.asarray(q), jnp.asarray(qm), JaxParams(**params))
        got = ps.search(q, qm, SearchParams(**params))
        assert_same_topk(*want, *got)
        assert not np.isin(got[1].numpy(), [5, 6, 91, 94]).any()
    assert ps.trace_count() == js.trace_count() and ps.trace_count(SearchParams()) == 2
    assert ps.trace_shapes() == {tuple(k): v for k, v in js.trace_shapes().items()}


def test_sharded_clone_and_refresh(built, mesh):
    """A clone keeps its block while the original mutates; a corrupt refresh
    leaves the block as it was."""
    from repro_torch.retriever import CorruptIndexError

    _, _, path, q, qm = built
    sr = ShardedLemurRetriever.load(path, mesh)
    twin = sr.clone()
    want = twin.search(q, qm)
    new = synthetic.make_corpus(m=5, d=16, avg_tokens=8, max_tokens=8, n_centers=16, seed=6)
    sr.add(new.doc_tokens, new.doc_mask)
    sr.delete([0, 1])
    got = twin.search(q, qm)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert twin.m == M and sr.m == M + 5
    block = {k: v.clone() for k, v in sr.state._asdict().items() if isinstance(v, torch.Tensor)}
    with pytest.raises(CorruptIndexError):
        sr.install_refresh(types.SimpleNamespace(backend="ivf", m0=0))
    assert all(torch.equal(getattr(sr.state, k), v) for k, v in block.items())


def test_a_cuda_mesh_refuses_cpu_tensors(built):
    """The mesh's device type decides: a cuda mesh over a retriever on the
    CPU raises, and loading onto it raises without a card; nothing falls
    back to the CPU."""
    _, port, path, _, _ = built
    cuda_mesh = types.SimpleNamespace(device_type="cuda", shape=(1,),
                                      mesh_dim_names=("model",), ndim=1)
    with pytest.raises(ValueError, match="cuda"):
        port.shard(cuda_mesh)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ShardedLemurRetriever.load(path, cuda_mesh)


def test_default_k_prime_local_and_shard_blocks(mesh):
    assert pdist.default_k_prime_local(100, 1024, 1) == 4096
    assert pdist.default_k_prime_local(K, K_PRIME, 8) == 8
    assert pdist.default_k_prime_local(100, 16, 8) == 100
    assert pdist.n_corpus_shards(mesh) == 1 and pdist.shard_index(mesh) == 0
    assert pdist.local_rows(mesh, 128) == slice(0, 128)
    assert pdist.corpus_axes(mesh) == ("model",)


# --------------------------------------------------------------------------
# eight ranks on a (2, 4) mesh, against JAX on 8 forced host devices
# --------------------------------------------------------------------------

_JAX_ORACLE = """
import jax, jax.numpy as jnp, numpy as np
from repro.common import compat
from repro.core.config import LemurConfig
from repro.core import indexer
from repro.core.model import init_psi
from repro.dist import make_index_step
from repro.retriever import SearchParams, ShardedLemurRetriever

ROUTES = {{"fused": {{}}, "one_launch": {{"use_one_launch": True}},
          "legacy": {{"use_fused_gather": False}}}}
z = np.load("{inputs}")
mesh = compat.make_mesh((2, 4), ("data", "model"),
                        axis_types=(compat.AxisType.Auto,) * 2)
out = {{}}
for sq8 in (False, True):
    sr = ShardedLemurRetriever.load("{ckpt}", mesh, sq8=sq8)
    tag = "sq8" if sq8 else "fp32"
    out[tag + "_rows"] = np.array(sr.rows_per_shard)
    for name, kw in ROUTES.items():
        s, i = sr.search(jnp.asarray(z["q"]), jnp.asarray(z["qm"]), SearchParams(**kw))
        out[tag + "_" + name + "_scores"], out[tag + "_" + name + "_ids"] = (
            np.asarray(s), np.asarray(i))
psi = {{"dense": {{"kernel": jnp.asarray(z["kernel"]), "bias": jnp.asarray(z["bias"])}},
       "ln": {{"scale": jnp.asarray(z["ln_scale"]), "bias": jnp.asarray(z["ln_bias"])}}}}
x = jnp.asarray(z["x_ols"])
cfg = LemurConfig(d=16, d_prime=32, ridge=float(z["ridge"]), n_ols=x.shape[0])
chol, feats = indexer.gram_factor(psi, x, cfg.ridge)
step = make_index_step(mesh, cfg, doc_block=12)
out["W"] = np.asarray(jax.jit(step)(chol[0], feats, x, jnp.asarray(z["docs"]),
                                    jnp.asarray(z["mask"]), jnp.zeros(()), jnp.ones(())))
new_t, new_m = z["new_tokens"], z["new_mask"]
for sq8 in (False, True):
    sr = ShardedLemurRetriever.load("{ckpt}", mesh, sq8=sq8)
    tag = "mut_sq8" if sq8 else "mut_fp32"
    sr.add(new_t[:10], new_m[:10])
    sr.delete([5, 91])
    sr.update([6, 94], new_t[10:13], new_m[10:13])
    for k, v in sr.state._asdict().items():
        if k != "psi" and v is not None:
            out[tag + "1_" + k] = np.asarray(v)
    sr.add(new_t[13:53], new_m[13:53])
    for k, v in sr.state._asdict().items():
        if k != "psi" and v is not None:
            out[tag + "2_" + k] = np.asarray(v)
    out[tag + "_rows"] = np.array(sr.rows_per_shard)
    s, i = sr.search(jnp.asarray(z["q"]), jnp.asarray(z["qm"]))
    out[tag + "_scores"], out[tag + "_ids"] = np.asarray(s), np.asarray(i)
np.savez("{out}", **out)
print("OK")
"""


@pytest.fixture(scope="module")
def eight_ranks(built, run_forced8, tmp_path_factory):
    """One spawn of 8 gloo ranks and one JAX run on 8 host devices, on the
    same inputs; returns (JAX results, per-rank port results)."""
    from repro.core.model import init_psi

    _, _, ckpt, q, qm = built
    work = tmp_path_factory.mktemp("eight_ranks")
    corpus = synthetic.make_corpus(m=96, d=16, avg_tokens=8, max_tokens=8, seed=0)
    new = synthetic.make_corpus(m=60, d=16, avg_tokens=8, max_tokens=8, n_centers=16, seed=5)
    psi = init_psi(jax.random.PRNGKey(0), 16, 32)
    inputs = work / "inputs.npz"
    np.savez(inputs, q=q, qm=qm, new_tokens=new.doc_tokens.astype(np.float32),
             new_mask=new.doc_mask, kernel=np.asarray(psi["dense"]["kernel"]),
             bias=np.asarray(psi["dense"]["bias"]), ln_scale=np.asarray(psi["ln"]["scale"]),
             ln_bias=np.asarray(psi["ln"]["bias"]),
             x_ols=np.random.default_rng(1).standard_normal((128, 16)).astype(np.float32),
             docs=corpus.doc_tokens.astype(np.float32), mask=corpus.doc_mask,
             ridge=np.float32(1e-4))
    assert "OK" in run_forced8(textwrap.dedent(_JAX_ORACLE.format(
        inputs=inputs, ckpt=ckpt, out=work / "jax.npz")))
    ranks = work / "ranks"
    ranks.mkdir()
    res = subprocess.run([sys.executable, str(RANKS), str(inputs), str(ckpt), str(ranks)],
                         capture_output=True, text=True, timeout=300,
                         env={"PYTHONPATH": str(pathlib.Path(pdist.__file__).parents[2]),
                              "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr[-4000:]
    return (dict(np.load(work / "jax.npz")),
            [dict(np.load(ranks / f"rank_{r}.npz")) for r in range(8)])


@pytest.mark.parametrize("route", ["fused", "one_launch", "legacy"])
@pytest.mark.parametrize("tag", ["fp32", "sq8"])
def test_eight_ranks_match_jax(eight_ranks, tag, route):
    """Every rank returns the merged top-k, JAX's ids and scores; the pool
    is padded (90 slots in 8 x 16 rows)."""
    want, ranks = eight_ranks
    assert int(want[f"{tag}_rows"]) == 16
    for res in ranks:
        assert int(res[f"{tag}_rows"]) == 16
        assert_same_topk(want[f"{tag}_{route}_scores"], want[f"{tag}_{route}_ids"],
                         res[f"{tag}_{route}_scores"], res[f"{tag}_{route}_ids"])
        assert np.array_equal(res[f"{tag}_{route}_ids"], ranks[0][f"{tag}_{route}_ids"])


@pytest.mark.parametrize("tag", ["fp32", "sq8"])
def test_eight_ranks_mutation_matches_jax(eight_ranks, tag):
    """After the same add / delete / update on every rank and on JAX's
    sharded facade, each rank's block equals its rows of JAX's state, in
    place (16 rows a shard) and after the add that outgrows the pool (a
    rebuild at 32 rows a shard); every rank then serves JAX's merged top-k."""
    want, ranks = eight_ranks
    assert int(want[f"mut_{tag}_rows"]) == 32
    for r, res in enumerate(ranks):
        assert int(res[f"mut_{tag}_rows"]) == 32
        for phase, rows in (("1", 16), ("2", 32)):
            pre = f"mut_{tag}{phase}_"
            lo = int(res[pre + "start"])
            block_equal({k[len(pre):]: v for k, v in want.items() if k.startswith(pre)},
                        {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)},
                        slice(lo, lo + rows), tag == "sq8")
        assert_same_topk(want[f"mut_{tag}_scores"], want[f"mut_{tag}_ids"],
                         res[f"mut_{tag}_scores"], res[f"mut_{tag}_ids"])
        assert not np.isin(res[f"mut_{tag}_ids"], [5, 6, 91, 94]).any()
    starts = sorted(int(res[f"mut_{tag}2_start"]) for res in ranks)
    assert starts == [32 * r for r in range(8)]


def test_eight_ranks_index_step_matches_jax(eight_ranks):
    """Each rank's W rows of its 12-doc block equal JAX's sharded solve."""
    want, ranks = eight_ranks
    W = want["W"]
    for r, res in enumerate(ranks):
        lo, hi = res["rows"]
        assert (lo, hi) == (12 * r, 12 * (r + 1))
        err = np.abs(res["W"] - W[lo:hi]).max()
        assert err <= 1e-3 * np.abs(W).max(), err

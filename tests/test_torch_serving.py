"""The port's online serving runtime (``repro_torch.serving``), the twin of
``tests/test_serving_runtime.py`` on port-built retrievers on the CPU.

Three contracts, hardened across every registered first-stage backend:

* **Ragged-shape conformance.**  For query lengths straddling every bucket
  boundary of the default ladder (Tq = 1, 31, 32, 33, 255, 256), the
  server's bucketed/micro-batched answer must carry the top-k ids of a
  direct ``retriever.search()`` of the raw ragged query (scores to
  float-reduction tolerance, rtol 1e-5 / atol 1e-6: a padded query sums
  its tokens in another order), and the ladder padding itself must be a
  no-op on the ids.  On the CPU the ids are equal at every boundary; on the
  card ``tests/test_torch_cuda.py`` holds them the same way.
* **Queue semantics.**  Random interleavings of ``submit``/``add`` never
  drop, duplicate, or cross-wire a request id, and queries submitted after
  an ``add`` see the new docs (FIFO barrier).  Runs as a deterministic
  grid everywhere plus a hypothesis sweep when installed
  (tests/_hypothesis_compat.py).
* **Compile bound.**  100 random request shapes churn through the server
  without the served-shape accounting ever exceeding the bucket-ladder
  bound (``trace_count()`` / ``trace_shapes()``).

The corpus is ``tiny_corpus`` (the port's ``make_corpus`` with the
conftest's arguments: the same numpy draws).  This file imports no JAX.
Every blocking wait carries an explicit timeout so a deadlocked
micro-batcher fails the test instead of hanging the suite.
"""
import concurrent.futures as cf
import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as tdist
from torch.distributed.device_mesh import init_device_mesh

from _hypothesis_compat import given, settings, st
from repro_torch.anns import registry
from repro_torch.core.config import LemurConfig
from repro_torch.data import synthetic
from repro_torch.retriever import IVFBackendConfig, LemurRetriever, SearchParams
from repro_torch.serving import BucketLadder, RetrieverServer, pad_single

BACKENDS = registry.list_backends()
BOUNDARY_TQ = (1, 31, 32, 33, 255, 256)   # straddles every default rung
TIMEOUT = 120.0                            # deadlock guard on every wait


def gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module")
def tiny_corpus():
    return synthetic.make_corpus(m=300, d=16, avg_tokens=8, max_tokens=12,
                                 n_centers=24, seed=0)


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
def base(tiny_corpus):
    cfg = LemurConfig(d=16, d_prime=32, m_pretrain=128, n_train=1024,
                      n_ols=512, epochs=4, k=5, k_prime=60, anns="bruteforce")
    return LemurRetriever.build(tiny_corpus, cfg, generator=gen(0), device="cpu")


def _ragged_query(tq: int, d: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((tq, d)).astype(np.float32)
    return q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-9)


def _direct(r, q: np.ndarray, params):
    s, ids = r.search(q[None], np.ones((1, q.shape[0]), bool), params)
    return s[0].numpy(), ids[0].numpy()


# --------------------------------------------------------------------------
# ragged-shape conformance grid: backend x quantization x bucket boundaries
# --------------------------------------------------------------------------

def _conformance(r, params=None):
    """Server answers == direct facade answers at every bucket boundary,
    and the bucket padding itself is id-preserving."""
    ladder = BucketLadder()  # the default 32/64/128/256 ladder
    serve_r = LemurRetriever(r.index)     # fresh compile cache for the bound
    with RetrieverServer(serve_r, ladder=ladder, max_wait_us=200,
                         default_params=params) as srv:
        for tq in BOUNDARY_TQ:
            q = _ragged_query(tq, r.cfg.d, seed=tq)
            want_s, want_i = _direct(r, q, params)
            got_s, got_i = srv.search(q, timeout=TIMEOUT)
            assert np.array_equal(got_i, want_i), f"Tq={tq}: ids diverged"
            np.testing.assert_allclose(got_s, want_s, rtol=1e-5, atol=1e-6,
                                       err_msg=f"Tq={tq}")
            # pad-mask correctness, independent of the server: the padded
            # rows (zero vectors, False mask) must be exact no-ops
            qp, mp = pad_single(q, np.ones(tq, bool), ladder.tq_bucket(tq))
            s_pad, i_pad = r.search(qp[None], mp[None], params)
            assert np.array_equal(i_pad[0].numpy(), want_i), \
                f"Tq={tq}: padded rows leaked into the result"
        # 6 boundary lengths fold into 3 ladder rungs -> <= bound compiles
        assert srv.trace_count() <= ladder.compile_bound(1)
        assert len(srv.trace_shapes()) <= ladder.compile_bound(1)


@pytest.mark.parametrize("name", BACKENDS)
def test_server_matches_direct_search_fp32(name, base):
    _conformance(base.with_backend(name, generator=gen(1)))


def test_server_matches_direct_search_sq8(base):
    """SQ8 first-stage state (cfg.ivf.sq8): same conformance contract."""
    cfg = base.cfg.replace(anns="ivf", ivf=IVFBackendConfig(sq8=True))
    _conformance(base.with_backend("ivf", generator=gen(1), cfg=cfg))


def test_server_matches_sharded_direct_search(base, mesh):
    """The server over a 1-rank ShardedLemurRetriever (a gloo group; fp32
    AND SQ8 resident corpus): bucketed answers == direct sharded search."""
    params = SearchParams(use_ann=False)
    for sq8 in (False, True):
        sr = base.shard(mesh, sq8=sq8)        # served instance
        sr_ref = base.shard(mesh, sq8=sq8)    # direct reference (own cache)
        ladder = BucketLadder((32, 64), max_batch=2)
        with RetrieverServer(sr, ladder=ladder, max_wait_us=200,
                             default_params=params) as srv:
            for tq in (1, 31, 33):
                q = _ragged_query(tq, base.cfg.d, seed=tq)
                want_s, want_i = _direct(sr_ref, q, params)
                got_s, got_i = srv.search(q, timeout=TIMEOUT)
                assert np.array_equal(got_i, want_i), (sq8, tq)
                np.testing.assert_allclose(got_s, want_s, rtol=1e-5,
                                           atol=1e-6)
            assert srv.trace_count() <= ladder.compile_bound(1)


def test_micro_batcher_coalesces_inflight_requests(base):
    """Requests sharing a bucket coalesce into one micro-batch (occupancy
    > 1) and every future still gets its own row."""
    r = LemurRetriever(base.index)
    ladder = BucketLadder((16,), max_batch=8)
    with RetrieverServer(r, ladder=ladder, max_wait_us=300_000) as srv:
        qs = [_ragged_query(5 + i, base.cfg.d, seed=i) for i in range(8)]
        futs = [srv.submit(q) for q in qs]
        outs = [f.result(timeout=TIMEOUT) for f in futs]
    summary = srv.stats.summary()
    assert summary["n_requests"] == 8
    assert summary["n_batches"] < 8, "micro-batcher never coalesced"
    assert max(summary["occupancy_hist"]) > 1
    for q, (s, ids) in zip(qs, outs):
        assert np.array_equal(ids, _direct(base, q, None)[1])


# --------------------------------------------------------------------------
# queue semantics: submit/add interleavings (deterministic + hypothesis)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small(tiny_corpus):
    """A tiny, fast-to-grow retriever for the interleaving property."""
    import dataclasses as dc

    sub = dc.replace(tiny_corpus,
                     doc_tokens=tiny_corpus.doc_tokens[:60],
                     doc_mask=tiny_corpus.doc_mask[:60],
                     topics=tiny_corpus.topics[:60])
    cfg = LemurConfig(d=16, d_prime=32, m_pretrain=48, n_train=512, n_ols=256,
                      epochs=3, k=3, k_prime=512, anns="bruteforce")
    return LemurRetriever.build(sub, cfg, generator=gen(0), device="cpu"), sub


def check_interleaving(small, seed: int, n_ops: int = 24,
                       p_add: float = 0.25):
    """Random submit/add interleaving invariants: every request id resolves
    exactly once, to ITS OWN query's answer (each query is the exact token
    set of a distinct known doc, so MaxSim top-1 must be that doc), and
    queries targeting docs added earlier in the stream always find them
    (FIFO barrier visibility)."""
    built, sub = small
    r = LemurRetriever(built.index)       # fresh wrapper: adds stay local
    # adds draw from a DISJOINT pool, so every query target is unambiguous
    addpool = synthetic.make_corpus(m=16, d=16, avg_tokens=8, max_tokens=12,
                                    n_centers=24, seed=900 + seed)
    rng = np.random.default_rng(seed)
    # k' (512) clamps to the (grown) corpus per the backend contract
    params = SearchParams(k_prime=512)
    expected: list[tuple[object, int]] = []   # (future, expected top-1 id)
    adds = []
    n_added = 0
    ladder = BucketLadder((8, 16), max_batch=4)
    with RetrieverServer(r, ladder=ladder, max_wait_us=300,
                         default_params=params) as srv:
        for _ in range(n_ops):
            roll = rng.random()
            if roll < p_add and n_added < addpool.m:
                # grow by one pool doc: its id becomes 60 + n_added
                adds.append(srv.add(addpool.doc_tokens[n_added:n_added + 1],
                                    addpool.doc_mask[n_added:n_added + 1]))
                n_added += 1
            elif roll < 0.6 or n_added == 0:
                j = int(rng.integers(0, 60))
                q = sub.doc_tokens[j][sub.doc_mask[j]]
                expected.append((srv.submit(np.asarray(q)), j))
            else:
                # target a doc whose add is already enqueued: the FIFO
                # barrier guarantees this query sees it
                a = int(rng.integers(0, n_added))
                q = addpool.doc_tokens[a][addpool.doc_mask[a]]
                expected.append((srv.submit(np.asarray(q)), 60 + a))
        for fut in adds:   # every enqueued add must land
            assert fut.result(timeout=TIMEOUT) <= 60 + n_added
        # snapshot hook: a query after the last add is answered by the
        # fully-grown snapshot (facade.version bumps once per add)
        tail = srv.submit(np.asarray(sub.doc_tokens[0][sub.doc_mask[0]]))
        tail.result(timeout=TIMEOUT)
        assert tail.snapshot_version == n_added
    assert r.m == 60 + n_added
    rids = [f.request_id for f, _ in expected]
    assert len(set(rids)) == len(rids), "duplicate request ids"
    for fut, j in expected:
        assert fut.done(), f"request {fut.request_id} dropped"
        s, ids = fut.result(timeout=0)
        assert ids[0] == j, (
            f"request {fut.request_id} cross-wired: top-1 {ids[0]} != {j}")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_submit_add_interleaving_grid(small, seed):
    check_interleaving(small, seed)


@settings(deadline=None, max_examples=5)
@given(seed=st.integers(10, 200))
def test_submit_add_interleaving_random(small, seed):
    check_interleaving(small, seed, n_ops=16)


# --------------------------------------------------------------------------
# compile-bound regression: 100 random shapes never exceed the ladder bound
# --------------------------------------------------------------------------

def _shape_churn(r, ladder: BucketLadder, tqs, expect_param_sets: int = 1):
    with RetrieverServer(r, ladder=ladder, max_wait_us=100) as srv:
        futs = [srv.submit(_ragged_query(tq, r.cfg.d, seed=i))
                for i, tq in enumerate(tqs)]
        for f in futs:
            f.result(timeout=TIMEOUT)
        bound = ladder.compile_bound(expect_param_sets)
        assert srv.trace_count() <= bound, (
            f"{srv.trace_count()} traces > ladder bound {bound}: "
            f"{srv.trace_shapes()}")
        assert len(srv.trace_shapes()) <= bound
        for shape, n in srv.trace_shapes().items():
            assert n == 1, f"shape {shape} retraced {n}x"
            assert shape[1] in ladder.tq_ladder, f"off-ladder Tq in {shape}"
            assert shape[0] in ladder.batch_sizes(), f"off-ladder B in {shape}"


def test_trace_count_bounded_under_shape_churn(base):
    """100 random request shapes; the compiled-fn cache must stay within
    the bucket-ladder bound (the tentpole's compile-bound contract)."""
    rng = np.random.default_rng(42)
    tqs = [int(t) for t in rng.integers(1, 33, size=100)]
    _shape_churn(LemurRetriever(base.index), BucketLadder((8, 16, 32), 4), tqs)


@settings(deadline=None, max_examples=3)
@given(seed=st.integers(0, 100))
def test_trace_count_bounded_random(base, seed):
    rng = np.random.default_rng(seed)
    tqs = [int(t) for t in rng.integers(1, 33, size=40)]
    _shape_churn(LemurRetriever(base.index), BucketLadder((8, 16, 32), 4), tqs)


# --------------------------------------------------------------------------
# ladder unit behaviour
# --------------------------------------------------------------------------

def test_bucket_ladder_policy():
    ladder = BucketLadder((8, 16, 32), max_batch=6)   # rounds up to 8
    assert ladder.max_batch == 8
    assert ladder.batch_sizes() == (1, 2, 4, 8)
    assert [ladder.tq_bucket(t) for t in (1, 8, 9, 16, 17, 32)] == \
        [8, 8, 16, 16, 32, 32]
    assert ladder.tq_bucket(33) == 64                 # overflow: next pow2
    assert [ladder.batch_bucket(n) for n in (1, 2, 3, 5, 9)] == [1, 2, 4, 8, 8]
    assert ladder.compile_bound() == 12
    assert ladder.compile_bound(3) == 36
    with pytest.raises(ValueError):
        BucketLadder((16, 8))
    with pytest.raises(ValueError):
        BucketLadder(())
    q, qm, n_real = ladder.pad_batch(
        [np.ones((3, 4), np.float32), np.ones((10, 4), np.float32)],
        [np.ones(3, bool), np.ones(10, bool)])
    assert q.shape == (2, 16, 4) and qm.shape == (2, 16) and n_real == 2
    assert not qm[0, 3:].any() and not qm[1, 10:].any()
    assert (q[0, 3:] == 0).all()


def test_stop_drain_flushes_pending_add_before_queued_searches(base):
    """The drain ordering guarantee: pending ``add()`` barriers are flushed
    BEFORE the remaining queued searches are served, so drained results
    reflect the final snapshot version — a fleet replica being drained must
    not answer from a stale corpus it already accepted growth for."""
    r = LemurRetriever(base.index)
    grow = synthetic.make_corpus(m=4, d=16, avg_tokens=8, max_tokens=12,
                                 n_centers=24, seed=321)
    srv = RetrieverServer(r, ladder=BucketLadder((8, 16), 2),
                          max_wait_us=200).start()
    try:
        srv.search(_ragged_query(6, base.cfg.d, seed=0), timeout=TIMEOUT)  # warm
        # wedge the worker, then queue a search BEFORE the add: FIFO alone would
        # serve it against the old snapshot, the drain guarantee must not
        srv.pause()
        q = np.asarray(grow.doc_tokens[0][grow.doc_mask[0]])
        params = SearchParams(use_ann=False, k_prime=base.m + 4)
        sf = srv.submit(q, params=params)
        af = srv.add(grow.doc_tokens, grow.doc_mask)
        assert not srv.stop(drain=True, timeout=0.2), "drained through the pause"
        srv.resume()
        assert srv.stop(drain=True, timeout=TIMEOUT)
        assert af.result(timeout=0) == base.m + 4
        assert af.snapshot_version == 1
        s, ids = sf.result(timeout=0)
        assert sf.snapshot_version == 1, (
            "drained search answered from the pre-add snapshot")
        assert ids[0] == base.m, "drained search cannot see the flushed add"
    finally:
        srv.stop(drain=False, timeout=TIMEOUT)


class _StallingSubmit:
    """Replay proxy inducing a submit-side stall: open-loop arrivals back up
    behind a slow submitter, the classic coordinated-omission trap."""

    def __init__(self, server, stall_s: float):
        self._server = server
        self._stall_s = stall_s

    def submit(self, *a, **kw):
        import time

        time.sleep(self._stall_s)
        return self._server.submit(*a, **kw)

    def __getattr__(self, name):
        return getattr(self._server, name)


def test_replay_latency_measured_from_scheduled_arrival(base):
    """Coordinated-omission regression: under an induced submit stall the
    arrival-relative percentiles (honest) must diverge far above the
    submit-relative twins (optimistic), and nothing may be lost."""
    from repro_torch.serving import replay

    r = LemurRetriever(base.index)
    ladder = BucketLadder((8,), 2)
    with RetrieverServer(r, ladder=ladder, max_wait_us=200) as srv:
        srv.search(_ragged_query(6, base.cfg.d, seed=0), timeout=TIMEOUT)
        queries = [_ragged_query(6, base.cfg.d, seed=i) for i in range(8)]
        arrivals = np.arange(40) * 0.005       # offered: one per 5ms
        stalled = _StallingSubmit(srv, stall_s=0.015)  # drains 10ms/req late
        _, rep = replay(stalled, queries, arrivals, timeout=TIMEOUT)
    assert rep["n_requests"] == 40 and rep["n_lost"] == 0
    # the schedule fell ~10ms further behind per request (~400ms by the
    # tail); submit-relative latency never sees that backlog
    assert rep["p99_ms"] > rep["submit_p99_ms"] + 100, rep
    assert rep["p99_ms"] > 3 * rep["submit_p99_ms"], rep
    assert rep["p50_ms"] > rep["submit_p50_ms"], rep


def test_server_delete_update_fifo_visibility(base):
    """delete()/update() through the server are FIFO barriers like add():
    a search queued BEFORE a delete answers from the pre-delete snapshot,
    one queued after can never surface the tombstoned doc, and an update's
    replacement is immediately retrievable under its NEW id."""
    r = base.clone()
    grow = synthetic.make_corpus(m=4, d=16, avg_tokens=8, max_tokens=12,
                                 n_centers=24, seed=77)
    repl = synthetic.make_corpus(m=1, d=16, avg_tokens=8, max_tokens=12,
                                 n_centers=24, seed=78)
    m0 = base.m
    with RetrieverServer(r, ladder=BucketLadder((8, 16), 2),
                         max_wait_us=200) as srv:
        af = srv.add(grow.doc_tokens, grow.doc_mask)
        assert af.result(timeout=TIMEOUT) == m0 + 4
        ids = np.asarray(af.added_ids)
        full = SearchParams(use_ann=False, k_prime=r.m)
        q0 = np.asarray(grow.doc_tokens[0][grow.doc_mask[0]])
        _, got = srv.search(q0, params=full, timeout=TIMEOUT)
        assert got[0] == ids[0]
        # wedge the worker so the queue orders deterministically:
        # search -> delete -> search, then drain
        srv.pause()
        before = srv.submit(q0, params=full)
        df = srv.delete(ids[:2])
        after = srv.submit(q0, params=full)
        srv.resume()
        assert df.result(timeout=TIMEOUT) == m0 + 2      # n_alive
        assert df.snapshot_version == 2
        _, got = before.result(timeout=TIMEOUT)
        assert got[0] == ids[0] and before.snapshot_version == 1
        _, got = after.result(timeout=TIMEOUT)
        assert ids[0] not in got and after.snapshot_version == 2
        # update: replacement lands under a FRESH slot id, old id is gone
        uf = srv.update([int(ids[2])], repl.doc_tokens, repl.doc_mask)
        new = np.asarray(uf.result(timeout=TIMEOUT))
        assert new.tolist() == [m0 + 4] and uf.snapshot_version == 3
        full2 = SearchParams(use_ann=False, k_prime=r.m)
        q3 = np.asarray(repl.doc_tokens[0][repl.doc_mask[0]])
        _, got = srv.search(q3, params=full2, timeout=TIMEOUT)
        assert got[0] == new[0] and int(ids[2]) not in got
    assert r.m == m0 + 5 and r.n_alive == m0 + 2


def test_residual_store_churn_zero_traces_and_rebuild_parity(tiny_corpus):
    """Mutation churn on the COMPRESSED (residual-codec) tier through the
    live server: once the pool is warm and adds stay in capacity the churn
    issues ZERO new traces (the codec's tables are not part of a served
    shape), every
    mutation bumps the snapshot version by exactly one, and the post-churn
    ids are BIT-identical to a from-scratch compressed rebuild over the
    survivors' pooled tokens with the same codec."""
    from repro_torch.anns.params import ResidualConfig
    from repro_torch.core import pages

    budget = 6
    cfg = LemurConfig(d=16, d_prime=32, m_pretrain=128, n_train=1024,
                      n_ols=512, epochs=3, k=5, k_prime=64, anns="bruteforce",
                      residual=ResidualConfig(enabled=True, bits=4, ncent=64,
                                              kmeans_iters=4,
                                              token_budget=budget))
    r = LemurRetriever.build(tiny_corpus, cfg, generator=gen(0), device="cpu")
    assert r.index.store.residual
    # raw[slot] = the POOLED tokens that slot was encoded from; the rebuild
    # oracle below re-encodes exactly these with the same codec
    ptoks, pmask = pages.pool_tokens(np.asarray(tiny_corpus.doc_tokens),
                                     np.asarray(tiny_corpus.doc_mask), budget)
    raw = {i: (ptoks[i], pmask[i]) for i in range(r.m)}

    def batch(s):
        c = synthetic.make_corpus(m=3, d=16, avg_tokens=8, max_tokens=12,
                                  n_centers=24, seed=800 + s)
        return np.asarray(c.doc_tokens), np.asarray(c.doc_mask)

    def record(ids, toks, mask):
        pt, pm = pages.pool_tokens(toks, mask, budget)
        for j, i in enumerate(np.asarray(ids).tolist()):
            raw[int(i)] = (pt[j], pm[j])

    params = SearchParams(use_ann=False, k=5, k_prime=64)
    q = _ragged_query(7, 16, seed=0)
    with RetrieverServer(r, ladder=BucketLadder((8, 16), 2),
                         max_wait_us=200) as srv:
        # warm-up round: absorbs any one-time pow2 pool growth + compiles
        # the (params, shape) the loop re-issues
        toks, mask = batch(0)
        f = srv.add(toks, mask)
        f.result(timeout=TIMEOUT)
        record(f.added_ids, toks, mask)
        warm = np.asarray(f.added_ids)
        for i in warm.tolist():
            raw.pop(i)
        srv.delete(warm).result(timeout=TIMEOUT)
        srv.search(q, params=params, timeout=TIMEOUT)

        v0, t0 = r.version, srv.trace_count()
        futs, live = [], []
        for step in range(3):
            toks, mask = batch(1 + step)
            fa = srv.add(toks, mask)
            futs.append(fa)
            fa.result(timeout=TIMEOUT)
            ids = np.asarray(fa.added_ids)
            record(ids, toks, mask)
            srv.search(q, params=params, timeout=TIMEOUT)
            raw.pop(int(ids[0]))
            futs.append(srv.delete(ids[:1]))
            if live:
                raw.pop(live[-1])
                fu = srv.update([live.pop()], toks[:1], mask[:1])
                futs.append(fu)
                record(fu.result(timeout=TIMEOUT), toks[:1], mask[:1])
                live.extend(np.asarray(fu.result(timeout=0)).tolist())
            live.extend(ids[1:].tolist())
        for f in futs:
            f.result(timeout=TIMEOUT)
        versions = [f.snapshot_version for f in futs]
        assert versions == list(range(v0 + 1, v0 + len(futs) + 1)), versions
        srv.search(q, params=params, timeout=TIMEOUT)
        assert srv.trace_count() - t0 == 0, (
            f"warm residual-tier churn issued {srv.trace_count() - t0} traces")

    # from-scratch compressed rebuild over the survivors: same pooled
    # tokens, same codec, one-shot from_dense — ids must map bit-identically
    st = r.index.store
    surv = sorted(raw)
    assert len(surv) == r.n_alive
    rt = np.zeros((len(surv), budget, 16), np.float32)
    rm = np.zeros((len(surv), budget), bool)
    for j, i in enumerate(surv):
        t, mk = raw[i]
        rt[j, : mk.sum()] = t[mk]
        rm[j, : mk.sum()] = True
    store2, _ = pages.from_dense(st.W[torch.as_tensor(surv)], torch.as_tensor(rt),
                                 torch.as_tensor(rm), codec=st.codec)
    r2 = LemurRetriever(r.index._replace(store=store2))
    qb = torch.as_tensor(q[None])
    qm = np.ones((1, len(q)), bool)
    _, ids_a = r.search(qb, qm, params)
    _, ids_b = r2.search(qb, qm, params)
    np.testing.assert_array_equal(
        ids_a.numpy(), np.asarray(surv, np.int64)[ids_b.numpy()])


def test_server_stop_without_drain_cancels(base):
    r = LemurRetriever(base.index)
    srv = RetrieverServer(r, ladder=BucketLadder((8,), 2),
                          max_wait_us=500_000).start()
    try:
        futs = [srv.submit(_ragged_query(4, base.cfg.d, seed=i))
                for i in range(6)]
        srv.stop(drain=False, timeout=TIMEOUT)
        states = [("done" if f.done() and not f.cancelled() else
                   "cancelled" if f.cancelled() else "lost") for f in futs]
        assert "lost" not in states, states
        with pytest.raises(RuntimeError):
            srv.submit(_ragged_query(4, base.cfg.d, seed=0))
    finally:
        srv.stop(drain=False, timeout=TIMEOUT)


def test_stop_without_drain_resolves_blocked_mutation_barrier(base,
                                                              tiny_corpus):
    """The no-leak guarantee: a caller already BLOCKED on
    ``add().result(timeout=...)`` when the server is stopped without drain
    observes a typed ``CancelledError`` promptly — every pending mutation
    barrier future (add, delete, update) is cancelled, never leaked — and
    the abandoned mutations were never applied to the retriever."""
    r = LemurRetriever(base.index)
    srv = RetrieverServer(r, ladder=BucketLadder((8,), 2),
                          max_wait_us=500_000).start()
    try:
        srv.pause()                    # wedge the worker: the barriers queue up
        m0, v0 = r.m, r.version
        fa = srv.add(tiny_corpus.doc_tokens[:3], tiny_corpus.doc_mask[:3])
        fd = srv.delete([0])
        fu = srv.update([1], tiny_corpus.doc_tokens[:1],
                        tiny_corpus.doc_mask[:1])
        outcome: dict = {}

        def blocked_caller():
            try:
                outcome["kind"] = ("result", fa.result(timeout=TIMEOUT))
            except cf.CancelledError:
                outcome["kind"] = "cancelled"
            except Exception as e:  # noqa: BLE001 — the test asserts the type
                outcome["kind"] = repr(e)

        th = threading.Thread(target=blocked_caller, daemon=True)
        th.start()
        time.sleep(0.05)               # let the caller actually block
        assert srv.stop(drain=False, timeout=TIMEOUT)
        th.join(timeout=5.0)
        assert not th.is_alive(), "caller blocked on add().result() hung"
        assert outcome["kind"] == "cancelled"
        for f in (fa, fd, fu):
            assert f.done() and f.cancelled(), "mutation barrier future leaked"
        assert r.m == m0 and r.version == v0, "cancelled mutation was applied"
    finally:
        srv.stop(drain=False, timeout=TIMEOUT)

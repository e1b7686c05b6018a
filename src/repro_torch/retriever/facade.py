"""LemurRetriever: build, save, load and serve (twin of
``repro/retriever/facade.py``).

    r = LemurRetriever.build(corpus, cfg, generator=torch.Generator().manual_seed(0))
    scores, ids = r.search(q_tokens, q_mask, SearchParams(k=10))
    r.save("my_index/")                                # the JAX package loads it
    r = LemurRetriever.load("my_index/")               # either package's save
    r.add(new_doc_tokens, new_doc_mask)                # new slots [m, m + n)
    r.delete(r.last_added_ids)                         # tombstones, pages freed
    r.update([3, 7], new_tokens, new_mask)             # delete + add, one version
    r2 = r.with_backend("muvera")                      # same reduction, new first stage
    sr = r.shard(mesh)                                 # torch.distributed DeviceMesh

The build is the JAX build's pipeline: training tokens (§4.2) -> token
MaxSim targets over m' sampled docs (kernel) -> psi pre-training (Adam,
autograd) -> Gram factor (psi kernel) and per-block OLS (kernel) -> the
first stage of ``cfg.anns`` through the backend registry (IVF:
``cfg.ivf.residual_bits`` for residual lists) -> paged store, its docs first
pooled to ``cfg.residual.token_budget`` tokens and, with
``cfg.residual.enabled``, kept in the compressed tier under a codec trained
on them.  Where the JAX build draws with ``jax.random.choice``, the port
draws with ``torch.randperm`` on the caller's CPU ``generator``; the codec
draws last, so ψ, W and the first stage do not depend on the tier.
:meth:`with_backend` builds another first stage over the same ψ, W and
store, reading the store's pages a chunk of docs at a time.

Search routes, as ``SearchParams`` spells them (every one ends in the
tombstone mask and an exact-MaxSim rerank to the top-k):

* ``SearchParams()``, the default: psi-pool (kernel) -> centroid scores ->
  top-nprobe -> SQ8/fp32 probe scan (kernel) -> flat top-k' -> paged
  rerank (kernel);
* ``SearchParams(backend=IVFSearchParams(use_one_launch=True))``: the
  probe-select prelude, then pool + scan + top-k' in one ``query_fused``
  launch;
* ``SearchParams(use_ann=False, use_one_launch=True)``: the exact latent
  scan over W's full slot capacity in the ``mips_topk`` kernel;
  ``SearchParams(use_ann=False)``: the same scan as a blocked plain product;
* ``IVFSearchParams(use_fused_gather=False)``: the legacy gathered IVF scan
  (``mips_sq8`` kernel for SQ8 lists, the plain decode-then-score for
  residual lists); ``SearchParams(use_fused_gather=False)``: the legacy
  gathered rerank (``pages.gather_docs`` + ``maxsim.rerank_gathered``,
  plain).

Residual IVF lists take the same spellings through their own kernels
(``ivf_probe_res_scan``, ``query_fused_res``).  The rerank takes one of
three branches, as the JAX package's: a compressed store with
``use_residual`` (default ``cfg.residual.enabled``) and the fused gather,
the ``rerank_paged_res_scores`` kernel; an fp32 store with the fused
gather, the fp32 kernel (``use_residual`` or not); otherwise the legacy
gathered rerank (on the compressed tier over decoded tokens).  The other
backends (``bruteforce``, ``muvera``, ``dessert``, ``token_pruning``) take
the default spelling and their own params (``TokenPruningSearchParams``):
ψ-pool (kernel) -> the backend's search (plain) -> the same rerank.

**Mutation** is the JAX facade's: ``add`` fits W rows with the build's OLS
solver (or, without one, a solver over OLS tokens drawn from the stored
corpus with an explicit seed), hands the docs to the backend's ``add`` (the
IVF lists: ``ivf.extend_ivf``) and pages them (``pages.add_docs``); ``delete``
tombstones; ``update`` is both under one version; ``install_refresh``
warm-swaps a rebuilt first stage in.  Where JAX swaps immutable arrays, the
port writes in place: a retriever owns the tensors it built, loaded or was
given by :meth:`from_arrays`, and writes them in place, O(new docs); once
:meth:`snapshot` or :meth:`clone` has handed its index out (or the index
came in through the constructor), each tensor is copied the first time a
mutation writes it, so the other view keeps answering its own corpus.

**Threads.**  Where JAX's arrays are immutable and any thread may read
them, the port's mutations write the index in place.  So one thread mutates
a retriever (a server's worker), and the facade holds its :attr:`lock`
across every mutation and across :meth:`snapshot`, :meth:`clone` and
:meth:`with_backend`: a reader on another thread either holds the lock for
a whole reading (the drift monitor does) or takes a :meth:`snapshot` under
it and reads that (the background refresh does), and sees a whole index
between two mutations either way.  Searches on the mutating thread need no
lock.

PyTorch runs eagerly; :meth:`trace_count` counts what JAX's compile cache
would hold: one entry for each distinct (backend, resolved params, query
shape, state shapes) served, so an add within capacity adds nothing and a
bucket growth adds one.
"""
from __future__ import annotations

import pathlib
import threading
import time

import numpy as np
import torch

from repro_torch.anns import registry
from repro_torch.anns.base import CorpusView, QueryBatch, over_store, pad_topk
from repro_torch.anns.bruteforce import mips_topk
from repro_torch.anns.ivf import IVFIndex, search_ivf_one_launch
from repro_torch.anns.quantization import train_residual_codec
from repro_torch.checkpoint import manager as ckpt
from repro_torch.common.device import resolve_device
from repro_torch.convert import FORMAT, index_from_numpy, index_to_numpy
from repro_torch.core import indexer, maxsim, pages
from repro_torch.core.config import LemurConfig
from repro_torch.core.index import LemurIndex, queries_on
from repro_torch.core.model import PSI_LEAVES, Psi, TargetStats, pool_queries, train_phi
from repro_torch.kernels import ops
from repro_torch.retriever.params import SearchParams, effective_nprobe

#: the tensors a mutation writes: of the paged store, of the IVF state (the
#: other backends' ``add`` writes nothing in place)
_STORE_WRITES = ("tok_pages", "page_table", "n_tokens", "W", "alive", "n_docs",
                 "cent_pages", "code_pages")
_ANN_WRITES = ("ids", "vecs", "scales", "counts")


class CorruptIndexError(ValueError):
    """A rebuilt index failed :meth:`LemurRetriever.install_refresh`'s
    validation; the last good index is left installed, untouched.
    ``preserves_replica_state`` tells a serving layer this is a typed
    rejection with the replica intact, not a replica failure."""

    preserves_replica_state = True


class _StageClock:
    """Seconds of each build stage, the device synchronized at each mark."""

    def __init__(self, device: torch.device, verbose: bool):
        self.device, self.verbose = device, verbose
        self.seconds: dict[str, float] = {}
        self._t = time.perf_counter()

    def __call__(self, stage: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.seconds[stage] = now - self._t
        self._t = now
        if self.verbose:
            print(f"[build] {stage} {self.seconds[stage]:.2f} s", flush=True)


def first_stage(index: LemurIndex, q_tokens, q_mask, params: SearchParams):
    """Pool the queries and run the index's backend through the registry,
    or the exact latent scan -> (B, k') candidate ids, tombstoned slots
    masked to -1.  The one-launch IVF route takes the raw tokens, as in the
    JAX package.  ``params`` must be resolved (module docstring: the
    routes)."""
    store = index.store
    if (params.use_ann and index.backend == "ivf"
            and getattr(params.backend, "use_one_launch", False)):
        nprobe = effective_nprobe(params.backend.nprobe, index.ann.nlist)
        _, cand = search_ivf_one_launch(index.ann, index.psi, q_tokens, q_mask,
                                        nprobe, params.k_prime)
        return pages.mask_dead(store, cand)
    psi_q = pool_queries(index.psi, q_tokens, q_mask)           # (B, d')
    if not params.use_ann:
        # over the store's full slot capacity: dead and unallocated slots
        # are masked by the alive bits
        kk = min(params.k_prime, store.W.shape[0])
        if params.use_one_launch:
            top, cand = ops.mips_topk_fused(psi_q, store.W, None, kk, valid=store.alive)
        else:
            top, cand = mips_topk(psi_q, store.W, kk, valid=store.alive)
        return pages.mask_dead(store, pad_topk(top, cand, params.k_prime)[1])
    be = registry.get_backend(index.backend)
    _, cand = be.search(index.ann, QueryBatch(psi_q, q_tokens, q_mask), params.k_prime,
                        params.backend)
    return pages.mask_dead(store, cand)


def search_pipeline(index: LemurIndex, q_tokens, q_mask, params: SearchParams):
    """pool -> first-stage candidates -> exact-MaxSim rerank -> top-k, the
    rerank by the JAX package's three branches (module docstring): the
    compressed paged kernel, the fp32 paged kernel, or the candidates
    gathered (decoded) from the pages and reranked plainly.  ``-1``
    candidates (pads, tombstones) score NEG and never outrank a real one."""
    cand = first_stage(index, q_tokens, q_mask, params)
    st = index.store
    if st.residual and params.use_residual and params.use_fused_gather:
        return ops.fused_rerank_paged_res(q_tokens, q_mask, cand, st.cent_pages,
                                          st.code_pages, st.page_table, st.n_tokens,
                                          st.codec.centroids, st.codec.values, params.k)
    if params.use_fused_gather and not st.residual:
        return ops.fused_rerank_paged(q_tokens, q_mask, cand, st.tok_pages,
                                      st.page_table, st.n_tokens, params.k)
    toks, tmask = pages.gather_docs(st, cand)
    return maxsim.rerank_gathered(q_tokens, q_mask, cand, toks, tmask, params.k)


def launch_plan(resolved: SearchParams) -> dict[str, int]:
    """Per-search launch breakdown, as the JAX package counts it: the
    default route's projection, scan and flat top-k' before the rerank, or
    one launch before it on the one-launch routes (the other backends: the
    default route's plan, as JAX counts them)."""
    one = (getattr(resolved.backend, "use_one_launch", False) if resolved.use_ann
           else resolved.use_one_launch)
    if one:
        return {"one_launch": 1, "rerank": 1}
    return {"projection": 1, "scan": 1, "topk": 1, "rerank": 1}


def _build_over_store(index: LemurIndex, backend: str, cfg: LemurConfig, generator,
                        parts, clock=None):
    """Build ``backend`` over ``index``'s store: its W rows [0, m) and its
    tokens read from the pages a chunk at a time (the JAX ``dense_view``)."""
    be = registry.get_backend(backend)
    view = CorpusView(index.W, None, None, read=index.read_docs)
    ann = be.build(generator, view, cfg.backend_config(backend), parts=parts, clock=clock)
    return over_store(be, ann, index.store)


class LemurRetriever:
    """Builds, serves and mutates a :class:`LemurIndex` (see module
    docstring).  The OLS solver state (Gram factor, features, OLS tokens)
    of a build is kept, and the OLS tokens travel through ``save``/``load``.
    An index handed to the constructor may be held elsewhere, so its
    tensors are copied before a mutation first writes them."""

    def __init__(self, index: LemurIndex, *, solver_state: dict | None = None,
                 x_ols: torch.Tensor | None = None):
        self._index = index
        self._solver = solver_state
        self._x_ols = x_ols if x_ols is not None else (
            solver_state["x_ols"] if solver_state else None)
        self._resolve_memo: dict[SearchParams | None, SearchParams] = {}
        #: stage seconds, epoch losses and steps of :meth:`build`, else None
        self.build_log: dict | None = None
        self._version = 0
        # page allocator: derived from the page table at the first mutation
        self._free_pages: list[int] | None = None
        self._last_added_ids = np.empty((0,), np.int32)
        self._last_mutation_bytes = 0
        self._bytes_moved = 0
        self._last_refresh_caught_up = 0
        # copy on write: the fields another view may hold
        self._shared = {"store": set(_STORE_WRITES), "ann": set(_ANN_WRITES)}
        # compile accounting: the (params, query shape, state shapes) served
        self._served: set = set()
        self._trace_counts: dict[tuple, int] = {}
        self._trace_shapes: dict[tuple, int] = {}
        self._lock = threading.RLock()

    @classmethod
    def _owning(cls, index: LemurIndex, **kw) -> "LemurRetriever":
        """A retriever over tensors nothing else holds: writes in place."""
        r = cls(index, **kw)
        r._shared = {"store": set(), "ann": set()}
        return r

    @property
    def index(self) -> LemurIndex:
        return self._index

    @property
    def lock(self) -> threading.RLock:
        """Held across every mutation and across :meth:`snapshot`,
        :meth:`clone` and :meth:`with_backend` (module docstring: threads).
        A reader on another thread than the mutating one holds it for a
        whole reading, or reads a snapshot taken under it."""
        return self._lock

    @property
    def cfg(self) -> LemurConfig:
        return self._index.cfg

    @property
    def backend(self) -> str:
        return self._index.backend

    @property
    def m(self) -> int:
        return self._index.m

    @property
    def n_alive(self) -> int:
        return self._index.n_alive

    @property
    def device(self) -> torch.device:
        return self._index.device

    @property
    def solver_state(self) -> dict | None:
        return self._solver

    @property
    def x_ols(self) -> torch.Tensor | None:
        return self._x_ols

    @property
    def version(self) -> int:
        """Snapshot version: one more for every add, delete, update and
        installed refresh (an update counts once)."""
        return self._version

    @property
    def last_added_ids(self) -> np.ndarray:
        """Slot ids of the most recent :meth:`add` / :meth:`update`."""
        return self._last_added_ids

    @property
    def last_mutation_bytes(self) -> int:
        """Logical bytes the most recent mutation wrote (its pages, its
        table, count and W rows, and any bucket growth), as JAX counts
        them."""
        return self._last_mutation_bytes

    @property
    def bytes_moved(self) -> int:
        """Logical mutation bytes since construction."""
        return self._bytes_moved

    def snapshot(self) -> LemurIndex:
        """The current index, which later mutations of this retriever never
        change: each tensor they write is copied first."""
        with self._lock:
            self._share_all()
            return self._index

    def _share_all(self) -> None:
        self._shared = {"store": set(_STORE_WRITES), "ann": set(_ANN_WRITES)}

    def __repr__(self) -> str:
        return (f"LemurRetriever(m={self.m}, d_prime={self.cfg.d_prime}, "
                f"backend={self.backend!r}, device={self.device})")

    @classmethod
    def build(cls, corpus, cfg: LemurConfig | None = None, *,
              generator: torch.Generator | None = None, x_train=None,
              device="cuda", verbose: bool = False) -> "LemurRetriever":
        """Full offline build on ``device`` (see module docstring).
        ``corpus`` has ``doc_tokens`` (m, T, d) and ``doc_mask`` (m, T),
        numpy or tensors; the dense corpus is held on the device, as the JAX
        build holds it.  ``generator`` (CPU; default seed 0) draws the
        pre-training docs, psi's init and permutations, the OLS tokens,
        k-means' sample and, last, the token codec's sample and k-means;
        ``x_train`` replaces the selected training tokens.  Records
        :attr:`build_log`."""
        cfg = cfg or LemurConfig()
        backend = registry.canonical(cfg.anns)
        be = registry.get_backend(backend)
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        clock = _StageClock(dev, verbose)
        doc_tokens = torch.as_tensor(corpus.doc_tokens).to(
            device=dev, dtype=torch.float32).contiguous()
        doc_mask = torch.as_tensor(corpus.doc_mask).to(device=dev, dtype=torch.bool).contiguous()
        m = doc_tokens.shape[0]

        # 1. training tokens (§4.2)
        if x_train is None:
            x_train = indexer.make_training_tokens(corpus, cfg, seed=0)
        x_train = torch.as_tensor(x_train, dtype=torch.float32).to(dev).contiguous()
        clock("tokens")

        # 2. psi pre-training against m' sampled documents (§4.3)
        pre = torch.randperm(m, generator=gen)[:min(cfg.m_pretrain, m)].to(dev)
        g_pre = maxsim.token_maxsim(x_train, doc_tokens[pre], doc_mask[pre])
        clock("g_pre")
        params, stats, losses = train_phi(x_train, g_pre, cfg, generator=gen)
        del g_pre
        psi = Psi.from_arrays(*(params[k] for k in PSI_LEAVES), device=dev)
        clock("train_phi")

        # 3. OLS output layer over the full corpus (eq. 7); the solver state
        # is kept for incremental indexing
        n = x_train.shape[0]
        x_ols = x_train[torch.randperm(n, generator=gen)[:min(cfg.n_ols, n)].to(dev)]
        solver = indexer.ols_solver_state(psi, x_ols, cfg)
        clock("gram")
        W = indexer.fit_output_layer_ols(psi, x_ols, doc_tokens, doc_mask, cfg,
                                         stats, solver_state=solver)
        clock("ols")

        # 4. first stage, through the backend registry
        ann = be.build(gen, CorpusView(W, doc_tokens, doc_mask), cfg.backend_config(backend),
                       clock=clock)
        clock(backend)

        # 5. paged store: the docs pooled to a token budget and / or kept in
        # the compressed tier (cfg.residual); psi, W and the first stage above
        # always see the raw tokens
        rcfg = cfg.residual
        st_tokens, st_mask, codec = doc_tokens, doc_mask, None
        if rcfg.token_budget > 0:
            pooled, pmask = pages.pool_tokens(doc_tokens, doc_mask, rcfg.token_budget)
            st_tokens = torch.from_numpy(pooled).to(dev)
            st_mask = torch.from_numpy(pmask).to(dev)
        if rcfg.enabled:
            codec = train_residual_codec(gen, st_tokens[st_mask], bits=rcfg.bits,
                                         ncent=rcfg.ncent, iters=rcfg.kmeans_iters,
                                         sample=rcfg.train_sample)
            clock("codec")
        index = LemurIndex.from_dense(cfg, psi, stats, W, st_tokens, st_mask, backend, ann,
                                      codec=codec)
        index = index._replace(ann=over_store(be, index.ann, index.store))
        clock("pages")
        r = cls._owning(index, solver_state=solver)
        r.build_log = {"seconds": clock.seconds, "losses": losses,
                       "steps": cfg.epochs * max(1, n // cfg.batch_size)}
        return r

    def save(self, directory) -> pathlib.Path:
        """Write a ``lemur-retriever-v1`` checkpoint (step 0) in the JAX
        layout: cfg, psi, target stats, the paged store, the first stage's
        packed state (its ``pack_state``) and the OLS tokens when kept.
        Returns the committed step directory."""
        tree, extra = index_to_numpy(self._index, self._x_ols)
        return ckpt.save(directory, 0, tree, extra)

    @classmethod
    def load(cls, directory, *, step: int | None = None,
             device="cuda") -> "LemurRetriever":
        """Serve a ``lemur-retriever-v1`` checkpoint saved by either
        package's ``LemurRetriever.save``; ``solver/x_ols`` is kept when
        present.  A legacy dense checkpoint (``W``, ``doc_tokens``,
        ``doc_mask``) is paged on load, as JAX migrates it.  A JAX-saved
        MUVERA checkpoint, which lacks the projections, raises
        ``ValueError`` (``convert.muvera_from_numpy``)."""
        dev = resolve_device(device)
        tree, manifest = ckpt.restore(pathlib.Path(directory), step)
        extra = manifest.get("extra", {})
        if extra.get("format") != FORMAT:
            raise ValueError(f"{directory} is not a {FORMAT} checkpoint "
                             f"(format={extra.get('format')!r})")
        x_ols = tree.get("solver/x_ols")
        if x_ols is not None:
            x_ols = torch.tensor(x_ols, device=dev)
        return cls._owning(index_from_numpy(tree, extra, dev), x_ols=x_ols)

    @classmethod
    def from_arrays(cls, cfg: LemurConfig, psi: Psi, store: pages.PagedStore, *,
                    generator: torch.Generator | None = None) -> "LemurRetriever":
        """Serve a psi and a filled paged store (either tier): the first
        stage of ``cfg.anns`` is built over the store (the IVF over its W
        rows: ``cfg.ivf``'s nlist, SQ8, residual bits), its draws seeded by
        ``generator``.  Target stats are the identity (mean 0, std 1).  The
        retriever takes the store over: its mutations write into it in
        place."""
        one = torch.ones((), device=store.W.device)
        index = LemurIndex(cfg, psi, TargetStats(0 * one, one), store,
                           registry.canonical(cfg.anns), None)
        return cls._owning(index._replace(ann=_build_over_store(index, index.backend, cfg,
                                                                generator, None)))

    def with_backend(self, backend: str, *, generator: torch.Generator | None = None,
                     cfg: LemurConfig | None = None, parts: dict | None = None
                     ) -> "LemurRetriever":
        """A new retriever over the same ψ, W and paged store (shared, never
        re-trained) with another first-stage backend, built from the store's
        W rows and its pages, read a chunk of docs at a time (decoded on the
        compressed tier, deleted slots all-masked), never the whole dense
        corpus.  ``cfg`` (default this retriever's) gives the backend's
        namespace; ``generator`` (CPU; default seed 0) draws its random
        parts, or ``parts`` (``{name: tensor}`` by the names of its
        ``pack_state``: MUVERA's ``hyper``/``final``/``proj``, DESSERT's
        ``hyper``, token pruning's and IVF's ``centroids``) supplies them.
        The new retriever shares the store: each side copies a tensor before
        its first write to it.  Its :attr:`build_log` holds the stage seconds
        (the backend's own stages, then the backend's name for the rest)."""
        backend = registry.canonical(backend)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        clock = _StageClock(self.device, False)
        with self._lock:
            idx = self._index
            cfg = cfg or idx.cfg
            ann = _build_over_store(idx, backend, cfg, gen, parts, clock)
            clock(backend)
            index = idx._replace(cfg=cfg.replace(anns=backend), backend=backend, ann=ann)
            r = LemurRetriever(index, solver_state=self._solver, x_ols=self._x_ols)
            self._share_all()
        r._shared["ann"] = set()     # its first-stage state is its own
        r.build_log = {"seconds": clock.seconds}
        return r

    def resolve(self, params: SearchParams | None = None) -> SearchParams:
        """Fill a (possibly partial) SearchParams from the build config
        (memoized)."""
        resolved = self._resolve_memo.get(params)
        if resolved is None:
            resolved = (params or SearchParams()).resolve(self.cfg, self.backend)
            self._resolve_memo[params] = resolved
        return resolved

    def shard(self, mesh, *, sq8: bool | None = None, k_prime_local: int | None = None):
        """Corpus-sharded serving over a ``torch.distributed`` DeviceMesh: a
        :class:`~repro_torch.retriever.sharded.ShardedLemurRetriever` holding
        this rank's block of the corpus (every mesh axis shards it).  Call
        it on every rank with the same retriever, on the mesh's device type.
        ``sq8`` keeps the block as SQ8 codes (default ``cfg.ivf.sq8``);
        ``k_prime_local`` is the per-shard candidate budget (default
        ``dist.default_k_prime_local``: a 4x oversample of k' / n_shards)."""
        from repro_torch.retriever.sharded import ShardedLemurRetriever

        return ShardedLemurRetriever(self, mesh, sq8=sq8, k_prime_local=k_prime_local)

    def launches(self, params: SearchParams | None = None) -> dict[str, int]:
        return launch_plan(self.resolve(params))

    @torch.inference_mode()
    def search(self, q_tokens, q_mask=None, params: SearchParams | None = None):
        """q_tokens: (B, Tq, d) -> (scores (B, k) fp32, doc ids (B, k) int32),
        on the index's device; q_mask (B, Tq) defaults to all tokens."""
        q_tokens, q_mask = queries_on(self._index, q_tokens, q_mask)
        resolved = self.resolve(params)
        self._account(resolved, q_tokens)
        return search_pipeline(self._index, q_tokens, q_mask, resolved)

    @torch.inference_mode()
    def candidates(self, q_tokens, q_mask=None, params: SearchParams | None = None):
        """First-stage candidate ids only, (B, k') int32, tombstones -1."""
        q_tokens, q_mask = queries_on(self._index, q_tokens, q_mask)
        return first_stage(self._index, q_tokens, q_mask, self.resolve(params))

    # -- compile accounting -------------------------------------------------

    def _account(self, resolved: SearchParams, q: torch.Tensor) -> None:
        """Count a (params, query shape, state shapes) not served before: the
        entry JAX's jit cache would add.  Exact-scan params leave the
        backend state out, as JAX leaves it out of their arguments; a
        backend's meta (token pruning's m) is static in JAX, so it counts."""
        key = (self.backend, resolved)
        idx = self._index
        state = tuple(tuple(t.shape) for t in idx.store if isinstance(t, torch.Tensor))
        if resolved.use_ann:
            arrays, meta = registry.get_backend(idx.backend).pack_state(idx.ann)
            state += tuple((k, tuple(t.shape)) for k, t in arrays.items())
            state += (repr(sorted(meta.items())),)
        sig = (key, tuple(q.shape), state)
        if sig in self._served:
            return
        self._served.add(sig)
        self._trace_counts[key] = self._trace_counts.get(key, 0) + 1
        skey = key + (tuple(q.shape),)
        self._trace_shapes[skey] = self._trace_shapes.get(skey, 0) + 1

    def trace_count(self, params: SearchParams | None = None) -> int:
        """Compile-cache entries so far (module docstring): for one resolved
        SearchParams, or in total."""
        if params is None:
            return sum(self._trace_counts.values())
        return self._trace_counts.get((self.backend, self.resolve(params)), 0)

    def trace_shapes(self) -> dict[tuple, int]:
        """``{(B, Tq, d): entries}`` over every params."""
        out: dict[tuple, int] = {}
        for (*_, shape), n in self._trace_shapes.items():
            out[shape] = out.get(shape, 0) + n
        return out

    # -- mutation -------------------------------------------------------------

    @torch.no_grad()
    def add(self, doc_tokens, doc_mask, *, seed: int = 0) -> "LemurRetriever":
        """Grow the corpus: W rows from the frozen-psi OLS solver (the build's,
        else one rebuilt from the kept OLS tokens, else the fallback seeded
        by ``seed``), the docs handed to the first stage's ``add`` (the IVF
        lists: appended in place), and paged into slots
        ``[m, m + n)`` (in :attr:`last_added_ids`).  Returns this retriever."""
        with self._lock:
            self._mutate_add(doc_tokens, doc_mask, seed)
            self._version += 1
        return self

    @torch.no_grad()
    def delete(self, doc_ids) -> "LemurRetriever":
        """Tombstone docs and free their pages; surviving ids are unchanged,
        the first stage is not rebuilt (``pages.mask_dead`` masks its stale
        ids after every first stage).  Raises ``ValueError`` on duplicate,
        unknown or already-deleted ids.  Returns this retriever."""
        with self._lock:
            self._mutate_delete(doc_ids)
            self._version += 1
        return self

    @torch.no_grad()
    def update(self, doc_ids, doc_tokens, doc_mask, *, seed: int = 0) -> np.ndarray:
        """Replace docs: delete ``doc_ids`` and add the new contents under one
        version.  Returns the new slot ids (an updated doc is a new doc)."""
        with self._lock:
            self._mutate_delete(doc_ids)
            ids = self._mutate_add(doc_tokens, doc_mask, seed)
            self._version += 1
        return ids

    def _free(self) -> list[int]:
        if self._free_pages is None:
            self._free_pages = pages.free_list(self._index.store)
        return self._free_pages

    def _mutate_add(self, doc_tokens, doc_mask, seed: int) -> np.ndarray:
        idx = self._index
        dev = self.device
        doc_tokens = torch.as_tensor(doc_tokens, dtype=torch.float32).to(dev)
        doc_mask = torch.as_tensor(doc_mask).to(device=dev, dtype=torch.bool)
        solver = self._ensure_solver(seed)
        w_new = indexer.fit_docs(solver, doc_tokens, doc_mask, idx.stats)
        be = registry.get_backend(idx.backend)
        ann = idx.ann
        if getattr(be, "view", None) is None:     # a view of W follows the store below
            ann = be.add(ann, CorpusView(w_new, doc_tokens, doc_mask),
                         shared=self._shared["ann"])
        # as in build: W and the first stage see the raw tokens, the store the pooled
        budget = int(idx.cfg.residual.token_budget)
        if budget > 0:
            doc_tokens, doc_mask = pages.pool_tokens(doc_tokens, doc_mask, budget)
        store, free, ids, moved = pages.add_docs(idx.store, self._free(), w_new, doc_tokens,
                                                 doc_mask, shared=self._shared["store"])
        self._free_pages = free
        self._index = idx._replace(store=store, ann=over_store(be, ann, store))
        self._last_added_ids = ids
        self._last_mutation_bytes = moved
        self._bytes_moved += moved
        return ids

    def _mutate_delete(self, doc_ids) -> None:
        idx = self._index
        store, free, moved = pages.delete_docs(idx.store, self._free(), doc_ids,
                                               shared=self._shared["store"])
        self._free_pages = free
        be = registry.get_backend(idx.backend)
        self._index = idx._replace(store=store, ann=over_store(be, idx.ann, store))
        self._last_mutation_bytes = moved
        self._bytes_moved += moved

    def _ensure_solver(self, seed: int) -> dict:
        if self._solver is not None:
            return self._solver
        idx = self._index
        if self._x_ols is not None:
            # the kept OLS tokens: the Gram factor rebuilt deterministically
            self._solver = indexer.ols_solver_state(idx.psi, self._x_ols, idx.cfg)
            return self._solver
        # fallback: OLS tokens drawn from the stored corpus, seeded.  JAX
        # draws positions in its dense view's valid tokens, in slot order;
        # the same positions are found through the token counts and read
        # through the page table, without the dense layout
        st = idx.store
        nt = st.n_tokens[: idx.m].long()
        ends = torch.cumsum(nt, 0)
        total = int(ends[-1]) if len(ends) else 0
        pick = np.random.default_rng(seed).integers(0, total, size=min(idx.cfg.n_ols, total))
        pos = torch.as_tensor(pick, device=nt.device)
        slot = torch.searchsorted(ends, pos, right=True)
        x = pages.read_tokens(st, slot, pos - (ends - nt)[slot])
        self._solver = indexer.ols_solver_state(idx.psi, x.contiguous(), idx.cfg)
        return self._solver

    def clone(self) -> "LemurRetriever":
        """An independent replica over the same built state, with no re-train
        or re-build: the index and the OLS solver are shared, and each side
        copies a tensor before its first write to it; ``version`` is carried
        over.  The same ``add`` on every clone gives the same W rows."""
        with self._lock:
            r = LemurRetriever(self._index, solver_state=self._solver, x_ols=self._x_ols)
            r._version = self._version
            self._share_all()
        return r

    @torch.no_grad()
    def install_refresh(self, refresh) -> "LemurRetriever":
        """Warm-swap a background rebuild in (``refresh``: ``backend``,
        ``m0``, ``W``, ``solver``, ``ann``; ``convert.refresh_from_numpy``
        makes one from a JAX ``lifecycle.build_refresh`` result).

        1. Validate, before anything is touched: the backend, m0 in (0, m],
           W's shape and finiteness, the solver's keys and a finite Gram
           factor, and, for a latent backend, a probe search through the
           rebuilt first stage whose ids must lie in [0, m0).  A failure
           raises :class:`CorruptIndexError` and leaves this retriever as it
           was.
        2. Catch up the slots added since the rebuild ([m0, m)): their W rows
           fit with the new solver (dead slots as zero rows) and handed, with
           their tokens, to the backend's ``add`` in slot order; rebuilt rows
           deleted meanwhile are zeroed.  The refresh's own tensors are never
           written.
        3. Swap the index in, one version more.  Returns this retriever."""
        with self._lock:
            self._install_refresh(refresh)
        return self

    def _install_refresh(self, refresh) -> None:
        idx = self._index
        dev = self.device

        def bad(msg: str) -> CorruptIndexError:
            return CorruptIndexError(f"install_refresh rejected: {msg}")

        if getattr(refresh, "backend", None) != idx.backend:
            raise bad(f"backend {getattr(refresh, 'backend', None)!r} != {idx.backend!r}")
        m_now = self.m
        m0 = int(refresh.m0)
        if not 0 < m0 <= m_now:
            raise bad(f"m0={m0} outside (0, {m_now}]")
        W_new = torch.as_tensor(refresh.W).to(dev)
        if tuple(W_new.shape) != (m0, idx.cfg.d_prime):
            raise bad(f"W shape {tuple(W_new.shape)} != {(m0, idx.cfg.d_prime)}")
        if not bool(torch.isfinite(W_new).all()):
            raise bad("non-finite values in refit W")
        solver = refresh.solver
        if not (isinstance(solver, dict) and {"chol", "feats", "x_ols"} <= set(solver)):
            raise bad("solver state missing chol/feats/x_ols")
        if not bool(torch.isfinite(torch.as_tensor(solver["chol"])).all()):
            raise bad("non-finite OLS Gram factor")
        be = registry.get_backend(idx.backend)
        if be.representation == "latent":
            try:
                _, cand = be.search(refresh.ann, QueryBatch(W_new[:1].float(), None, None),
                                    min(8, m0),
                                    be.default_params(idx.cfg.backend_config(idx.backend)))
            except Exception as e:
                raise bad(f"probe search through rebuilt backend failed: {e}") from e
            if cand.numel() == 0 or bool((cand >= m0).any()) or bool((cand < -1).any()):
                raise bad("rebuilt backend emits out-of-range candidate ids")

        alive = idx.store.alive
        W_head = torch.where(alive[:m0, None], W_new.to(idx.store.W.dtype), 0.0)
        ann = refresh.ann
        caught = 0
        w_c = None
        if m_now > m0:
            toks_c, mask_c = pages.gather_docs(
                idx.store, torch.arange(m0, m_now, dtype=torch.int32, device=dev))
            live = torch.nonzero(alive[m0:m_now]).flatten()
            w_c = torch.zeros((m_now - m0, idx.cfg.d_prime), dtype=idx.store.W.dtype,
                              device=dev)
            if live.numel():
                w_c[live] = indexer.fit_docs(solver, toks_c[live], mask_c[live], idx.stats)
                caught = int(live.numel())
            # every slot in order (dead ones as zero rows): ids stay slot ids; a
            # view of W follows the store below
            if getattr(be, "view", None) is None:
                ann = be.add(ann, CorpusView(w_c, toks_c, mask_c), shared=set(_ANN_WRITES))
        shared_ann = ({k for k in _ANN_WRITES if getattr(ann, k) is getattr(refresh.ann, k)}
                      if isinstance(ann, IVFIndex) else set())

        store = pages.writable(idx.store, self._shared["store"], ("W",))
        store.W[:m0] = W_head
        if w_c is not None:
            store.W[m0:m_now] = w_c
        self._index = idx._replace(store=store, ann=over_store(be, ann, store))
        self._shared["ann"] = shared_ann
        self._solver = solver
        self._x_ols = solver["x_ols"]
        self._version += 1
        self._last_refresh_caught_up = caught

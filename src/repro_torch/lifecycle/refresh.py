"""Background index refresh: re-fit the learned reduction on the live corpus
(twin of ``repro/lifecycle/refresh.py``).

``build_refresh`` is a *pure function of one index snapshot*: it takes
``retriever.snapshot()`` under the facade's lock (later mutations copy
each tensor before writing it, so the snapshot never changes while serving
continues to mutate the retriever) and produces everything a warm swap
installs:

1. **re-sampled OLS probes** — ``x_ols`` drawn from the tokens of the docs
   that are alive NOW, not the build-time training tokens, so the Gram
   matrix reflects the drifted distribution.  The draw is numpy's
   ``default_rng(seed)`` over the alive docs' valid tokens in slot order,
   as JAX draws them, so one snapshot and seed give JAX's tokens; they are
   read from the pages one token each, never the dense corpus;
2. **re-fit latent map** — ``W`` rows for every alive slot in ``[0, m0)``
   via the blocked OLS solve with frozen ψ and frozen target stats (token
   MaxSim kernel, then the solve), the alive docs read from the pages a
   block at a time.  Dead slots get zero rows (never fed through the
   solver) — which is exactly what the slot-numbering invariant needs;
3. **re-clustered first stage** — a from-scratch ``be.build`` over the
   re-fit latent rows, its tokens read from the snapshot's pages a chunk of
   docs at a time, so IVF centroids move to where the corpus actually is
   instead of extending the frozen build-time quantizer forever.  Its
   random parts are drawn by a ``torch.Generator`` seeded with ``seed``
   (where JAX draws with ``PRNGKey(seed)``: the rebuilt first stage is the
   port's own, held to JAX by the coverage it recovers).

ψ itself stays frozen: per §4.3 the MLP is pre-trained on a sample and the
OLS output layer does the corpus-specific work, so refit+recluster recovers
almost all drift-lost recall at a tiny fraction of a full rebuild.

Determinism: given the same snapshot and ``seed``, the result is
bit-identical, on the card too (every sum on the path has a fixed order:
the kernels write each output once, and k-means sums a cluster's rows in
row order, ``anns.kmeans.segment_sums``) — which is why a fleet can install
one ``RefreshResult`` on every replica and still pass the barrier's
same-snapshot-version check.

Failure injection: ``chaos.check()`` runs at each phase boundary; any
exception escapes with ``e.lifecycle_phase`` set so the manager can emit a
typed ``RefreshFailed(phase=...)``.  An exception leaves the retriever and
its served snapshot completely untouched.
"""
from __future__ import annotations

import threading
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.anns import registry
from repro_torch.anns.base import CorpusView
from repro_torch.core import indexer, pages

REFIT_BLOCK = 2048   # alive docs read from the pages and fit at a time


class RefreshResult(NamedTuple):
    """Everything ``LemurRetriever.install_refresh`` needs.  ``m0`` is the
    slot high-water mark the rebuild covered; docs added after the snapshot
    are caught up at install time with the new solver.  ``phase_s`` holds
    the seconds of each rebuild phase (``solver``, ``refit``,
    ``recluster``), the device synchronized at each mark."""
    backend: str
    version: int           # snapshot version the rebuild started from
    m0: int
    W: Any                 # (m0, d_prime) re-fit latent rows, dead slots zero
    ann: Any               # freshly built first-stage state over those rows
    solver: dict           # new OLS solver state {"chol", "feats", "x_ols"}
    seed: int
    wall_s: float
    phase_s: dict | None = None


def _ols_sample(store: pages.PagedStore, alive: np.ndarray, n_ols: int, seed: int):
    """The refresh's OLS tokens: ``min(n_ols, n)`` of the n valid tokens of
    the ``alive`` slots (ascending), drawn without replacement by numpy's
    ``default_rng(seed)`` over their positions in slot-then-token order (the
    JAX refresh's ``rng.choice`` over its dense view's valid positions),
    read from the pages -> (n', d) fp32 in draw order."""
    dev = store.W.device
    nt = store.n_tokens[torch.as_tensor(alive, device=dev)].long()
    ends = torch.cumsum(nt, 0)
    total = int(ends[-1]) if len(ends) else 0
    pick = np.random.default_rng(seed).choice(total, size=min(n_ols, total), replace=False)
    pos = torch.as_tensor(pick, device=dev)
    doc = torch.searchsorted(ends, pos, right=True)
    slots = torch.as_tensor(alive, device=dev)[doc]
    return pages.read_tokens(store, slots, pos - (ends - nt)[doc]).contiguous()


def build_refresh(retriever, *, seed: int = 0, chaos=None) -> RefreshResult:
    """Rebuild the learned first stage from ``retriever``'s current snapshot.

    Runs anywhere (worker thread included): only reads the snapshot.
    Raises ``ValueError`` if the snapshot has no alive docs."""
    t0 = time.perf_counter()
    base = getattr(retriever, "_base", retriever)   # sharded -> facade
    with base.lock:
        idx = base.snapshot()
        version = int(base.version)
    cfg, psi, stats, store = idx.cfg, idx.psi, idx.stats, idx.store
    m0 = idx.m
    dev = store.W.device
    phase_s: dict[str, float] = {}

    def mark(name: str, t: float) -> float:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        phase_s[name] = now - t
        return now

    phase = "snapshot"
    try:
        alive = np.flatnonzero(store.alive[:m0].cpu().numpy())
        if alive.size == 0:
            raise ValueError("refresh: snapshot has no alive docs")
        t = time.perf_counter()

        phase = "solver"
        if chaos is not None:
            chaos.check("refresh:solver")
        x_ols = _ols_sample(store, alive, cfg.n_ols, seed)
        solver = indexer.ols_solver_state(psi, x_ols, cfg)
        t = mark("solver", t)

        phase = "refit"
        if chaos is not None:
            chaos.check("refresh:refit")
        W = torch.zeros((m0, cfg.d_prime), dtype=store.W.dtype, device=dev)
        ids = torch.as_tensor(alive, device=dev)
        for lo in range(0, len(alive), REFIT_BLOCK):
            blk = ids[lo:lo + REFIT_BLOCK]
            toks, mask = pages.gather_docs(store, blk)
            W[blk.long()] = indexer.fit_docs(solver, toks, mask, stats).to(W.dtype)
            del toks, mask
        t = mark("refit", t)

        phase = "recluster"
        if chaos is not None:
            chaos.check("refresh:recluster")
        be = registry.get_backend(idx.backend)
        ann = be.build(torch.Generator().manual_seed(seed),
                       CorpusView(W, None, None, read=idx.read_docs),
                       cfg.backend_config(idx.backend))
        mark("recluster", t)
    except Exception as e:
        e.lifecycle_phase = phase
        raise
    result = RefreshResult(idx.backend, version, m0, W, ann, solver,
                           seed, time.perf_counter() - t0, phase_s)
    if chaos is not None:
        result = chaos.maybe_corrupt(result)
    return result


class Refresher:
    """Run one ``build_refresh`` on a daemon worker thread.

    Serving never blocks: the thread only reads a snapshot.
    ``result(timeout)`` joins and returns the :class:`RefreshResult`,
    re-raising whatever the rebuild raised (with ``lifecycle_phase`` set).
    """

    def __init__(self, retriever, *, seed: int = 0, chaos=None):
        self._retriever = retriever
        self._seed = seed
        self._chaos = chaos
        self._result: RefreshResult | None = None
        self._error: BaseException | None = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="lemur-refresher")

    def _run(self) -> None:
        try:
            self._result = build_refresh(self._retriever, seed=self._seed,
                                         chaos=self._chaos)
        except BaseException as e:
            self._error = e

    def start(self) -> "Refresher":
        self._thread.start()
        return self

    def running(self) -> bool:
        return self._thread.is_alive()

    def result(self, timeout: float | None = None) -> RefreshResult:
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("refresh still running")
        if self._error is not None:
            raise self._error
        assert self._result is not None
        return self._result


__all__ = ["RefreshResult", "Refresher", "build_refresh"]

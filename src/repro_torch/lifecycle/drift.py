"""Online drift detection for the learned index (twin of
``repro/lifecycle/drift.py``).

LEMUR's first stage is *trained*: the OLS map ``W`` and the IVF coarse
quantizer are fit to a corpus snapshot.  As the mutable corpus drifts
(adds from a shifted distribution, deletes of the docs the fit saw), recall
decays with no error raised.  The monitor turns that silent decay into a
cheap online signal measured on a reservoir of recent mutations:

* **first-stage coverage** — the primary signal, a direct proxy for the
  recall of record: the fraction of reservoir docs that appear in their OWN
  first-stage candidate list when their tokens are replayed as a query at
  the configured operating point (``candidates()``: IVF probe + k′).  Docs
  the frozen quantizer no longer covers fall out of their own candidate
  lists long before anyone inspects end-to-end recall.  Reported as a ratio
  against a baseline calibrated on docs the fit was trained for; the
  trigger is ``coverage < coverage_ratio_threshold * baseline``.
* **score fidelity** — the Fig.-2 d′ proxy made incremental: Pearson
  correlation between the latent scores ``psi(x) @ W_j`` the index serves
  and the true standardized MaxSim targets ``g_j(x)``, pooled over probe
  tokens ``x`` drawn from recently-added docs.  Probing with *recent*
  tokens is the point — they expose exactly the region the stale OLS fit
  extrapolates into.  Catches map/stats staleness that coverage (a set
  membership test) is blind to, e.g. score-scale drift.
* **assignment skew** — EXCESS total-variation distance between where
  recent docs' latent rows land on the frozen IVF centroids and the current
  cluster mass, beyond the finite-sample multinomial null (a reservoir of n
  docs over ``nlist`` clusters has TV ≈ Θ(sqrt(nlist/n)) against ANY mass
  purely from sampling — raw TV would false-trigger on small reservoirs,
  see tests).  The null mean is estimated with seeded multinomial draws.

All three are O(reservoir), not O(corpus), and read live index state at
report time — after a warm swap the same reservoir immediately measures the
new fit (coverage against the re-clustered quantizer in particular), which
is how refresh efficacy is verified.

The reservoir is fed by the ``core.pages`` mutation tap (host numpy
payloads, on the mutating thread).  In a fleet every replica applies the
same logical mutation, so the tap fires once per replica; slot ids are
globally monotone, which makes dedupe trivial — record only ids beyond the
high-water mark.

The measurements run on the retriever's device: coverage through the
facade's ``candidates`` (the ψ-pool and the first stage), fidelity through
the ψ kernel (unpooled) and the token MaxSim kernel, skew through
``anns.ivf.assign_clusters``.  The facade writes its index in place, so a
measurement holds the facade's lock for its whole reading (a mutation on
the server's worker waits for it, searches do not), and sees one index
between two mutations.
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from repro_torch.anns.ivf import assign_clusters
from repro_torch.core import maxsim, pages
from repro_torch.kernels import fused_psi


@dataclasses.dataclass(frozen=True)
class DriftReport:
    """One staleness measurement.  ``triggered`` applies the monitor's
    thresholds; ``reason`` says which signal fired."""
    coverage: float          # reservoir self-retrieval rate (primary signal)
    baseline_coverage: float
    fidelity: float
    baseline_fidelity: float
    fidelity_drop: float
    skew: float              # excess TV over the finite-sample null
    n_reservoir: int
    triggered: bool
    reason: str

    @property
    def coverage_ratio(self) -> float:
        return self.coverage / max(self.baseline_coverage, 1e-9)


def _facade(retriever):
    """Accept both ``LemurRetriever`` and ``ShardedLemurRetriever`` — the
    sharded wrapper's learned state lives on its base facade."""
    return getattr(retriever, "_base", retriever)


def _pearson(a: np.ndarray, b: np.ndarray) -> float:
    a = a.ravel().astype(np.float64)
    b = b.ravel().astype(np.float64)
    a = a - a.mean()
    b = b - b.mean()
    denom = float(np.sqrt((a * a).sum() * (b * b).sum()))
    if denom <= 0.0 or not np.isfinite(denom):
        return 0.0
    return float((a * b).sum() / denom)


class DriftMonitor:
    """Tracks staleness of a ``LemurRetriever``'s learned first stage.

    ``attach()`` registers a mutation tap and calibrates the fidelity
    baseline on the CURRENT corpus (a sample of alive docs — by
    construction the fit is fresh for them).  ``report()`` measures the
    reservoir against the live index.  Thread-safe: taps fire on server
    worker threads while reports run on a lifecycle thread, each reading
    under the facade's lock.
    """

    def __init__(self, retriever, *, reservoir: int = 256, probes: int = 128,
                 probe_docs: int = 64, baseline_docs: int = 64,
                 coverage_ratio_threshold: float = 0.25,
                 fidelity_drop_threshold: float = 0.10,
                 skew_threshold: float = 0.25, seed: int = 0):
        self._retriever = retriever
        self._cap = int(reservoir)
        self._probes = int(probes)
        self._probe_docs = int(probe_docs)
        self._baseline_docs = int(baseline_docs)
        self._cov_thr = float(coverage_ratio_threshold)
        self._drop_thr = float(fidelity_drop_threshold)
        self._skew_thr = float(skew_threshold)
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        # slot id -> (tokens (t, d), mask (t,)) of recently-added docs
        self._res: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self._max_seen = -1           # monotone-id dedupe across replicas
        # delete dedupe: dict-as-ordered-set, FIFO-bounded so a long-running
        # monitor never leaks (worst case after eviction: an over-counted
        # n_mutations, never a wrong report)
        self._deleted: dict[int, None] = {}
        self._baseline: tuple[float, float] | None = None  # (fidelity, coverage)
        self._attached = False
        self.n_mutations = 0          # logical mutations observed (deduped)

    # -- reservoir feed ----------------------------------------------------

    def _tap(self, kind: str, ids, **payload) -> None:
        ids = np.asarray(ids).ravel()
        with self._lock:
            if kind == "add":
                fresh = ids > self._max_seen
                if not fresh.any():
                    return          # a sibling replica already reported these
                toks = payload["doc_tokens"]
                mask = payload["doc_mask"]
                for k in np.flatnonzero(fresh):
                    i = int(ids[k])
                    self._res[i] = (toks[k], mask[k])
                    self._max_seen = max(self._max_seen, i)
                while len(self._res) > self._cap:
                    self._res.pop(next(iter(self._res)))
                self.n_mutations += 1
            elif kind == "delete":
                new = [int(i) for i in ids if int(i) not in self._deleted]
                if not new:
                    return
                for i in new:
                    self._deleted[i] = None
                    self._res.pop(i, None)
                while len(self._deleted) > 4 * self._cap:
                    self._deleted.pop(next(iter(self._deleted)))
                self.n_mutations += 1

    def attach(self) -> None:
        if self._attached:
            return
        self._baseline = self._measure_baseline()
        pages.register_mutation_tap(self._tap)
        self._attached = True

    def detach(self) -> None:
        if self._attached:
            pages.unregister_mutation_tap(self._tap)
            self._attached = False

    def __enter__(self):
        self.attach()
        return self

    def __exit__(self, *exc):
        self.detach()
        return False

    def reset(self) -> None:
        """Drop the reservoir and recalibrate the baseline — called after a
        warm swap so the next report measures drift against the NEW fit."""
        with self._lock:
            self._res.clear()
            self.n_mutations = 0
        self._baseline = self._measure_baseline()

    @property
    def n_reservoir(self) -> int:
        with self._lock:
            return len(self._res)

    # -- measurement -------------------------------------------------------

    def _fidelity(self, doc_ids: np.ndarray, toks: np.ndarray,
                  mask: np.ndarray) -> float:
        """Pearson corr of served latent scores vs true standardized MaxSim
        over (probe token, doc) pairs; probes drawn from ``toks``.  Called
        with the facade's lock held."""
        idx = _facade(self._retriever).index
        dev = idx.device
        flat = toks.reshape(-1, toks.shape[-1])
        ok = np.flatnonzero(mask.reshape(-1))
        if ok.size == 0:
            return 1.0
        pick = self._rng.choice(ok, size=min(self._probes, ok.size),
                                replace=False)
        x = torch.as_tensor(flat[pick], device=dev).contiguous()
        w = idx.store.W[torch.as_tensor(doc_ids, dtype=torch.long, device=dev)]
        pred = fused_psi.fused_psi(x, *idx.psi.params().values()) @ w.T
        g = maxsim.token_maxsim(x, torch.as_tensor(toks, device=dev),
                                torch.as_tensor(mask, device=dev))
        g = (g - idx.stats.mean) / idx.stats.std
        return _pearson(pred.cpu().numpy(), g.cpu().numpy())

    def _coverage(self, doc_ids: np.ndarray, toks: np.ndarray,
                  mask: np.ndarray) -> float:
        """Self-retrieval rate: the fraction of ``doc_ids`` that appear in
        their own first-stage candidate list when their tokens are replayed
        as a query at the configured operating point.  Samples at most
        ``probe_docs`` docs; the batch is padded to a FIXED (probe_docs,
        pow2-Tq) shape so the background monitor serves one shape per
        token bucket, not one per reservoir size.  Called with the facade's
        lock held."""
        r = _facade(self._retriever)
        n = min(self._probe_docs, len(doc_ids))
        if n == 0:
            return 1.0
        pick = self._rng.choice(len(doc_ids), size=n, replace=False)
        tmax = 1 << (int(toks.shape[1]) - 1).bit_length()
        tp = np.zeros((self._probe_docs, tmax, toks.shape[-1]), np.float32)
        mp = np.zeros((self._probe_docs, tmax), bool)
        tp[:n, :toks.shape[1]] = toks[pick]
        mp[:n, :toks.shape[1]] = mask[pick]
        cand = r.candidates(tp, mp)[:n].cpu().numpy()
        ids = np.asarray(doc_ids)[pick]
        return float(np.mean([int(i) in set(cand[j].tolist())
                              for j, i in enumerate(ids)]))

    def _measure_baseline(self) -> tuple[float, float]:
        """(fidelity, coverage) on ``baseline_docs`` alive docs the CURRENT
        fit covers — by construction fresh for them, so it calibrates both
        signals.  The fidelity is a Pearson correlation pooled over (probe
        token, doc) pairs, and it reads lower over more docs of one
        distribution (PERF.md §6: 0.43 over 64 docs, 0.34 over 256, on a
        200,000-doc index), so a baseline compares with a full reservoir's
        reports only when ``baseline_docs`` equals ``reservoir``; the
        default, 64, is the JAX package's."""
        sample = self._baseline_docs
        r = _facade(self._retriever)
        with r.lock:
            idx = r.index
            alive = np.flatnonzero(idx.store.alive[:idx.m].cpu().numpy())
            if alive.size == 0:
                return 1.0, 1.0
            pick = self._rng.choice(alive, size=min(sample, alive.size),
                                    replace=False).astype(np.int32)
            toks, mask = pages.gather_docs(idx.store,
                                           torch.as_tensor(pick, device=idx.device))
            toks, mask = toks.cpu().numpy(), mask.cpu().numpy()
            return (self._fidelity(pick, toks, mask),
                    self._coverage(pick, toks, mask))

    def _skew(self, doc_ids: np.ndarray) -> float:
        """EXCESS TV distance between reservoir centroid assignments and the
        current cluster mass, beyond the finite-sample multinomial null
        (mean TV of same-size draws FROM that mass — raw TV at reservoir
        sizes is dominated by sampling noise and would false-trigger).
        0.0 when the backend has no coarse quantizer.  Called with the
        facade's lock held."""
        idx = _facade(self._retriever).index
        ann = idx.ann
        if ann is None or not hasattr(ann, "centroids"):
            return 0.0
        w = idx.store.W[torch.as_tensor(doc_ids, dtype=torch.long, device=idx.device)]
        if getattr(ann, "mean", None) is not None:
            w = w - ann.mean[None, :]
        assign = assign_clusters(w, ann.centroids).cpu().numpy()
        nlist = ann.centroids.shape[0]
        n = len(doc_ids)
        p = np.bincount(assign, minlength=nlist).astype(np.float64)
        p /= max(p.sum(), 1.0)
        q = ann.counts.cpu().numpy().astype(np.float64)
        q /= max(q.sum(), 1.0)
        tv = float(0.5 * np.abs(p - q).sum())
        draws = self._rng.multinomial(n, q, size=32) / max(n, 1)
        null = float(0.5 * np.abs(draws - q[None, :]).sum(axis=1).mean())
        return max(0.0, tv - null)

    def report(self) -> DriftReport:
        with self._lock:
            items = [(i, t, mk) for i, (t, mk) in self._res.items()
                     if i not in self._deleted]
        base_fid, base_cov = self._baseline if self._baseline else (1.0, 1.0)
        r = _facade(self._retriever)
        with r.lock:      # one index between two mutations (module docstring)
            alive = r.index.store.alive.cpu().numpy()
            items = [(i, t, mk) for i, t, mk in items
                     if i < alive.shape[0] and alive[i]]
            if not items:
                return DriftReport(1.0, base_cov, 1.0, base_fid, 0.0, 0.0, 0,
                                   False, "empty reservoir")
            ids = np.asarray([i for i, _, _ in items], np.int32)
            tmax = max(t.shape[0] for _, t, _ in items)
            d = items[0][1].shape[-1]
            toks = np.zeros((len(items), tmax, d), np.float32)
            mask = np.zeros((len(items), tmax), bool)
            for k, (_, t, mk) in enumerate(items):
                toks[k, :t.shape[0]] = t
                mask[k, :mk.shape[0]] = mk
            coverage = self._coverage(ids, toks, mask)
            fidelity = self._fidelity(ids, toks, mask)
            skew = self._skew(ids)
        drop = max(0.0, base_fid - fidelity)
        reasons = []
        if coverage < self._cov_thr * base_cov:
            reasons.append(f"first-stage coverage {coverage:.3f} < "
                           f"{self._cov_thr} * baseline {base_cov:.3f}")
        if drop > self._drop_thr:
            reasons.append(f"fidelity drop {drop:.3f} > {self._drop_thr}")
        if skew > self._skew_thr:
            reasons.append(f"assignment skew {skew:.3f} > {self._skew_thr}")
        return DriftReport(coverage, base_cov, fidelity, base_fid, drop, skew,
                           len(items), bool(reasons),
                           "; ".join(reasons) or "healthy")

    def maybe_report(self, min_reservoir: int = 16) -> DriftReport | None:
        """Cheap gate for polling loops: only measure once enough recent
        mutations accumulated to make the signal meaningful."""
        if self.n_reservoir < min_reservoir:
            return None
        return self.report()


__all__ = ["DriftMonitor", "DriftReport"]

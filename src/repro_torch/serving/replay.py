"""Poisson arrival-trace replay against a :class:`RetrieverServer` (twin of
``repro/serving/replay.py``: the same numpy draws, so one seed gives the
JAX package's traces and queries).

The online operating point depends on the arrival process, not just the
kernel: latency percentiles trade against micro-batch occupancy as load
rises.  This module owns the replay loop (``chip_smoke.py``'s online,
fleet and lifecycle phases drive it): generate a seeded Poisson trace, pace
ragged submissions against the wall clock, then fold the server's stats
into one JSON-able report.

Latency is measured from each request's *scheduled* arrival time, not from
the (possibly delayed) ``submit()`` call.  When the replay thread itself
falls behind — a submit stalls, the queue backs up — the un-submitted
requests are already waiting in line; measuring from the late submit call
hides that wait (coordinated omission) and reports an optimistic p99.
``replay`` therefore passes ``t_arrival=t0 + at`` through to the server,
whose stats keep the submit-relative twins alongside (``submit_p*_ms``) so
tests can assert the two diverge under an induced stall.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.serving.server import DeadlineExceeded, Overloaded


def poisson_trace(rate_qps: float, duration_s: float, seed: int = 0):
    """Arrival offsets (seconds from t0) of a Poisson process at
    ``rate_qps`` over ``duration_s`` — the standard open-loop serving
    workload (exponential inter-arrivals, seeded for reproducibility)."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / max(rate_qps, 1e-9),
                           size=max(int(rate_qps * duration_s * 2), 16))
    at = np.cumsum(gaps)
    return at[at < duration_s]


def ragged_queries(n: int, d: int, tq_range=(2, 24), seed: int = 0):
    """``n`` unit-norm ragged queries with Tq uniform over ``tq_range``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tq = int(rng.integers(tq_range[0], tq_range[1] + 1))
        q = rng.standard_normal((tq, d)).astype(np.float32)
        out.append(q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True),
                                  1e-9))
    return out


def warm_buckets(retriever, ladder, d: int, params=None,
                 batch_sizes=None) -> int:
    """Serve every bucketed shape once so the replay measures steady-state
    latency, not first launches (a kernel's first launch builds it, and the
    allocator grows its pools).  Returns the number of shapes warmed (== the
    compile bound actually paid)."""
    resolved = retriever.resolve(params)
    n = 0
    for tq in ladder.tq_ladder:
        for b in (batch_sizes or ladder.batch_sizes()):
            q = np.zeros((b, tq, d), np.float32)
            qm = np.zeros((b, tq), bool)
            qm[:, 0] = True
            retriever.search(q, qm, resolved)
            n += 1
    return n


def replay(server, queries, arrivals, params=None, *, timeout: float = 300.0,
           deadline_s: float | None = None):
    """Open-loop replay: submit ``queries[i]`` at wall-clock offset
    ``arrivals[i]`` (cycling the query list if the trace is longer), wait
    for every future, and return ``(results, report)`` where ``report`` is
    ``server.stats.summary()`` extended with the offered load.  The stats
    window is reset at replay start, so the report covers exactly this
    trace (earlier phases don't bleed into the percentiles).

    Each submit carries ``t_arrival = t0 + at`` so the reported ``p*_ms``
    are free of coordinated omission (see module docstring).  Typed
    serving outcomes — :class:`Overloaded` rejects (from admission
    control) and :class:`DeadlineExceeded` expiries — are returned
    in-place in ``results`` as the exception instance, counted in the
    report (``n_rejected``/``n_expired``/``reject_rate``), and
    ``n_lost`` counts requests that vanished without any outcome (always
    0 for a correct server)."""
    server.reset_stats()
    t0 = time.perf_counter()
    futs: list = []
    for i, at in enumerate(arrivals):
        delay = at - (time.perf_counter() - t0)
        if delay > 0:
            time.sleep(delay)
        try:
            futs.append(server.submit(queries[i % len(queries)],
                                      params=params,
                                      t_arrival=t0 + float(at),
                                      deadline_s=deadline_s))
        except Overloaded as e:
            futs.append(e)  # synchronous typed reject — an outcome, not a loss
    results: list = []
    n_lost = 0
    for f in futs:
        if isinstance(f, Overloaded):
            results.append(f)
            continue
        try:
            results.append(f.result(timeout=timeout))
        except (Overloaded, DeadlineExceeded) as e:
            results.append(e)
        except Exception:  # noqa: BLE001 — cancelled/timed out == lost
            results.append(None)
            n_lost += 1
    report = server.stats.summary()
    report["offered_qps"] = (len(arrivals) / float(arrivals[-1])
                             if len(arrivals) and arrivals[-1] > 0
                             else float("nan"))
    report["trace_count"] = server.trace_count()
    report["n_lost"] = n_lost
    report["reject_rate"] = (report.get("n_rejected", 0) / len(arrivals)
                             if len(arrivals) else 0.0)
    return results, report


__all__ = ["poisson_trace", "ragged_queries", "replay", "warm_buckets"]

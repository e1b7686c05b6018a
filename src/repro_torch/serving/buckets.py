"""Shape-bucketing policy for the online serving runtime (twin of
``repro/serving/buckets.py``).

Online traffic is ragged: single queries with arbitrary token counts
arriving asynchronously.  The port runs eagerly, but a served shape is still
an entry in the retriever's compile accounting (``trace_count``: what JAX's
jit cache would hold), and the kernels are sized by it, so serving raw
ragged shapes would grow that set without bound.  :class:`BucketLadder`
bounds the shape space instead:

* **Tq ladder** — every query's token axis is padded up to a small fixed
  ladder of lengths (default ``32/64/128/256``, the ColBERT-style query
  length regime).  Padded token rows carry zero vectors and ``False``
  mask bits, which the pool/rerank pipeline treats as exact no-ops.
* **Batch sizes** — micro-batches are padded up to power-of-two sizes
  (``1, 2, 4, …, max_batch``).  Padded batch rows replicate a real row
  (never a degenerate all-``False`` mask) and their results are dropped.

With both axes bucketed, the served shapes are bounded by
``compile_bound()`` = ``len(tq_ladder) × len(batch_sizes)`` per resolved
``SearchParams`` — asserted against ``trace_count()`` in the serving
runtime tests, no matter how shapes churn.  The slabs stay host numpy: the
server moves each padded micro-batch to the retriever's device once.
"""
from __future__ import annotations

import dataclasses

import numpy as np

DEFAULT_TQ_LADDER = (32, 64, 128, 256)


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


@dataclasses.dataclass(frozen=True)
class BucketLadder:
    """The serving shape policy (see module docstring).

    ``tq_ladder`` must be strictly increasing.  Queries longer than the top
    rung overflow to the next power of two — legal, but each distinct
    overflow length is a served shape outside the ladder bound, so size the
    ladder to the traffic."""

    tq_ladder: tuple[int, ...] = DEFAULT_TQ_LADDER
    max_batch: int = 16

    def __post_init__(self):
        ladder = tuple(int(t) for t in self.tq_ladder)
        if not ladder or any(t <= 0 for t in ladder):
            raise ValueError(f"tq_ladder must be positive: {ladder}")
        if list(ladder) != sorted(set(ladder)):
            raise ValueError(f"tq_ladder must be strictly increasing: {ladder}")
        object.__setattr__(self, "tq_ladder", ladder)
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1: {self.max_batch}")
        object.__setattr__(self, "max_batch", _next_pow2(self.max_batch))

    # -- bucket selection ---------------------------------------------------

    def tq_bucket(self, tq: int) -> int:
        """Smallest ladder rung >= tq (next power of two on overflow)."""
        for rung in self.tq_ladder:
            if tq <= rung:
                return rung
        return _next_pow2(tq)

    def batch_bucket(self, n: int) -> int:
        """Smallest power-of-two batch size >= n, capped at ``max_batch``."""
        return min(_next_pow2(n), self.max_batch)

    def batch_sizes(self) -> tuple[int, ...]:
        sizes, b = [], 1
        while b <= self.max_batch:
            sizes.append(b)
            b *= 2
        return tuple(sizes)

    def compile_bound(self, n_param_sets: int = 1) -> int:
        """Upper bound on compile-cache entries (``trace_count``) for
        in-ladder traffic: one per (Tq rung, batch size, resolved
        SearchParams)."""
        return len(self.tq_ladder) * len(self.batch_sizes()) * n_param_sets

    # -- batch assembly -----------------------------------------------------

    def pad_batch(self, queries, masks):
        """Assemble ragged single queries into one bucketed slab.

        ``queries``: list of (Tq_i, d) fp32 arrays; ``masks``: matching list
        of (Tq_i,) bool arrays.  Returns ``(q, qm, n_real)`` with
        ``q: (Bb, Tqb, d)``, ``qm: (Bb, Tqb)`` where ``Tqb`` buckets the
        longest request and ``Bb`` buckets ``len(queries)``.  Padded token
        rows are zero vectors with ``False`` mask (exact no-ops in the
        pool/rerank pipeline); padded batch rows replicate row 0 and are
        sliced away by the caller."""
        if not queries:
            raise ValueError("pad_batch needs at least one query")
        n_real = len(queries)
        tqb = self.tq_bucket(max(q.shape[0] for q in queries))
        bb = self.batch_bucket(n_real)
        d = queries[0].shape[-1]
        q = np.zeros((bb, tqb, d), np.float32)
        qm = np.zeros((bb, tqb), bool)
        for i, (qi, mi) in enumerate(zip(queries, masks)):
            t = qi.shape[0]
            q[i, :t] = qi
            qm[i, :t] = mi
        if bb > n_real:  # replicate a real row into the batch pad
            q[n_real:] = q[0]
            qm[n_real:] = qm[0]
        return q, qm, n_real


def pad_single(query, mask, tq: int):
    """Pad one (Tq, d) query + (Tq,) mask up to ``tq`` token rows (zero
    vectors, ``False`` mask) — the per-request half of :meth:`pad_batch`,
    exposed for conformance tests."""
    t, d = query.shape
    q = np.zeros((tq, d), np.float32)
    m = np.zeros((tq,), bool)
    q[:t] = query
    m[:t] = mask
    return q, m


__all__ = ["BucketLadder", "DEFAULT_TQ_LADDER", "pad_single"]

"""Replica factory + warmup for the fleet router (twin of
``repro/fleet/replica.py``).

A fleet replica is a :class:`~repro_torch.serving.RetrieverServer` over an
independent ``retriever.clone()`` — the index tensors and the OLS solver
state are shared (one build, N serving replicas; no re-train, no extra
corpus copies until a replica writes), compile accounting is private per
replica, and ``version`` numbering is common across the fleet so the
router's write barrier can stamp every replica to the same snapshot.  The
port writes in place: a replica's first mutation copies each tensor it
writes (the page pool, W, the lists), since its siblings still hold them;
later mutations write its own copies in place.

``warm_replicas`` serves every (rung, Tq bucket, batch bucket) shape on
every replica before traffic arrives, so neither dispatch skew nor an SLO
downshift ever pays a first launch (a kernel build) in the latency path.
"""
from __future__ import annotations

from repro_torch.serving.buckets import BucketLadder
from repro_torch.serving.replay import warm_buckets


def clone_replicas(retriever, n: int) -> list:
    """``n`` independent replicas of a built retriever (clone semantics —
    see ``LemurRetriever.clone``).  Replica 0 is a clone too, so the
    caller's retriever is never mutated by fleet traffic."""
    if n < 1:
        raise ValueError(f"need at least one replica, got {n}")
    return [retriever.clone() for _ in range(n)]


def warm_replicas(replicas, ladder: BucketLadder, d: int,
                  params_list=(None,)) -> int:
    """Serve the bucketed shapes once for every params set (e.g. every SLO
    rung) on every replica.  Returns total shapes warmed — equals
    ``n_replicas * ladder.compile_bound(len(params_list))`` when the params
    sets are distinct."""
    n = 0
    for rep in replicas:
        for params in params_list:
            n += warm_buckets(rep, ladder, d, params)
    return n


__all__ = ["clone_replicas", "warm_replicas"]

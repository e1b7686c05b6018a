"""Lloyd's k-means (twin of ``repro/anns/kmeans.py``).

Same rules as the JAX version: initial centroids are k distinct sample
rows; assignment is ``argmax(x.c - ||c||^2/2)`` (nearest centroid, one
matmul per block of rows, first index on ties); an empty cluster keeps its
centroid.  The initial rows come from an explicit ``torch.Generator``, so
the draw differs from JAX's.  A cluster's sum adds its rows in ascending
row order (:func:`segment_sums`), so one input gives one result on the card
too, where ``index_add_`` adds by atomics in whatever order threads arrive:
the index refresh promises the same bits from the same snapshot and seed.
"""
from __future__ import annotations

import torch


def assign(x: torch.Tensor, cent: torch.Tensor, block: int = 65536) -> torch.Tensor:
    """(n, d) x (k, d) -> (n,) int64 nearest-centroid ids, blocked over n."""
    half = 0.5 * cent.square().sum(1)
    out = torch.empty((x.shape[0],), dtype=torch.long, device=x.device)
    for s in range(0, x.shape[0], block):
        out[s:s + block] = torch.argmax(x[s:s + block] @ cent.T - half, dim=1)
    return out


def segment_sums(x: torch.Tensor, a: torch.Tensor, k: int) -> torch.Tensor:
    """(n, d) rows x, (n,) cluster ids a -> (k, d) per-cluster sums, each
    cluster's rows added in ascending row order (the rows sorted stably by
    cluster, then ``segment_reduce``: one pass a segment, no atomics); on
    the CPU the bits of ``index_add_``."""
    order = torch.argsort(a, stable=True)
    lengths = torch.bincount(a, minlength=k)
    return torch.segment_reduce(x[order], "sum", lengths=lengths, unsafe=True, initial=0.0)


def kmeans(x: torch.Tensor, k: int, iters: int = 10, *,
           generator: torch.Generator | None = None, block: int = 65536):
    """x: (n, d) -> (centroids (k, d), assignment (n,) int64)."""
    n, d = x.shape
    init = torch.randperm(n, generator=generator)[:k].to(x.device)
    cent = x[init]
    for _ in range(iters):
        a = assign(x, cent, block)
        sums = segment_sums(x, a, k)
        counts = torch.bincount(a, minlength=k).to(x.dtype)
        new = sums / counts.clamp_min(1.0)[:, None]
        cent = torch.where(counts[:, None] > 0, new, cent)
    return cent, assign(x, cent, block)

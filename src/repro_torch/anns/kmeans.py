"""Lloyd's k-means (twin of ``repro/anns/kmeans.py``).

Same rules as the JAX version: initial centroids are k distinct sample
rows; assignment is ``argmax(x.c - ||c||^2/2)`` (nearest centroid, one
matmul per block of rows, first index on ties); an empty cluster keeps its
centroid.  The initial rows come from an explicit ``torch.Generator``, so
the draw differs from JAX's.
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


def kmeans(x: torch.Tensor, k: int, iters: int = 10, *,
           generator: torch.Generator | None = None, block: int = 65536):
    """x: (n, d) -> (centroids (k, d), assignment (n,) int64)."""
    n, d = x.shape
    init = torch.randperm(n, generator=generator)[:k].to(x.device)
    cent = x[init]
    for _ in range(iters):
        a = assign(x, cent, block)
        sums = torch.zeros((k, d), dtype=x.dtype, device=x.device).index_add_(0, a, x)
        counts = torch.bincount(a, minlength=k).to(x.dtype)
        new = sums / counts.clamp_min(1.0)[:, None]
        cent = torch.where(counts[:, None] > 0, new, cent)
    return cent, assign(x, cent, block)

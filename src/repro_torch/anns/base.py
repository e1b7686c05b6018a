"""Top-k helpers shared by the first stage and the rerank (the port's side
of ``repro/anns/base.py``).

``jax.lax.top_k`` returns the lowest index first among equal scores, and the
JAX package's ids depend on it; ``torch.topk`` promises no order on ties.
So every top-k in the port goes through :func:`stable_topk`, which orders by
score descending, then index ascending.
"""
from __future__ import annotations

import torch


def stable_topk(scores: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest entries along the last axis,
    ties broken by the lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def pad_topk(scores: torch.Tensor, ids: torch.Tensor, k: int):
    """Pad a (B, kk<=k) top-k result out to k columns with (-inf, -1)."""
    kk = scores.shape[1]
    if kk >= k:
        return scores[:, :k], ids[:, :k]
    B = scores.shape[0]
    return (torch.cat([scores, scores.new_full((B, k - kk), float("-inf"))], 1),
            torch.cat([ids, ids.new_full((B, k - kk), -1)], 1))

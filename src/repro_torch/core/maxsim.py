"""MaxSim similarity (eq. 1): the build's targets and the exact ground truth
(twin of ``repro/core/maxsim.py``).

Every function goes through the token MaxSim wrapper
(``kernels/maxsim.py``), which launches the kernel for CUDA tensors and runs
its plain twin for CPU tensors.  ``block`` docs at a time bound the plain
twin's (n, block, T) scores and, in ``maxsim_scores``, the (B * Tq, block)
per-token maxima on either device.  The legacy
gathered rerank (``rerank``, ``rerank_gathered``) is ROADMAP Queue 1
item 4.
"""
from __future__ import annotations

import torch

from repro_torch.anns.base import stable_topk
from repro_torch.kernels import maxsim as _mx
from repro_torch.kernels import ops


def token_maxsim(x, docs, docs_mask, *, block: int = 1024):
    """g(x)_l = max_{c in C_l} <c, x> (§3.1).  x: (n, d) -> (n, m) fp32.
    One kernel launch on a CUDA device."""
    return _mx.token_maxsim(x, docs, docs_mask, chunk=block)


def maxsim_scores(q, q_mask, docs, docs_mask, *, block: int = 1024):
    """MaxSim of each query against every doc.  q: (B, Tq, d); docs:
    (m, Td, d) -> (B, m) fp32, one kernel launch per block of docs on a
    CUDA device."""
    m = docs.shape[0]
    out = torch.empty((q.shape[0], m), dtype=torch.float32, device=q.device)
    for s in range(0, m, block):
        out[:, s:s + block] = ops.maxsim_scores(q, q_mask, docs[s:s + block],
                                                docs_mask[s:s + block])
    return out


def true_topk(q, q_mask, docs, docs_mask, k: int, *, block: int = 1024):
    """Exact MaxSim k-nn (ground truth for recall) -> (scores, int32 ids),
    ties to the lower id as ``jax.lax.top_k``."""
    top, idx = stable_topk(maxsim_scores(q, q_mask, docs, docs_mask, block=block), k)
    return top, idx.to(torch.int32)


def recall_at(retrieved, truth) -> torch.Tensor:
    """Recall (eq. 3): |retrieved ∩ truth| / |truth| per row."""
    hits = (retrieved[:, :, None] == truth[:, None, :]).any(1)
    return hits.float().mean(-1)

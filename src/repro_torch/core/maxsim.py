"""MaxSim similarity (eq. 1): the build's targets and the exact ground truth
(twin of ``repro/core/maxsim.py``).

The corpus-wide functions go through the token MaxSim wrapper
(``kernels/maxsim.py``), which launches the kernel for CUDA tensors and runs
its plain twin for CPU tensors.  ``block`` docs at a time bound the plain
twin's (n, block, T) scores and, in ``maxsim_scores``, the (B * Tq, block)
per-token maxima on either device.  One pair's MaxSim
(:func:`maxsim_pair`) and the legacy gathered rerank (:func:`rerank`,
:func:`rerank_gathered`) are plain PyTorch on either device, as the JAX
package's are jnp.
"""
from __future__ import annotations

import torch

from repro_torch.anns.base import stable_topk
from repro_torch.kernels import maxsim as _mx
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG


def maxsim_pair(q, q_mask, c, c_mask):
    """MaxSim(X, C) for one pair.  q: (Tq, d); c: (Td, d) -> () fp32: masked
    doc tokens score NEG, masked query tokens add 0 (plain PyTorch on either
    device, as the JAX package's is jnp)."""
    s = torch.where(c_mask[None, :], q @ c.T, NEG)           # (Tq, Td)
    return torch.where(q_mask, s.amax(-1), 0.0).sum()


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


def rerank_gathered(q, q_mask, cand_ids, cand_docs, cand_mask, k: int):
    """Exact MaxSim rerank of pre-gathered candidates (``pages.gather_docs``).
    q: (B, Tq, d); cand_ids: (B, k'); cand_docs: (B, k', Tm, d); cand_mask:
    (B, k', Tm) -> (scores (B, k), ids (B, k)).  ``-1`` candidates score NEG
    and surface, id ``-1``, only when a row has fewer than k real ones; rows
    are padded with (NEG, -1) when k > k', as the paged rerank pads them."""
    s = torch.einsum("bqd,bmtd->bmqt", q, cand_docs.to(q.dtype))
    s = torch.where(cand_mask[:, :, None, :], s, NEG)
    best = torch.where(q_mask[:, None, :], s.amax(-1), 0.0)
    scores = torch.where(cand_ids >= 0, best.sum(-1), NEG)   # (B, k')
    kk = min(k, scores.shape[1])
    top, idx = stable_topk(scores, kk)
    ids = torch.gather(cand_ids, 1, idx)
    if kk < k:
        B = scores.shape[0]
        top = torch.cat([top, top.new_full((B, k - kk), NEG)], 1)
        ids = torch.cat([ids, ids.new_full((B, k - kk), -1)], 1)
    return top, ids


def rerank(q, q_mask, cand_ids, docs, docs_mask, k: int):
    """Exact MaxSim rerank against a dense corpus: docs (m, Td, d), docs_mask
    (m, Td); the same NEG and pad rules as :func:`rerank_gathered`."""
    safe = cand_ids.clamp_min(0).long()
    return rerank_gathered(q, q_mask, cand_ids, docs[safe], docs_mask[safe].bool(), k)

"""Exact latent MIPS with a blocked, carried top-k (twin of
``repro/anns/bruteforce.py``).

The corpus is scanned a block of rows at a time: one plain product per
block (``torch.matmul``, as the JAX package leaves it to XLA), the block's
top-k, and a stable merge into the carried top-k with the carried entries
first, so a tie keeps the lower position.  Peak memory is O(B (k + block)).
This is the exact-scan arm of the paper's Fig. 3 and the blocked twin of the
one-launch dense scan (``kernels/query_fused.mips_topk``).
"""
from __future__ import annotations

import torch

from repro_torch.anns.base import stable_topk


def mips_topk(q: torch.Tensor, corpus: torch.Tensor, k: int, block: int = 8192, *,
              valid: torch.Tensor | None = None):
    """q: (B, d); corpus: (m, d) -> (scores (B, k), int32 ids (B, k)).

    ``valid`` (m,) bool masks rows to ``-inf`` (how the paged store scans its
    full slot capacity while dead and unallocated slots never win); rows
    past the valid ones come out as (-inf, -1)."""
    B = q.shape[0]
    m = corpus.shape[0]
    top_s = q.new_full((B, k), float("-inf"), dtype=torch.float32)
    top_i = torch.full((B, k), -1, dtype=torch.int32, device=q.device)
    for off in range(0, m, block):
        cb = corpus[off:off + block]
        s = (q @ cb.T.to(q.dtype)).float()
        if valid is not None:
            s = torch.where(valid[off:off + block][None, :], s, float("-inf"))
        bs, bi = stable_topk(s, min(k, cb.shape[0]))
        cand_s = torch.cat([top_s, bs], 1)
        cand_i = torch.cat([top_i, (bi + off).to(torch.int32)], 1)
        top_s, mi = stable_topk(cand_s, k)
        top_i = torch.gather(cand_i, 1, mi)
    return top_s, top_i

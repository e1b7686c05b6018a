"""Public wrappers over the kernels (twin of ``repro/kernels/ops.py``).

The device decides the path and nothing else does: CPU tensors go through
the plain PyTorch versions, CUDA tensors through the hand-written kernels,
and a kernel that cannot build or launch raises.  ``launch_counts`` reads the
per-kernel launch counters a run can check the main path against.
"""
from __future__ import annotations

import torch

from repro_torch.anns.base import stable_topk
from repro_torch.kernels import fused_psi as _fp
from repro_torch.kernels import gather_scan as _gs
from repro_torch.kernels import maxsim as _mx
from repro_torch.kernels.ref import NEG

#: every kernel wrapper, by name: the serving path's three, then the
#: build's token MaxSim and the unpooled psi (the psi-pool kernel's other form)
KERNELS = {
    "fused_psi_pool": _fp.fused_psi_pool,
    "ivf_probe_scan": _gs.ivf_probe_scan,
    "rerank_paged_scores": _gs.rerank_paged_scores,
    "token_maxsim": _mx.token_maxsim,
    "fused_psi": _fp.fused_psi,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def maxsim_scores(q, q_mask, doc_tokens, doc_mask, *, chunk: int | None = None):
    """(B, Tq, d) -> (B, m): full MaxSim through the token kernel plus a
    masked sum over the query tokens (``chunk``: see ``token_maxsim``)."""
    B, Tq, d = q.shape
    g = _mx.token_maxsim(q.reshape(B * Tq, d), doc_tokens, doc_mask, chunk=chunk)
    g = g.reshape(B, Tq, doc_tokens.shape[0])
    return torch.where(q_mask[:, :, None], g, 0.0).sum(1)


def fused_rerank_paged(q, q_mask, cand_ids, tok_pages, page_table, n_tokens,
                       k: int):
    """Paged exact-MaxSim rerank -> (scores, ids), (B, k).

    ``-1`` candidates score NEG and can only surface, id ``-1``, when a row
    has fewer than ``k`` real candidates; rows are padded out to ``k`` with
    (NEG, -1) when ``k > k'`` (the JAX wrapper's contract,
    ``repro/kernels/ops.py:168-199``)."""
    s = _gs.rerank_paged_scores(q, q_mask, cand_ids, tok_pages, page_table,
                                n_tokens)
    s = torch.where(cand_ids >= 0, s, NEG)
    kk = min(k, s.shape[1])
    top, idx = stable_topk(s, kk)
    out_ids = torch.gather(cand_ids, 1, idx)
    if kk < k:
        B = s.shape[0]
        top = torch.cat([top, top.new_full((B, k - kk), NEG)], 1)
        out_ids = torch.cat([out_ids, out_ids.new_full((B, k - kk), -1)], 1)
    return top, out_ids

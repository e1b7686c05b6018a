"""Public wrappers over the kernels (twin of ``repro/kernels/ops.py``; its
entries' arguments without ``use_kernel``, ``block_*`` or ``interpret``).

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
from repro_torch.kernels import mips_sq8 as _mq
from repro_torch.kernels import query_fused as _qf
from repro_torch.kernels.ref import NEG

#: every kernel wrapper, by name: the serving path's three, the build's
#: token MaxSim and the unpooled psi (the psi-pool kernel's other form), the
#: other search routes' one-launch IVF, dense scan and SQ8 scan (both
#: ``mips_sq8`` entries count on ``mips_sq8``), then the residual tier's
#: scan, rerank and one-launch IVF, and the sharded path's dense-store rerank
KERNELS = {
    "fused_psi_pool": _fp.fused_psi_pool,
    "ivf_probe_scan": _gs.ivf_probe_scan,
    "rerank_paged_scores": _gs.rerank_paged_scores,
    "token_maxsim": _mx.token_maxsim,
    "fused_psi": _fp.fused_psi,
    "query_fused": _qf.query_fused,
    "mips_topk": _qf.mips_topk,
    "mips_sq8": _mq.mips_sq8,
    "ivf_probe_res_scan": _gs.ivf_probe_res_scan,
    "rerank_paged_res_scores": _gs.rerank_paged_res_scores,
    "query_fused_res": _qf.query_fused_res,
    "rerank_gather_scores": _gs.rerank_gather_scores,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def token_maxsim(x, doc_tokens, doc_mask):
    """(n, d) x (m, T, d) -> (n, m) fp32 per-token MaxSim contributions,
    NEG for a doc with no valid token (``repro/kernels/ops.py:27``)."""
    return _mx.token_maxsim(x, doc_tokens, doc_mask)


def fused_psi(x, psi_params):
    """psi(x) = LN(GELU_tanh(x W' + b)): (n, d) -> (n, d') fp32
    (``repro/kernels/ops.py:48``).  ``psi_params`` is a
    :class:`~repro_torch.core.model.Psi`, or JAX's param dict
    (``{"dense": {"kernel", "bias"}, "ln": {"scale", "bias"}}``) with tensor
    leaves, as ``convert.psi_params_from_numpy`` makes it from JAX's."""
    if isinstance(psi_params, dict):
        dense, ln = psi_params["dense"], psi_params["ln"]
        w = (dense["kernel"], dense["bias"], ln["scale"], ln["bias"])
    else:
        w = (psi_params.dense.kernel, psi_params.dense.bias, psi_params.ln.scale,
             psi_params.ln.bias)
    return _fp.fused_psi(x, *w)


def fused_ivf_scan(q, probe, ids, vecs, scales=None):
    """Gather-at-source IVF probe scan (``repro/kernels/ops.py:100``): q (B,
    d'); probe (B, nprobe) int32; the index's padded lists ids (nlist, cap),
    vecs (nlist, cap, d') fp32 or int8 codes with scales (nlist, cap) ->
    (B, nprobe, cap) fp32, pad slots -inf."""
    return _gs.ivf_probe_scan(q, probe, ids, vecs, scales)


def fused_ivf_scan_res(q, probe, ids, codes, centroids, values):
    """Residual-tier IVF probe scan, the packed 2/4-bit codes decoded at the
    source (``repro/kernels/ops.py:119``): codes (nlist, cap, d' * bits / 8)
    uint8 coded against each list's centroid (nlist, d'), values (d',
    2^bits) -> (B, nprobe, cap) fp32, pad slots -inf."""
    return _gs.ivf_probe_res_scan(q, probe, ids, codes, centroids, values)


def maxsim_scores(q, q_mask, doc_tokens, doc_mask, *, chunk: int | None = None):
    """(B, Tq, d) -> (B, m): full MaxSim through the token kernel plus a
    masked sum over the query tokens (``chunk``: see ``token_maxsim``)."""
    B, Tq, d = q.shape
    g = _mx.token_maxsim(q.reshape(B * Tq, d), doc_tokens, doc_mask, chunk=chunk)
    g = g.reshape(B, Tq, doc_tokens.shape[0])
    return torch.where(q_mask[:, :, None], g, 0.0).sum(1)


def fused_rerank(q, q_mask, cand_ids, doc_tokens, doc_mask, k: int, *, doc_scales=None):
    """Dense-store exact-MaxSim rerank -> (scores, ids), (B, k): each
    candidate's (Td, d) slab read at the source, fp32 or SQ8 codes with
    ``doc_scales`` (m, Td) folded into the score rows.  The pad rules of
    :func:`fused_rerank_paged` (``repro/kernels/ops.py:138-165``)."""
    s = _gs.rerank_gather_scores(q, q_mask, cand_ids, doc_tokens, doc_mask, doc_scales)
    return _rerank_topk(s, cand_ids, k)


def fused_rerank_paged(q, q_mask, cand_ids, tok_pages, page_table, n_tokens,
                       k: int):
    """Paged exact-MaxSim rerank -> (scores, ids), (B, k).

    ``-1`` candidates score NEG and can only surface, id ``-1``, when a row
    has fewer than ``k`` real candidates; rows are padded out to ``k`` with
    (NEG, -1) when ``k > k'`` (the JAX wrapper's contract,
    ``repro/kernels/ops.py:168-199``)."""
    s = _gs.rerank_paged_scores(q, q_mask, cand_ids, tok_pages, page_table,
                                n_tokens)
    return _rerank_topk(s, cand_ids, k)


def fused_rerank_paged_res(q, q_mask, cand_ids, cent_pages, code_pages, page_table,
                           n_tokens, centroids, values, k: int):
    """:func:`fused_rerank_paged` over compressed pages (centroid-id pages,
    packed residual pages and the codec's centroids / values), decoded in
    the kernel (``repro/kernels/ops.py:202-231``)."""
    s = _gs.rerank_paged_res_scores(q, q_mask, cand_ids, cent_pages, code_pages,
                                    page_table, n_tokens, centroids, values)
    return _rerank_topk(s, cand_ids, k)


def _rerank_topk(s, cand_ids, k: int):
    """Pair scores (B, k') -> the stable top-k, -1 candidates at NEG, rows
    padded with (NEG, -1) past k'."""
    s = torch.where(cand_ids >= 0, s, NEG)
    kk = min(k, s.shape[1])
    top, idx = stable_topk(s, kk)
    out_ids = torch.gather(cand_ids, 1, idx)
    if kk < k:
        B = s.shape[0]
        top = torch.cat([top, top.new_full((B, k - kk), NEG)], 1)
        out_ids = torch.cat([out_ids, out_ids.new_full((B, k - kk), -1)], 1)
    return top, out_ids


def mips_sq8(q, codes, scales):
    """All-pairs SQ8 scan: (B, d) x (m, d) int8 with (m,) scales -> (B, m)."""
    return _mq.mips_sq8(q, codes, scales)


def mips_sq8_batched(q, codes, scales, *, chunk: int | None = None):
    """Per-query SQ8 scan: q (B, d) x codes (B, n, d) / scales (B, n) ->
    (B, n), each query against its own gathered rows, on the card always
    through the kernel (``chunk``: the plain version's query rows at a time)."""
    return _mq.mips_sq8_batched(q, codes, scales, chunk=chunk)


def fused_query(q_tokens, q_mask, psi, centroids, ids, vecs, scales=None, *,
                nprobe: int, kp: int):
    """One-launch first stage: the probe-select prelude (the pool through
    the psi-pool kernel, the (B, nlist) centroid product and the
    top-nprobe), which steers the scan and so runs before it, as in the JAX
    package; then ``query_fused`` on the prelude's pooled latent (the IVF
    scan by list and the top-kp: each query pooled once a search).
    Returns (scores, ids), (B, kp), short rows padded with (-inf, -1)."""
    w, psi_q, probe = _probe_select(q_tokens, q_mask, psi, centroids, nprobe)
    return _qf.query_fused(q_tokens, q_mask, *w, probe, ids, vecs, scales, kp=kp,
                           latent=psi_q)


def fused_query_res(q_tokens, q_mask, psi, centroids, ids, codes, values, *,
                    nprobe: int, kp: int):
    """:func:`fused_query` over residual lists (codes (nlist, cap, d' * bits
    / 8) uint8 against each list's own centroid, values (d', 2^bits)),
    ``query_fused_res`` on the prelude's latent
    (``repro/kernels/ops.py:265-290``)."""
    w, psi_q, probe = _probe_select(q_tokens, q_mask, psi, centroids, nprobe)
    return _qf.query_fused_res(q_tokens, q_mask, *w, probe, ids, codes, centroids, values,
                               kp=kp, latent=psi_q)


def _probe_select(q_tokens, q_mask, psi, centroids, nprobe: int):
    """The one-launch routes' prelude: psi's weights, the pooled queries
    (the psi-pool kernel) and their top-nprobe lists (the centroid product)."""
    w = (psi.dense.kernel, psi.dense.bias, psi.ln.scale, psi.ln.bias)
    psi_q = _fp.fused_psi_pool(q_tokens, q_mask, *w)
    return w, psi_q, stable_topk(psi_q @ centroids.T, nprobe)[1].to(torch.int32)


def mips_topk_fused(q, W, W_scales, kp: int, valid=None):
    """Dense latent scan + top-kp without the (B, m) score matrix: ids are
    row positions, ``valid=False`` rows keep theirs and score NEG."""
    return _qf.mips_topk(q, W, W_scales, valid, kp=kp)

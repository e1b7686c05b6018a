"""Bytes and operations a batch of searches needs, by layer.

Each count depends only on the work the inputs need, counted by the
reference's own probe selection and candidates (``reference.py``), never on
what implements it: rename a kernel or fuse two, and the count stays.

First stage: bytes are each distinct probed list's rows once, at the
tier's bytes a row (SQ8: d' codes, a scale and an id; residual: d' x bits / 8
codes and an id; fp32: 4 d' and an id), the centroids, psi's weights and the
query tokens once; operations are psi on the valid query tokens, the
queries' centroid products and each query's probed rows x d' x 2.

Rerank: bytes are the valid token rows of the distinct candidates once, at
the tier's bytes a token (fp32: 4 d; residual: a centroid id and d x bits / 8
codes), the queries, the candidate ids and the (B, k) outputs; operations
are every (query, candidate, valid query token, valid doc token) x d x 2.
"""
from __future__ import annotations

import torch


def row_bytes(cfg: dict) -> int:
    """Bytes of one IVF list row on the configuration's tier."""
    dp, ivf = int(cfg["d_prime"]), cfg["ivf"]
    if int(ivf["residual_bits"]):
        return dp * int(ivf["residual_bits"]) // 8 + 4
    return dp + 4 + 4 if ivf["sq8"] else 4 * dp + 4


def token_bytes(cfg: dict) -> int:
    """Bytes of one stored doc token on the configuration's tier."""
    d, res = int(cfg["d"]), cfg["residual"]
    return 4 + d * int(res["bits"]) // 8 if res["enabled"] else 4 * d


def first_stage(cfg: dict, list_counts, probes, qm) -> tuple[int, int]:
    """(bytes, operations) of the first stage of a batch: ``list_counts``
    (nlist,) rows a list, ``probes`` (B, nprobe) the lists each query
    scans, ``qm`` (B, Tq) the valid query tokens."""
    d, dp = int(cfg["d"]), int(cfg["d_prime"])
    B, Tq = qm.shape
    nlist = list_counts.shape[0]
    lc = list_counts.long()
    distinct_rows = int(lc[torch.unique(probes)].sum())
    scanned_rows = int(lc[probes.long()].sum())
    nbytes = (distinct_rows * row_bytes(cfg) + nlist * dp * 4 + (d * dp + 3 * dp) * 4
              + B * Tq * d * 4 + B * Tq)
    ops = 2 * int(qm.sum()) * d * dp + 2 * B * nlist * dp + 2 * scanned_rows * dp
    return nbytes, ops


def rerank(cfg: dict, doc_counts, cand, qm, k: int) -> tuple[int, int]:
    """(bytes, operations) of the rerank of a batch: ``doc_counts`` (m,)
    valid tokens a doc, ``cand`` (B, k') candidate ids (-1: none), ``qm``
    (B, Tq) the valid query tokens, ``k`` answers a query."""
    d = int(cfg["d"])
    B, Tq = qm.shape
    ok = cand >= 0
    n_doc = torch.where(ok, doc_counts[cand.clamp_min(0)], 0).long()
    distinct = torch.unique(cand[ok])
    nbytes = (int(doc_counts[distinct].sum()) * token_bytes(cfg) + B * Tq * d * 4 + B * Tq
              + cand.numel() * 4 + B * k * 8)
    ops = 2 * d * int((n_doc * qm.sum(1, keepdim=True)).sum())
    return nbytes, ops

"""PLAID-style token pruning (twin of ``repro/anns/token_pruning.py``).

1. Cluster the corpus's valid tokens (nlist = 16 sqrt(n) rounded down to a
   power of two, the paper's §6.3 rule) with k-means on a sample;
2. per query token, score the centroids and probe the top ``nprobe``;
3. a doc's approximate score is, summed over the query tokens, the best
   probed centroid score among the lists that hold one of its tokens
   (centroid interaction), floored at 0;
4. the exact MaxSim rerank of the top k' (the facade's).

``doc_lists`` (nlist, cap) holds the doc id of each member token, within a
list in flat token order (doc-major), ``-1`` padded; cap is the longest
list.  The JAX package fills it token by token; :func:`_pack` places the
same entries in one scatter.  The training sample is JAX's numpy draw
(``default_rng(0).choice``), which replays exactly; k-means and the
assignment are the port's (:mod:`repro_torch.anns.kmeans`).

The builds read the corpus through :meth:`CorpusView.chunks`, a chunk of
docs at a time, so the paged store is never held densely.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.anns import kmeans as _kmeans
from repro_torch.anns.base import CorpusView, stable_topk

_BUILD_DOCS = 16384           # docs read at a time by the builds
_ASSIGN_SCORES = 1 << 27      # entries of a (tokens, nlist) assignment block


class TokenPruningIndex(NamedTuple):
    centroids: torch.Tensor   # (nlist, d)
    doc_lists: torch.Tensor   # (nlist, cap) int32 doc id per member token, -1 pad
    counts: torch.Tensor      # (nlist,) int32


def plaid_nlist(n_tokens: int) -> int:
    raw = 16 * int(np.sqrt(max(n_tokens, 1)))
    return max(16, 1 << (raw.bit_length() - 1))


def sample_ids(n: int, train_sample: int) -> np.ndarray | None:
    """Flat positions of the k-means sample (JAX's draw), None for all."""
    if n <= train_sample:
        return None
    return np.random.default_rng(0).choice(n, train_sample, replace=False)


def _assign_block(nlist: int) -> int:
    return max(1, _ASSIGN_SCORES // max(nlist, 1))


def _flat(lo: int, toks, mask):
    """A chunk's valid tokens in flat order and the doc id of each."""
    n, T = mask.shape
    doc = (lo + torch.arange(n, device=mask.device))[:, None].expand(n, T)
    return toks[mask], doc[mask]


def _pack(assign: torch.Tensor, tok_doc: torch.Tensor, nlist: int, *,
          old: torch.Tensor | None = None):
    """Append each token's doc id to its list, within a list in flat order,
    after the ``old`` lists' stored entries -> (doc_lists, added counts)."""
    dev = assign.device
    added = torch.bincount(assign, minlength=nlist)
    fill = (old >= 0).sum(1) if old is not None else torch.zeros_like(added)
    old_cap = old.shape[1] if old is not None else 0
    cap = max(1, old_cap, int((fill + added).max()) if nlist else 0)
    out = torch.full((nlist, cap), -1, dtype=torch.int32, device=dev)
    if old is not None:
        out[:, :old_cap] = old
    order = torch.argsort(assign, stable=True)
    lists = assign[order]
    pos = (fill[lists] + torch.arange(len(order), device=dev)
           - (torch.cumsum(added, 0) - added)[lists])
    out[lists, pos] = tok_doc[order].to(torch.int32)
    return out, added


def training_sample(corpus: CorpusView, counts: list[int], train_sample: int) -> torch.Tensor:
    """The k-means sample: every valid token, or, past ``train_sample``,
    the flat positions of JAX's draw (:func:`sample_ids`) in the draw's
    order, gathered a chunk of docs at a time (``counts``: valid tokens a
    chunk of ``_BUILD_DOCS``)."""
    starts = np.cumsum([0] + list(counts))
    ridx = sample_ids(int(starts[-1]), train_sample)
    parts, where = [], []
    for c, (_, toks, mask) in enumerate(corpus.chunks(_BUILD_DOCS)):
        flat = toks[mask]
        if ridx is None:
            parts.append(flat)
            continue
        sel = np.flatnonzero((ridx >= starts[c]) & (ridx < starts[c + 1]))
        parts.append(flat[torch.as_tensor(ridx[sel] - starts[c], device=flat.device)])
        where.append(sel)
    sample = torch.cat(parts)
    if ridx is None:
        return sample
    inv = np.empty(len(ridx), np.int64)     # back to the draw's order
    inv[np.concatenate(where)] = np.arange(len(ridx))
    return sample[torch.as_tensor(inv, device=sample.device)]


def build_token_pruning(corpus: CorpusView, *, nlist: int = 0, kmeans_iters: int = 8,
                        train_sample: int = 262144, generator: torch.Generator | None = None,
                        centroids: torch.Tensor | None = None, clock=None) -> TokenPruningIndex:
    """The index over ``corpus``'s tokens, read a chunk of docs at a time:
    a pass to count the valid tokens, a pass to gather JAX's sample, k-means
    (seeded by ``generator``; ``centroids`` skips it), and a pass to assign
    every token.  ``clock(stage)``, when given, marks the end of each."""
    clock = clock or (lambda stage: None)
    if centroids is None:
        counts = [int(mask.sum()) for _, _, mask in corpus.chunks(_BUILD_DOCS)]
        nlist = min(nlist or plaid_nlist(sum(counts)), sum(counts))
        clock("count")
        sample = training_sample(corpus, counts, train_sample)
        clock("sample")
        centroids, _ = _kmeans.kmeans(sample, nlist, iters=kmeans_iters, generator=generator,
                                      block=_assign_block(nlist))
        del sample
        clock("kmeans")
    nlist = centroids.shape[0]
    assign, tok_doc = [], []
    for lo, toks, mask in corpus.chunks(_BUILD_DOCS):
        flat, doc = _flat(lo, toks, mask)
        assign.append(_kmeans.assign(flat, centroids, _assign_block(nlist)))
        tok_doc.append(doc.to(torch.int32))
    clock("assign")
    doc_lists, added = _pack(torch.cat(assign), torch.cat(tok_doc), nlist)
    clock("lists")
    return TokenPruningIndex(centroids, doc_lists, added.to(torch.int32))


def extend_token_pruning(index: TokenPruningIndex, doc_tokens, doc_mask,
                         m_old: int) -> TokenPruningIndex:
    """Assign the new docs' tokens to the frozen centroids and append them to
    their lists (capacity grows to the longest); new docs are numbered from
    ``m_old``."""
    flat, doc = _flat(m_old, doc_tokens, doc_mask)
    nlist = index.centroids.shape[0]
    assign = _kmeans.assign(flat, index.centroids, _assign_block(nlist))
    doc_lists, added = _pack(assign, doc, nlist, old=index.doc_lists)
    return TokenPruningIndex(index.centroids, doc_lists,
                             (index.counts + added).to(torch.int32))


def search_token_pruning(index: TokenPruningIndex, q, q_mask, *, nprobe: int,
                         k_prime: int, m: int):
    """q (B, Tq, d) -> (approx scores (B, k'), int64 ids (B, k')).

    The JAX package scans the query tokens in order, adding each token's
    ``max(scatter-max of its probed lists' scores, 0)`` to an (m,)
    accumulator.  Here each token's scatter-max reaches only the docs its
    probed lists hold (the stored prefix of each list), into a zeroed
    (B, m) buffer, and the accumulator adds those entries in the same token
    order (every other doc adds 0): the same sums."""
    B, Tq, _ = q.shape
    cent, lists = index.centroids, index.doc_lists
    nprobe = min(nprobe, cent.shape[0])
    dev = q.device
    fill = (lists >= 0).sum(1)
    acc = torch.zeros((B * m,), dtype=torch.float32, device=dev)
    tok = torch.zeros_like(acc)
    for t in range(Tq):
        ps, pr = stable_topk(q[:, t] @ cent.T, nprobe)                 # (B, nprobe)
        lens = torch.where(q_mask[:, t, None], fill[pr], 0).reshape(-1)
        total = int(lens.sum())
        if total == 0:
            continue
        pair = torch.repeat_interleave(torch.arange(B * nprobe, device=dev), lens,
                                       output_size=total)
        off = torch.arange(total, device=dev) - (torch.cumsum(lens, 0) - lens)[pair]
        docs = lists[pr.reshape(-1)[pair], off].long()
        at = torch.div(pair, nprobe, rounding_mode="floor") * m + docs
        tok.scatter_reduce_(0, at, ps.reshape(-1)[pair], "amax", include_self=True)
        acc[at] = acc[at] + tok[at]
        tok[at] = 0.0
    return stable_topk(acc.reshape(B, m), min(k_prime, m))


def search_token_pruning_direct(index: TokenPruningIndex, q, q_mask, *, nprobe: int,
                                k_prime: int, m: int):
    """The JAX package's form: each query token's probed lists gathered
    whole (pads scored -inf), scatter-maxed into an (m,) row of -inf, floored
    at 0 and added in token order.  For tests and a few queries."""
    B, Tq, _ = q.shape
    cent, lists = index.centroids, index.doc_lists
    nprobe = min(nprobe, cent.shape[0])
    acc = torch.zeros((B, m), dtype=torch.float32, device=q.device)
    for t in range(Tq):
        ps, pr = stable_topk(q[:, t] @ cent.T, nprobe)
        docs = lists[pr].reshape(B, -1)                              # (B, nprobe cap)
        val = ps[:, :, None].expand(B, nprobe, lists.shape[1]).reshape(B, -1)
        val = torch.where((docs >= 0) & q_mask[:, t, None], val, float("-inf"))
        tok = torch.full((B, m), float("-inf"), device=q.device)
        tok.scatter_reduce_(1, docs.clamp_min(0).long(), val, "amax")
        acc = acc + tok.clamp_min(0.0)
    return stable_topk(acc, min(k_prime, m))

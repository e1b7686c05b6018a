"""Distributed LEMUR on ``torch.distributed``: corpus-sharded serving and
the zero-communication OLS index step (twin of ``repro/dist/serve.py``).

Serving (Fig. 1 at pod scale): the latent rows W and the dense doc-token
store are block-sharded over the *flattened* mesh, a
``torch.distributed.device_mesh.DeviceMesh``: the rank at row-major mesh
coordinate ``idx`` (the JAX ``axis_index`` fold) holds rows ``[idx * rows,
(idx + 1) * rows)``.  Every rank gets the same query batch (SPMD), pools it
with the psi-pool kernel, runs latent scan -> local top-k' -> local exact
rerank on its own block, and only the (k, score) pairs cross the wire: for
each mesh axis in mesh order an ``all_gather`` over that axis' group,
concatenated in the group's rank order, then a stable top-k (the order of
JAX's tiled ``all_gather`` and ``lax.top_k``, so ties break the same way).
Every rank returns the merged (B, k).

Indexing (§4.3): the Gram factor is small and every rank holds it; each
rank fits the W rows of its own doc block with no communication.

The facade entry point is :meth:`repro_torch.retriever.LemurRetriever.shard`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.anns.base import stable_topk
from repro_torch.core import maxsim
from repro_torch.core.model import Psi, pool_queries
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG

#: rows of a SQ8 W block widened to fp32 at a time for the latent product
WIDEN_ROWS = 65536


def corpus_axes(mesh) -> tuple:
    """The mesh axes the corpus is sharded over: all of them, in mesh order
    (their names, or their indices on a mesh without names), of a mesh or
    of its {axis: size}."""
    from repro_torch.dist.sharding import axis_sizes

    return tuple(axis_sizes(mesh))


def n_corpus_shards(mesh) -> int:
    from repro_torch.dist.sharding import axis_sizes

    return int(np.prod(list(axis_sizes(mesh).values())))


def shard_index(mesh) -> int:
    """This rank's shard: its mesh coordinate folded row-major."""
    idx = 0
    for c, size in zip(mesh.get_coordinate(), mesh.shape):
        idx = idx * size + c
    return idx


def local_rows(mesh, n_rows: int) -> slice:
    """The block of ``n_rows`` (a multiple of the shard count) this rank
    holds: the port's side of ``state_shardings``, where every corpus-sized
    leaf is block-sharded and psi is replicated."""
    rows = n_rows // n_corpus_shards(mesh)
    s = shard_index(mesh)
    return slice(s * rows, (s + 1) * rows)


def state_shardings(mesh, state=None):
    """The partition specs of a ``ShardedRetrievalState``: psi whole (as the
    JAX twin's psi tree), every corpus-sized leaf split over
    ``corpus_axes(mesh)`` (the JAX twin's ``state_shardings``).  With
    ``state`` given, its scale fields' presence is mirrored."""
    from repro_torch.dist.sharding import P

    corpus, whole = P(corpus_axes(mesh)), P()
    has_scales = state is None or state.W_scales is not None
    return ShardedRetrievalState(
        psi={"dense": {"kernel": whole, "bias": whole}, "ln": {"scale": whole, "bias": whole}},
        W=corpus, doc_tokens=corpus, doc_mask=corpus, row_ids=corpus, row_valid=corpus,
        W_scales=corpus if has_scales else None,
        doc_scales=corpus if has_scales else None)


class ShardedRetrievalState(NamedTuple):
    """This rank's tensors for the serving step, on its device (the JAX
    state's fields; the slot map is always present here).

    With scales present, W / doc_tokens are int8 SQ codes with per-row /
    per-token scales.  ``row_ids`` / ``row_valid`` map the block's physical
    rows to external doc ids (``-1`` for free rows) and mask free and
    tombstoned rows out of the latent scan."""
    psi: Psi
    W: torch.Tensor                         # (rows, d') fp32 or int8 codes
    doc_tokens: torch.Tensor                # (rows, Td, d) fp32 or int8 codes
    doc_mask: torch.Tensor                  # (rows, Td) bool
    row_ids: torch.Tensor                   # (rows,) int32 external ids, -1 free
    row_valid: torch.Tensor                 # (rows,) bool occupied and alive
    W_scales: torch.Tensor | None = None    # (rows,) per-row scales (SQ8)
    doc_scales: torch.Tensor | None = None  # (rows, Td) per-token scales


def latent_scores(psi_q, W, W_scales=None):
    """psi_q @ W.T (B, rows) fp32, times the row scales for SQ8 codes, which
    are widened WIDEN_ROWS rows at a time (a whole widened block of 2^20 x
    2048 would be 8.6 GB); the product itself is a plain matmul, as the JAX
    package leaves it to XLA."""
    if W_scales is None:
        return psi_q @ W.T.to(psi_q.dtype)
    out = torch.empty((psi_q.shape[0], W.shape[0]), dtype=torch.float32, device=psi_q.device)
    for s in range(0, W.shape[0], WIDEN_ROWS):
        out[:, s:s + WIDEN_ROWS] = psi_q @ W[s:s + WIDEN_ROWS].T.float()
    return out.mul_(W_scales[None, :].float())


def _local_retrieve(psi_q, state: ShardedRetrievalState, q_tokens, q_mask, *, k: int,
                    k_prime: int, use_fused_gather: bool = True, use_one_launch: bool = False):
    """One rank's part: latent scan of its block -> top-k' -> exact rerank
    -> (scores, global ids), (B, min(k, k')) (``repro/dist/serve.py:89-181``).

    * latent scan: ``use_one_launch`` the ``mips_topk`` kernel (the (B,
      rows) score matrix never exists), else :func:`latent_scores` and a
      stable top-k'; invalid rows score NEG and keep their positions;
    * rerank: ``use_fused_gather`` the ``rerank_gather_scores`` kernel over
      the dense block (SQ8 scales folded into the score rows); otherwise,
      for SQ8, the gathered slab contracted with the scale fold, and for
      fp32 ``maxsim.rerank``;
    * ids: local rows through ``row_ids`` (free rows and ``-1`` pads stay
      ``-1``)."""
    kp = min(k_prime, state.W.shape[0])
    if use_one_launch:
        _, cand = ops.mips_topk_fused(psi_q, state.W, state.W_scales, kp, state.row_valid)
    else:
        s = latent_scores(psi_q, state.W, state.W_scales)
        s.masked_fill_(~state.row_valid[None, :], NEG)
        cand = stable_topk(s, kp)[1].to(torch.int32)
        del s
    kk = min(k, kp)
    if use_fused_gather:
        scores, local_ids = ops.fused_rerank(q_tokens, q_mask, cand, state.doc_tokens,
                                             state.doc_mask, kk, doc_scales=state.doc_scales)
    elif state.doc_scales is not None:
        c = cand.long()
        # the per-token scale folds into the score rows: score(q, s c) = s (q . c)
        sc = torch.einsum("bqd,bmtd->bmqt", q_tokens, state.doc_tokens[c].to(q_tokens.dtype))
        sc = sc * state.doc_scales[c].float()[:, :, None, :]
        sc = torch.where(state.doc_mask[c][:, :, None, :], sc, NEG)
        best = torch.where(q_mask[:, None, :], sc.amax(-1), 0.0)
        scores, pos = stable_topk(best.sum(-1), kk)
        local_ids = torch.gather(cand, 1, pos)
    else:
        scores, local_ids = maxsim.rerank(q_tokens, q_mask, cand, state.doc_tokens,
                                          state.doc_mask, kk)
    gids = torch.where(local_ids >= 0, state.row_ids[local_ids.clamp_min(0).long()], -1)
    return scores, gids.to(torch.int32)


def merge(mesh, scores, ids, k: int):
    """The hierarchical merge: for each mesh axis in mesh order, gather every
    rank's (B, w) pairs over that axis' group, concatenate them in the
    group's rank order and keep the stable top-k.  Every rank returns the
    same (B, min(k, width))."""
    for ax in corpus_axes(mesh):
        group = mesh.get_group(ax)
        n = dist.get_world_size(group)
        parts_s = [torch.empty_like(scores) for _ in range(n)]
        parts_i = [torch.empty_like(ids) for _ in range(n)]
        dist.all_gather(parts_s, scores.contiguous(), group=group)
        dist.all_gather(parts_i, ids.contiguous(), group=group)
        all_s, all_i = torch.cat(parts_s, 1), torch.cat(parts_i, 1)
        scores, pos = stable_topk(all_s, min(k, all_s.shape[1]))
        ids = torch.gather(all_i, 1, pos)
    return scores, ids


def default_k_prime_local(cfg_k: int, cfg_k_prime: int, n_shards: int) -> int:
    """Per-shard candidate budget: the paper's k' is a global budget; with N
    corpus shards the expected share is k'/N, and a 4x oversample keeps the
    merge's recall while bounding each rank's rerank."""
    return max(cfg_k, (4 * cfg_k_prime + n_shards - 1) // n_shards)


def make_serve_step(mesh, cfg, *, k_prime_local: int | None = None,
                    use_fused_gather: bool | None = None, use_one_launch: bool | None = None):
    """Returns ``serve_step(state, q_tokens, q_mask) -> (scores, ids)``,
    (B, min(k, width)) on every rank: pool (the psi-pool kernel), this
    rank's :func:`_local_retrieve`, then :func:`merge`.  The defaults are
    the JAX step's: ``k_prime_local`` from :func:`default_k_prime_local`,
    the flags from ``cfg``.  The block holds decoded rows, so the residual
    tier's ``use_residual`` does not reach the step."""
    if k_prime_local is None:
        k_prime_local = default_k_prime_local(cfg.k, cfg.k_prime, n_corpus_shards(mesh))
    if use_fused_gather is None:
        use_fused_gather = cfg.use_fused_gather
    if use_one_launch is None:
        use_one_launch = cfg.use_one_launch

    def serve_step(state: ShardedRetrievalState, q_tokens, q_mask):
        psi_q = pool_queries(state.psi, q_tokens, q_mask)
        scores, ids = _local_retrieve(
            psi_q, state, q_tokens, q_mask, k=cfg.k, k_prime=k_prime_local,
            use_fused_gather=bool(use_fused_gather), use_one_launch=bool(use_one_launch))
        return merge(mesh, scores, ids, cfg.k)

    return serve_step


def make_index_step(mesh, cfg, *, doc_block: int = 128):
    """Returns ``index_step(chol, feats, x_ols, doc_tokens, doc_mask, mean,
    std) -> W rows`` of this rank's doc block: token MaxSim targets over the
    OLS tokens (the ``token_maxsim`` kernel on a CUDA device, ``doc_block``
    docs a chunk on the CPU), standardized, then the Cholesky solve against
    the replicated lower factor (``core/indexer.gram_factor``).  No
    communication."""
    del mesh, cfg   # every rank solves its own block alike

    def index_step(chol, feats, x_ols, doc_tokens, doc_mask, mean, std):
        g = maxsim.token_maxsim(x_ols, doc_tokens, doc_mask, block=doc_block)
        g = (g - mean) / std
        return torch.cholesky_solve(feats.T @ g, chol).T

    return index_step

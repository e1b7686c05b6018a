"""LemurRetriever, serving side (twin of ``repro/retriever/facade.py``).

    r = LemurRetriever.load("my_index/")              # a JAX-saved index, on the card
    scores, ids = r.search(q_tokens, q_mask, SearchParams(k=10))

The default route is the one ported: psi-pool (fused kernel) -> centroid
scores -> top-nprobe -> SQ8/fp32 probe scan (kernel) -> flat top-k' ->
tombstone mask -> paged exact-MaxSim rerank (kernel) -> top-k.  The routes
not ported yet raise ``NotImplementedError`` naming their ROADMAP item.
PyTorch runs eagerly, so there is no compile cache to account for.
"""
from __future__ import annotations

import pathlib

import torch

from repro_torch.anns.ivf import build_ivf, search_ivf
from repro_torch.checkpoint import manager as ckpt
from repro_torch.common.device import resolve_device
from repro_torch.convert import index_from_numpy
from repro_torch.core import pages
from repro_torch.core.config import LemurConfig
from repro_torch.core.index import LemurIndex
from repro_torch.core.model import Psi, TargetStats, pool_queries
from repro_torch.kernels import ops
from repro_torch.retriever.params import SearchParams, effective_nprobe

FORMAT = "lemur-retriever-v1"


def _check_route(params: SearchParams) -> None:
    if not params.use_ann:
        raise NotImplementedError(
            "exact latent scan (use_ann=False) is not ported yet "
            "(ROADMAP Queue 1 item 5)")
    if params.use_one_launch or params.backend.use_one_launch:
        raise NotImplementedError(
            "one-launch first stage (use_one_launch=True) is not ported yet "
            "(ROADMAP Queue 2 item 5, query_fused)")
    if not params.backend.use_fused_gather:
        raise NotImplementedError(
            "legacy gathered IVF scan (IVFSearchParams.use_fused_gather=False) "
            "is not ported yet (ROADMAP Queue 2 item 8, mips_sq8)")
    if not params.use_fused_gather:
        raise NotImplementedError(
            "legacy gathered rerank (use_fused_gather=False) is not ported yet "
            "(ROADMAP Queue 1 item 4)")
    if params.use_residual:
        raise NotImplementedError(
            "residual token tier (use_residual=True) is not ported yet "
            "(ROADMAP Queue 1 item 6)")


def first_stage(index: LemurIndex, q_tokens, q_mask, params: SearchParams):
    """Pool the queries and run the IVF first stage -> (B, k') candidate ids,
    tombstoned slots masked to -1.  ``params`` must be resolved."""
    _check_route(params)
    psi_q = pool_queries(index.psi, q_tokens, q_mask)           # (B, d')
    nprobe = effective_nprobe(params.backend.nprobe, index.ann.nlist)
    _, cand = search_ivf(index.ann, psi_q, nprobe, params.k_prime)
    return pages.mask_dead(index.store, cand)


def search_pipeline(index: LemurIndex, q_tokens, q_mask, params: SearchParams):
    """pool -> first-stage candidates -> paged exact-MaxSim rerank -> top-k.
    ``-1`` candidates (pads, tombstones) score NEG and never outrank a real
    one."""
    cand = first_stage(index, q_tokens, q_mask, params)
    st = index.store
    return ops.fused_rerank_paged(q_tokens, q_mask, cand, st.tok_pages,
                                  st.page_table, st.n_tokens, params.k)


def launch_plan(resolved: SearchParams) -> dict[str, int]:
    """Per-search launch breakdown of the ported route, as the JAX package
    counts it: projection (psi-pool kernel), scan (probe-scan kernel), the
    flat top-k', and the rerank kernel."""
    _check_route(resolved)
    return {"projection": 1, "scan": 1, "topk": 1, "rerank": 1}


class LemurRetriever:
    """Serves a :class:`LemurIndex` (see module docstring)."""

    def __init__(self, index: LemurIndex):
        self._index = index
        self._resolve_memo: dict[SearchParams | None, SearchParams] = {}

    @property
    def index(self) -> LemurIndex:
        return self._index

    @property
    def cfg(self) -> LemurConfig:
        return self._index.cfg

    @property
    def backend(self) -> str:
        return self._index.backend

    @property
    def m(self) -> int:
        return self._index.m

    @property
    def n_alive(self) -> int:
        return self._index.n_alive

    @property
    def device(self) -> torch.device:
        return self._index.device

    def __repr__(self) -> str:
        return (f"LemurRetriever(m={self.m}, d_prime={self.cfg.d_prime}, "
                f"backend={self.backend!r}, device={self.device})")

    @classmethod
    def load(cls, directory, *, step: int | None = None,
             device="cuda") -> "LemurRetriever":
        """Serve a ``lemur-retriever-v1`` checkpoint saved by the JAX
        package's ``LemurRetriever.save``."""
        dev = resolve_device(device)
        tree, manifest = ckpt.restore(pathlib.Path(directory), step)
        extra = manifest.get("extra", {})
        if extra.get("format") != FORMAT:
            raise ValueError(f"{directory} is not a {FORMAT} checkpoint "
                             f"(format={extra.get('format')!r})")
        return cls(index_from_numpy(tree, extra, dev))

    @classmethod
    def from_arrays(cls, cfg: LemurConfig, psi: Psi, store: pages.PagedStore, *,
                    generator: torch.Generator | None = None) -> "LemurRetriever":
        """Serve a psi and a filled paged store: the IVF first stage is built
        over the store's W rows (``cfg.ivf``: nlist, SQ8), k-means seeded by
        ``generator``.  Target stats are the identity (mean 0, std 1)."""
        cfg.backend_config()
        W = store.W[: int(store.n_docs[0])]
        ann = build_ivf(W, cfg.ivf.nlist, sq8=cfg.ivf.sq8, generator=generator)
        one = torch.ones((), device=store.W.device)
        return cls(LemurIndex(cfg, psi, TargetStats(0 * one, one), store, "ivf", ann))

    def resolve(self, params: SearchParams | None = None) -> SearchParams:
        """Fill a (possibly partial) SearchParams from the build config
        (memoized)."""
        resolved = self._resolve_memo.get(params)
        if resolved is None:
            resolved = (params or SearchParams()).resolve(self.cfg, self.backend)
            self._resolve_memo[params] = resolved
        return resolved

    def launches(self, params: SearchParams | None = None) -> dict[str, int]:
        return launch_plan(self.resolve(params))

    @torch.inference_mode()
    def search(self, q_tokens, q_mask=None, params: SearchParams | None = None):
        """q_tokens: (B, Tq, d) -> (scores (B, k) fp32, doc ids (B, k) int32),
        on the index's device; q_mask (B, Tq) defaults to all tokens."""
        dev = self.device
        q_tokens = torch.as_tensor(q_tokens, dtype=torch.float32).to(dev).contiguous()
        if q_mask is None:
            q_mask = torch.ones(q_tokens.shape[:2], dtype=torch.bool, device=dev)
        q_mask = torch.as_tensor(q_mask).to(device=dev, dtype=torch.bool).contiguous()
        return search_pipeline(self._index, q_tokens, q_mask, self.resolve(params))

"""LemurIndex: the built index a retriever serves, and the v0 free
functions (twin of ``repro/core/index.py``).

:class:`LemurIndex` holds cfg, ψ, the target stats, the paged corpus store
and the first stage's name and state.  Its dense views (``doc_tokens``,
``doc_mask``, :meth:`LemurIndex.dense_view`) materialise the whole corpus
from the pages, deleted slots all-masked, for v0 consumers and ground truth;
the search path reads the pages directly.

The free functions (:func:`build_index`, :func:`attach_backend`,
:func:`add_docs`, :func:`query`, :func:`candidates`) are thin shims over
:class:`repro_torch.retriever.LemurRetriever`, as the JAX package's are.
Where JAX takes a ``PRNGKey`` they take a CPU ``torch.Generator`` (or
``None``: seed 0); :func:`build_index` takes ``device`` (default the card).
New code should prefer::

    from repro_torch.retriever import LemurRetriever, SearchParams
    r = LemurRetriever.build(corpus, cfg)
    scores, ids = r.search(q_tokens, q_mask, SearchParams(k=10))
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core import pages
from repro_torch.core.config import LemurConfig
from repro_torch.core.model import Psi, TargetStats
from repro_torch.core.pages import PagedStore


class LemurIndex(NamedTuple):
    cfg: LemurConfig
    psi: Psi                  # feature encoder
    stats: TargetStats        # target standardization (App. A)
    store: PagedStore         # paged corpus: W rows + token pages + tombstones
    backend: str              # registered first-stage backend name
    ann: Any                  # opaque first-stage state

    @classmethod
    def from_dense(cls, cfg, psi, stats, W, doc_tokens, doc_mask, backend,
                   ann, *, codec=None) -> "LemurIndex":
        """Build from the dense padded layout, on ``doc_tokens``' device (the
        JAX classmethod's positional order); ``codec`` (a trained
        :class:`~repro_torch.anns.quantization.ResidualCodec`) keeps the
        tokens in the compressed tier."""
        store, _ = pages.from_dense(W, doc_tokens, doc_mask, codec=codec)
        return cls(cfg, psi, stats, store, backend, ann)

    @property
    def m(self) -> int:
        """Slot high-water mark (ids are stable slot indices)."""
        return int(self.store.n_docs[0])

    @property
    def n_alive(self) -> int:
        return int(self.store.alive.sum())

    @property
    def device(self):
        return self.store.tok_pages.device

    @property
    def W(self) -> torch.Tensor:
        """The latent rows of slots [0, m): a view of the store's."""
        return self.store.W[: self.m]

    def read_docs(self, lo: int, hi: int):
        """(tokens (n, td_max, d), mask (n, td_max)) of slots [lo, hi) from
        the pages, decoded on the compressed tier, deleted slots all-masked:
        a chunk of the JAX ``dense_view``, for builds that must not hold the
        whole dense corpus."""
        return pages.gather_docs(self.store, torch.arange(lo, hi, device=self.device))

    @property
    def doc_tokens(self) -> torch.Tensor:
        return self.dense_view()[0]

    @property
    def doc_mask(self) -> torch.Tensor:
        return self.dense_view()[1]

    def dense_view(self):
        """(doc_tokens (m, Tm, d), doc_mask (m, Tm)) materialised from the
        pages (decoded on the compressed tier), deleted slots all-masked.
        ``Tm`` is the page-rounded token bound (``store.td_max``)."""
        return self.read_docs(0, self.m)


def _legacy_params(index: LemurIndex, *, k=None, k_prime=None, nprobe=None,
                   use_ann=True):
    """Map the v0 loose keywords onto a resolved SearchParams."""
    from repro_torch.anns import registry
    from repro_torch.retriever.params import SearchParams

    backend = None
    if nprobe is not None and use_ann:
        cls = registry.get_params_cls(index.backend)
        if "nprobe" in cls.__dataclass_fields__:
            backend = cls(nprobe=int(nprobe))
    return SearchParams(k=k, k_prime=k_prime, use_ann=use_ann,
                        backend=backend).resolve(index.cfg, index.backend)


def build_index(generator, corpus, cfg: LemurConfig, *, x_train: np.ndarray | None = None,
                verbose: bool = False, device="cuda") -> LemurIndex:
    """v0 shim: ``LemurRetriever.build(...).index`` (``generator``: a CPU
    ``torch.Generator`` or None, where JAX takes a key)."""
    from repro_torch.retriever import LemurRetriever

    return LemurRetriever.build(corpus, cfg, generator=generator, x_train=x_train,
                                device=device, verbose=verbose).index


def attach_backend(index: LemurIndex, backend: str, generator=None,
                   cfg: LemurConfig | None = None) -> LemurIndex:
    """v0 shim: ``LemurRetriever(index).with_backend(...).index``: another
    first stage over the same ψ, W and store, without re-training."""
    from repro_torch.retriever import LemurRetriever

    return LemurRetriever(index).with_backend(backend, generator=generator, cfg=cfg).index


def add_docs(index: LemurIndex, doc_tokens, doc_mask, solver_state=None, *,
             seed: int = 0) -> LemurIndex:
    """v0 shim: ``LemurRetriever(index).add(...).index``.  The build's
    ``solver_state`` gives bit-exact W rows; without it the fallback solver
    draws its OLS tokens from the corpus with ``seed``.  ``index`` is left
    as it was: the retriever copies each tensor before it writes it."""
    from repro_torch.retriever import LemurRetriever

    r = LemurRetriever(index, solver_state=solver_state)
    return r.add(doc_tokens, doc_mask, seed=seed).index


def queries_on(index: LemurIndex, q_tokens, q_mask):
    """(q_tokens fp32, q_mask bool, all tokens when None) as contiguous
    tensors on the index's device."""
    dev = index.device
    q_tokens = torch.as_tensor(q_tokens, dtype=torch.float32).to(dev).contiguous()
    if q_mask is None:
        q_mask = torch.ones(q_tokens.shape[:2], dtype=torch.bool, device=dev)
    return q_tokens, torch.as_tensor(q_mask).to(device=dev, dtype=torch.bool).contiguous()


@torch.inference_mode()
def query(index: LemurIndex, q_tokens, q_mask=None, *, k: int | None = None,
          k_prime: int | None = None, nprobe: int | None = None,
          use_ann: bool = True):
    """q_tokens: (B, Tq, d) -> (scores (B, k), doc ids (B, k) int32) on the
    index's device, through ``facade.search_pipeline`` with the keywords
    resolved into a ``SearchParams``.  ``use_ann=False`` is the exact latent
    scan whatever the backend."""
    from repro_torch.retriever.facade import search_pipeline

    params = _legacy_params(index, k=k, k_prime=k_prime, nprobe=nprobe, use_ann=use_ann)
    return search_pipeline(index, *queries_on(index, q_tokens, q_mask), params)


@torch.inference_mode()
def candidates(index: LemurIndex, q_tokens, q_mask=None, *, k_prime: int,
               nprobe: int | None = None, use_ann: bool = False):
    """First-stage candidate ids only, (B, k') int32, tombstones -1 (for
    recall@k' ablations, Fig. 2 left)."""
    from repro_torch.retriever.facade import first_stage

    params = _legacy_params(index, k_prime=k_prime, nprobe=nprobe, use_ann=use_ann)
    return first_stage(index, *queries_on(index, q_tokens, q_mask), params)

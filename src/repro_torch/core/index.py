"""LemurIndex: the built index a retriever serves (twin of
``repro/core/index.py``'s ``LemurIndex``)."""
from __future__ import annotations

from typing import Any, NamedTuple

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

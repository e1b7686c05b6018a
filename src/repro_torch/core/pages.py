"""Paged corpus memory, fp32 tier (twin of ``repro/core/pages.py``).

* ``tok_pages (P, page, d)`` — the page pool; each page holds
  ``TOKENS_PER_PAGE`` compacted (mask-stripped) token embeddings, a doc's
  tokens span ``ceil(n_tokens / page)`` pages, the last one zero-padded.
* ``page_table (C, pmax)`` + ``n_tokens (C,)`` — per-slot indirection,
  ``-1`` pads unused table entries.
* ``W (C, d')`` latent rows, ``alive (C,)`` tombstones, ``n_docs (1,)`` the
  slot high-water mark.  Doc ids are slot indices.

The pool, the slot capacity and the table width are powers of two, as in
the JAX package.  :func:`from_dense` builds a store from the dense padded
layout; :func:`allocate` plus :func:`write_docs` fill the same store a chunk
of docs at a time, for corpora whose dense layout does not fit in memory
(they write in place).  :func:`gather_docs` materialises candidates from
the pages for the legacy gathered rerank.  Mutation (add/delete) is ROADMAP
Queue 1 item 4.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.common.device import resolve_device

TOKENS_PER_PAGE = 16   # power of two — the paged-KV NUM_TOKENS_IN_BLOCK
MIN_CAPACITY = 8       # smallest doc-slot bucket


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1)."""
    return 1 if n <= 1 else 1 << int(n - 1).bit_length()


class PagedStore(NamedTuple):
    tok_pages: torch.Tensor   # (P, page, d) fp32 compacted token embeddings
    page_table: torch.Tensor  # (C, pmax) int32 page ids, -1 padded
    n_tokens: torch.Tensor    # (C,) int32 real tokens per slot
    W: torch.Tensor           # (C, d') latent rows (dead slots zeroed)
    alive: torch.Tensor       # (C,) bool tombstone mask
    n_docs: torch.Tensor      # (1,) int32 slot high-water mark

    @property
    def n_pages(self) -> int:
        return self.tok_pages.shape[0]

    @property
    def page(self) -> int:
        return self.tok_pages.shape[1]

    @property
    def d(self) -> int:
        return self.tok_pages.shape[2]

    @property
    def capacity(self) -> int:
        return self.page_table.shape[0]

    @property
    def pages_per_doc(self) -> int:
        return self.page_table.shape[1]

    @property
    def d_prime(self) -> int:
        return self.W.shape[1]

    def to(self, device) -> "PagedStore":
        return PagedStore(*(t.to(device) for t in self))


def pages_needed(n_tokens: torch.Tensor, page: int = TOKENS_PER_PAGE) -> torch.Tensor:
    """Pages each doc takes: ceil(n_tokens / page)."""
    return (n_tokens.long() + page - 1) // page


def allocate(m: int, n_pages: int, pmax: int, d: int, d_prime: int, *,
             page: int = TOKENS_PER_PAGE, min_capacity: int = MIN_CAPACITY,
             device="cuda") -> PagedStore:
    """An empty store sized for ``m`` docs over ``n_pages`` pages of at most
    ``pmax`` pages each (capacity and pool rounded up to powers of two), on
    ``device``."""
    device = resolve_device(device)
    C = max(min_capacity, next_pow2(m))
    P = next_pow2(max(1, n_pages))
    return PagedStore(
        tok_pages=torch.zeros((P, page, d), dtype=torch.float32, device=device),
        page_table=torch.full((C, max(1, pmax)), -1, dtype=torch.int32, device=device),
        n_tokens=torch.zeros((C,), dtype=torch.int32, device=device),
        W=torch.zeros((C, d_prime), dtype=torch.float32, device=device),
        alive=torch.zeros((C,), dtype=torch.bool, device=device),
        n_docs=torch.zeros((1,), dtype=torch.int32, device=device))


def write_docs(store: PagedStore, first_slot: int, first_page: int, W,
               doc_tokens, doc_mask) -> int:
    """Write n docs into slots ``[first_slot, first_slot + n)`` and pages
    from ``first_page`` on, in place: valid tokens compacted in doc-major
    order, ``ceil(n_tokens / page)`` pages a doc (the JAX ``_paginate``
    layout).  Returns the number of pages written."""
    dm = doc_mask.bool()
    n = dm.shape[0]
    page, pmax = store.page, store.pages_per_doc
    dev = store.tok_pages.device
    counts = dm.sum(1)
    ppd = pages_needed(counts, page)
    if n and int(ppd.max()) > pmax:
        raise ValueError(f"doc needs {int(ppd.max())} pages > pmax={pmax}")
    starts = first_page + torch.cumsum(ppd, 0) - ppd
    need = int(ppd.sum())
    if first_page + need > store.n_pages or first_slot + n > store.capacity:
        raise ValueError("store too small for these docs")
    j = torch.arange(pmax, device=dm.device)
    table = torch.where(j[None, :] < ppd[:, None], starts[:, None] + j, -1)
    flat = doc_tokens[dm].to(device=dev, dtype=torch.float32)   # (k, d)
    tok_start = torch.cumsum(counts, 0) - counts
    t = torch.arange(flat.shape[0], device=dm.device) - torch.repeat_interleave(tok_start, counts)
    rows = torch.repeat_interleave(starts, counts) + t // page
    store.tok_pages[rows.to(dev), (t % page).to(dev)] = flat
    sl = slice(first_slot, first_slot + n)
    store.page_table[sl] = table.to(device=dev, dtype=torch.int32)
    store.n_tokens[sl] = counts.to(device=dev, dtype=torch.int32)
    store.W[sl] = torch.as_tensor(W).to(device=dev, dtype=store.W.dtype)
    store.alive[sl] = True
    store.n_docs.clamp_(min=first_slot + n)
    return need


def from_dense(W, doc_tokens, doc_mask, *, page: int = TOKENS_PER_PAGE,
               min_capacity: int = MIN_CAPACITY):
    """Build a :class:`PagedStore` from the dense padded layout, on
    ``doc_tokens``' device.  Returns ``(store, bytes_moved)``, the bytes the
    JAX ``from_dense`` reports for the same build."""
    dm = doc_mask.bool()
    m, _, d = doc_tokens.shape
    ppd = pages_needed(dm.sum(1), page)
    pmax = max(1, int(ppd.max()) if m else 1)
    need = int(ppd.sum())
    store = allocate(m, need, pmax, d, W.shape[1], page=page,
                     min_capacity=min_capacity, device=doc_tokens.device)
    write_docs(store, 0, 0, W, doc_tokens, dm)
    moved = (need * page * d * 4 + store.page_table.numel() * 4
             + store.n_tokens.numel() * 4 + store.W.numel() * store.W.element_size()
             + store.alive.numel())
    return store, moved


def mask_dead(store: PagedStore, cand_ids: torch.Tensor) -> torch.Tensor:
    """Tombstone filter: candidate ids of deleted slots -> ``-1``."""
    ok = (cand_ids >= 0) & store.alive[cand_ids.clamp_min(0).long()]
    return torch.where(ok, cand_ids, -1)


def gather_docs(store: PagedStore, doc_ids: torch.Tensor):
    """Materialise docs from their pages: ``(...,)`` slot ids -> (tokens
    ``(..., pmax * page, d)``, mask ``(..., pmax * page)`` bool), the
    tokens zeroed past ``n_tokens``.  ``-1`` ids give an all-False mask and
    zero tokens.  The same token values in the same positions as the paged
    rerank kernel reads."""
    safe = doc_ids.clamp_min(0).long()
    table = store.page_table[safe].long()                    # (..., pmax)
    nt = torch.where(doc_ids >= 0, store.n_tokens[safe], 0)
    toks = store.tok_pages[table.clamp_min(0)]               # (..., pmax, page, d)
    toks = toks.reshape(*doc_ids.shape, store.pages_per_doc * store.page, store.d)
    mask = torch.arange(toks.shape[-2], device=toks.device) < nt[..., None]
    return toks.mul_(mask[..., None]), mask                  # toks is a fresh copy

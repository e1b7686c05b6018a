"""Paged corpus memory (twin of ``repro/core/pages.py``).

* ``tok_pages (P, page, d)`` — the page pool; each page holds
  ``TOKENS_PER_PAGE`` compacted (mask-stripped) token embeddings, a doc's
  tokens span ``ceil(n_tokens / page)`` pages, the last one zero-padded.
* ``page_table (C, pmax)`` + ``n_tokens (C,)`` — per-slot indirection,
  ``-1`` pads unused table entries.
* ``W (C, d')`` latent rows, ``alive (C,)`` tombstones, ``n_docs (1,)`` the
  slot high-water mark.  Doc ids are slot indices.

**Compressed tier** (``codec=``): a token is kept as its residual codec's
centroid id (``cent_pages (P, page)`` int32) and packed 2/4-bit residual
(``code_pages (P, page, d * bits / 8)`` uint8), with the trained
:class:`~repro_torch.anns.quantization.ResidualCodec` beside them;
``tok_pages`` is then ``(P, page, 0)``.  Slots, pages and tombstones are
those of the fp32 tier; pad positions are zero in both pools.

The pool, the slot capacity and the table width are powers of two, as in
the JAX package.  :func:`from_dense` builds a store from the dense padded
layout; :func:`allocate` plus :func:`write_docs` fill the same store a chunk
of docs at a time, for corpora whose dense layout does not fit in memory
(they write in place).  :func:`gather_docs` materialises candidates from
the pages (decoded on the compressed tier) for the legacy gathered rerank.
:func:`pool_tokens` caps each doc at a token budget before it is paged
(host-side numpy, as in the JAX package).

**Mutation** (:func:`add_docs`, :func:`delete_docs`) follows the JAX
package's rules: new docs take slots ``[m, m + n)`` (ids are never reused)
and the lowest free pages first; a delete returns its pages to the free
list (:func:`free_list` derives it from the table), zeroes the W rows and
clears the alive bits; the pool, the slot capacity and the table width grow
in power-of-two buckets; both return the logical bytes the JAX functions
report for the same mutation.  Where JAX's ``.at[].set`` returns new
arrays, these write in place, O(new docs) on the device, except into the
tensors named in ``shared`` (fields another view of the store holds): those
are copied first, once, and leave the set.  Mutation taps
(:func:`register_mutation_tap`) see every add and delete.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.anns.quantization import ResidualCodec, residual_decode, residual_encode
from repro_torch.common.device import resolve_device

TOKENS_PER_PAGE = 16   # power of two — the paged-KV NUM_TOKENS_IN_BLOCK
MIN_CAPACITY = 8       # smallest doc-slot bucket
_ITEM = 4              # fp32 / int32 bytes, the accounting unit


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
    # compressed tier (None on the fp32 tier, whose tok_pages is then (P, page, 0))
    cent_pages: torch.Tensor | None = None   # (P, page) int32 centroid ids
    code_pages: torch.Tensor | None = None   # (P, page, db) uint8 packed residuals
    codec: ResidualCodec | None = None       # the trained codec tables

    @property
    def n_pages(self) -> int:
        return self.tok_pages.shape[0]

    @property
    def page(self) -> int:
        return self.tok_pages.shape[1]

    @property
    def d(self) -> int:
        return self.codec.d if self.codec is not None else self.tok_pages.shape[2]

    @property
    def residual(self) -> bool:
        """True when the tokens live in the compressed (codec) tier."""
        return self.codec is not None

    @property
    def capacity(self) -> int:
        return self.page_table.shape[0]

    @property
    def pages_per_doc(self) -> int:
        return self.page_table.shape[1]

    @property
    def td_max(self) -> int:
        return self.page_table.shape[1] * self.tok_pages.shape[1]

    @property
    def d_prime(self) -> int:
        return self.W.shape[1]

    def to(self, device) -> "PagedStore":
        return PagedStore(*(None if t is None else t.to(device) for t in self))


def pages_needed(n_tokens: torch.Tensor, page: int = TOKENS_PER_PAGE) -> torch.Tensor:
    """Pages each doc takes: ceil(n_tokens / page)."""
    return (n_tokens.long() + page - 1) // page


def allocate(m: int, n_pages: int, pmax: int, d: int, d_prime: int, *,
             page: int = TOKENS_PER_PAGE, min_capacity: int = MIN_CAPACITY,
             device="cuda", codec: ResidualCodec | None = None) -> PagedStore:
    """An empty store sized for ``m`` docs over ``n_pages`` pages of at most
    ``pmax`` pages each (capacity and pool rounded up to powers of two), on
    ``device``; with ``codec``, on the compressed tier (the codec moves to
    ``device``)."""
    device = resolve_device(device)
    C = max(min_capacity, next_pow2(m))
    P = next_pow2(max(1, n_pages))
    extra = {}
    if codec is not None:
        extra = dict(
            cent_pages=torch.zeros((P, page), dtype=torch.int32, device=device),
            code_pages=torch.zeros((P, page, codec.packed_width), dtype=torch.uint8,
                                   device=device),
            codec=codec.to(device))
    return PagedStore(
        tok_pages=torch.zeros((P, page, 0 if codec is not None else d),
                              dtype=torch.float32, device=device),
        page_table=torch.full((C, max(1, pmax)), -1, dtype=torch.int32, device=device),
        n_tokens=torch.zeros((C,), dtype=torch.int32, device=device),
        W=torch.zeros((C, d_prime), dtype=torch.float32, device=device),
        alive=torch.zeros((C,), dtype=torch.bool, device=device),
        n_docs=torch.zeros((1,), dtype=torch.int32, device=device), **extra)


def write_docs(store: PagedStore, first_slot: int, first_page: int, W,
               doc_tokens, doc_mask) -> int:
    """Write n docs into slots ``[first_slot, first_slot + n)`` and pages
    from ``first_page`` on, in place: valid tokens compacted in doc-major
    order, ``ceil(n_tokens / page)`` pages a doc (the JAX ``_paginate``
    layout), residual-encoded on the compressed tier (only the valid
    tokens).  Returns the number of pages written."""
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
    rows = (torch.repeat_interleave(starts, counts) + t // page).to(dev)
    cols = (t % page).to(dev)
    if store.codec is not None:
        cid, packed = residual_encode(store.codec, flat)
        store.cent_pages[rows, cols] = cid
        store.code_pages[rows, cols] = packed
    else:
        store.tok_pages[rows, cols] = flat
    sl = slice(first_slot, first_slot + n)
    store.page_table[sl] = table.to(device=dev, dtype=torch.int32)
    store.n_tokens[sl] = counts.to(device=dev, dtype=torch.int32)
    store.W[sl] = torch.as_tensor(W).to(device=dev, dtype=store.W.dtype)
    store.alive[sl] = True
    store.n_docs.clamp_(min=first_slot + n)
    return need


def from_dense(W, doc_tokens, doc_mask, *, page: int = TOKENS_PER_PAGE,
               min_capacity: int = MIN_CAPACITY, codec: ResidualCodec | None = None):
    """Build a :class:`PagedStore` from the dense padded layout, on
    ``doc_tokens``' device; with ``codec`` the valid tokens are
    residual-encoded into the compressed tier.  Returns ``(store,
    bytes_moved)``, the bytes the JAX ``from_dense`` reports for the same
    build."""
    dm = doc_mask.bool()
    m, _, d = doc_tokens.shape
    ppd = pages_needed(dm.sum(1), page)
    pmax = max(1, int(ppd.max()) if m else 1)
    need = int(ppd.sum())
    store = allocate(m, need, pmax, d, W.shape[1], page=page,
                     min_capacity=min_capacity, device=doc_tokens.device, codec=codec)
    write_docs(store, 0, 0, W, doc_tokens, dm)
    payload = d * 4 if codec is None else 4 + codec.packed_width
    moved = (need * page * payload + store.page_table.numel() * 4
             + store.n_tokens.numel() * 4 + store.W.numel() * store.W.element_size()
             + store.alive.numel())
    return store, moved


# --------------------------------------------------------------------------
# mutation taps (the index lifecycle's observability seam)
# --------------------------------------------------------------------------

_MUTATION_TAPS: list = []


def register_mutation_tap(fn) -> None:
    """Subscribe ``fn(kind, ids, **payload)`` to every store mutation:
    ``kind`` ``"add"`` (payload ``doc_tokens``, ``doc_mask``, ``w``: host
    numpy arrays of the new docs) or ``"delete"`` (ids only).  Taps run on
    the mutating thread after the store is updated; what they raise is
    swallowed, so an observer cannot break a mutation."""
    if fn not in _MUTATION_TAPS:
        _MUTATION_TAPS.append(fn)


def unregister_mutation_tap(fn) -> None:
    try:
        _MUTATION_TAPS.remove(fn)
    except ValueError:
        pass


def _notify_taps(kind: str, ids, **payload) -> None:
    for fn in list(_MUTATION_TAPS):
        try:
            fn(kind, ids, **payload)
        except Exception:
            pass


# --------------------------------------------------------------------------
# mutation (returns the logical bytes moved)
# --------------------------------------------------------------------------

def free_list(store: PagedStore) -> list[int]:
    """Ascending free page ids: the pages no table entry references."""
    used = store.page_table.reshape(-1)
    free = torch.ones((store.n_pages,), dtype=torch.bool, device=used.device)
    free[used[used >= 0].long()] = False
    return torch.nonzero(free).flatten().tolist()


def writable(store: PagedStore, shared: set | None, names) -> PagedStore:
    """``store`` with each field of ``names`` that ``shared`` holds copied
    (and dropped from ``shared``), so that it can be written in place."""
    if not shared:
        return store
    own = {k: getattr(store, k).clone() for k in names
           if k in shared and getattr(store, k) is not None}
    shared.difference_update(names)
    return store._replace(**own)


def _grown(t: torch.Tensor, rows: int, fill=0) -> torch.Tensor:
    """``t`` padded along dim 0 to ``rows`` rows of ``fill`` (a new tensor)."""
    out = torch.full((rows,) + tuple(t.shape[1:]), fill, dtype=t.dtype, device=t.device)
    out[: t.shape[0]] = t
    return out


def add_docs(store: PagedStore, free_pages: list[int], w_new, doc_tokens, doc_mask, *,
             shared: set | None = None):
    """Page n new docs into slots ``[m, m + n)``, the lowest free pages first
    (on the compressed tier their valid tokens are encoded through
    ``store.codec``).  Returns ``(store, free_pages, new_ids (n,) int32
    numpy, bytes_moved)``.  A doc longer than any before doubles the table
    width, slots past the capacity and pages past the free list grow the
    capacity and the pool in power-of-two buckets (new tensors; their old
    bytes are billed, as JAX bills its copies); otherwise nothing changes
    shape and the writes are in place (``shared``: module docstring)."""
    dev = store.W.device
    dm = torch.as_tensor(doc_mask).to(device=dev, dtype=torch.bool)
    dt = torch.as_tensor(doc_tokens).to(device=dev, dtype=torch.float32)
    n = dt.shape[0]
    if n == 0:
        return store, list(free_pages), np.empty((0,), np.int32), 0
    m = int(store.n_docs[0])
    page = store.page
    moved = 0
    counts = dm.sum(1)
    ppd = pages_needed(counts, page)

    # 1. pages-a-doc bucket (only a doc longer than any before grows it)
    pmax = store.pages_per_doc
    need_pmax = max(1, int(ppd.max()))
    if need_pmax > pmax:
        new_pmax = next_pow2(need_pmax)
        moved += store.page_table.numel() * _ITEM
        table = torch.full((store.capacity, new_pmax), -1, dtype=torch.int32, device=dev)
        table[:, :pmax] = store.page_table
        store = store._replace(page_table=table)
        pmax = new_pmax
        if shared:
            shared.discard("page_table")

    # 2. slot-capacity bucket
    C = store.capacity
    if m + n > C:
        newC = max(next_pow2(m + n), 2 * C)
        moved += (store.page_table.numel() * _ITEM + store.n_tokens.numel() * _ITEM
                  + store.W.numel() * store.W.element_size() + store.alive.numel())
        store = store._replace(page_table=_grown(store.page_table, newC, -1),
                               n_tokens=_grown(store.n_tokens, newC),
                               W=_grown(store.W, newC), alive=_grown(store.alive, newC))
        if shared:
            shared.difference_update(("page_table", "n_tokens", "W", "alive"))

    # 3. page-pool bucket (amortized doubling)
    flat = dt[dm]
    need = int(ppd.sum())
    free_pages = list(free_pages)
    if need > len(free_pages):
        P = store.n_pages
        newP = max(next_pow2(P - len(free_pages) + need), 2 * P)
        moved += store.tok_pages.numel() * _ITEM
        grown = dict(tok_pages=_grown(store.tok_pages, newP))
        if store.codec is not None:
            moved += store.cent_pages.numel() * _ITEM + store.code_pages.numel()
            grown.update(cent_pages=_grown(store.cent_pages, newP),
                         code_pages=_grown(store.code_pages, newP))
        store = store._replace(**grown)
        free_pages.extend(range(P, newP))
        if shared:
            shared.difference_update(grown)

    # 4. allocate (lowest page ids first) and write the new pages whole:
    # a reused page keeps nothing of its last doc
    alloc = torch.as_tensor(free_pages[:need], dtype=torch.long, device=dev)
    free_pages = free_pages[need:]
    starts = torch.cumsum(ppd, 0) - ppd
    j = torch.arange(pmax, device=dev)
    local = torch.where(j[None, :] < ppd[:, None], starts[:, None] + j, -1)
    table_rows = torch.where(local >= 0, alloc[local.clamp_min(0)] if need else local,
                             -1).to(torch.int32)
    tok_start = torch.cumsum(counts, 0) - counts
    t = torch.arange(flat.shape[0], device=dev) - torch.repeat_interleave(tok_start, counts)
    rows = torch.repeat_interleave(starts, counts) + t // page
    cols = t % page
    pools = ("tok_pages",) if store.codec is None else ("cent_pages", "code_pages")
    store = writable(store, shared, pools + ("page_table", "n_tokens", "W", "alive",
                                              "n_docs"))
    if store.codec is None:
        chunk = torch.zeros((need, page, store.d), dtype=torch.float32, device=dev)
        chunk[rows, cols] = flat
        store.tok_pages[alloc] = chunk
        chunk_bytes = chunk.numel() * _ITEM
    else:
        cid, packed = residual_encode(store.codec, flat)
        cchunk = torch.zeros((need, page), dtype=torch.int32, device=dev)
        pchunk = torch.zeros((need, page, packed.shape[1]), dtype=torch.uint8, device=dev)
        cchunk[rows, cols] = cid
        pchunk[rows, cols] = packed
        store.cent_pages[alloc] = cchunk
        store.code_pages[alloc] = pchunk
        chunk_bytes = cchunk.numel() * _ITEM + pchunk.numel()
    sl = slice(m, m + n)
    store.page_table[sl] = table_rows
    store.n_tokens[sl] = counts.to(torch.int32)
    store.W[sl] = torch.as_tensor(w_new).to(device=dev, dtype=store.W.dtype)
    store.alive[sl] = True
    store.n_docs.fill_(m + n)
    ids = np.arange(m, m + n, dtype=np.int32)
    # the logical write set: the new pages and the touched table, count, W
    # and alive rows, O(doc), never O(corpus)
    moved += chunk_bytes + n * pmax * _ITEM + n * _ITEM + n * store.d_prime * _ITEM + n + _ITEM
    if _MUTATION_TAPS:
        _notify_taps("add", ids, doc_tokens=_numpy(dt), doc_mask=_numpy(dm),
                     w=_numpy(torch.as_tensor(w_new)).astype(np.float32))
    return store, free_pages, ids, moved


def delete_docs(store: PagedStore, free_pages: list[int], doc_ids, *,
                shared: set | None = None):
    """Tombstone slots and return their pages to the free list (kept
    ascending).  Slots are never reused; W rows are zeroed so a dead slot
    never wins a latent scan even unmasked.  Raises ``ValueError`` on
    duplicate, unknown or already-deleted ids, as JAX does.  Returns
    ``(store, free_pages, bytes_moved)``; writes in place (``shared``:
    module docstring)."""
    ids = np.asarray(_numpy(doc_ids), np.int64).ravel()
    if ids.size == 0:
        return store, list(free_pages), 0
    m = int(store.n_docs[0])
    if np.unique(ids).size != ids.size:
        raise ValueError(f"duplicate doc ids in delete: {ids.tolist()}")
    bad = ids[(ids < 0) | (ids >= m)]
    if bad.size:
        raise ValueError(f"unknown doc ids {bad.tolist()} (n_docs={m})")
    dev = store.W.device
    tids = torch.as_tensor(ids, device=dev)
    dead = ids[~store.alive[tids].cpu().numpy()]
    if dead.size:
        raise ValueError(f"doc ids already deleted: {dead.tolist()}")
    rows = store.page_table[tids].cpu().numpy()
    free_pages = sorted(list(free_pages) + rows[rows >= 0].tolist())
    store = writable(store, shared, ("page_table", "n_tokens", "W", "alive"))
    store.page_table[tids] = -1
    store.n_tokens[tids] = 0
    store.W[tids] = 0
    store.alive[tids] = False
    moved = int(ids.size) * (store.pages_per_doc * _ITEM + _ITEM + store.d_prime * _ITEM + 1)
    if _MUTATION_TAPS:
        _notify_taps("delete", ids.astype(np.int32))
    return store, free_pages, moved


def dense_add_bytes(m_total: int, td: int, d: int, d_prime: int) -> int:
    """What one add wrote in the dense layout: the whole concatenated corpus
    (tokens, mask, W), the O(corpus) baseline the paged add is held to."""
    return m_total * td * d * _ITEM + m_total * td + m_total * d_prime * _ITEM


def mask_dead(store: PagedStore, cand_ids: torch.Tensor) -> torch.Tensor:
    """Tombstone filter: candidate ids of deleted slots -> ``-1``."""
    ok = (cand_ids >= 0) & store.alive[cand_ids.clamp_min(0).long()]
    return torch.where(ok, cand_ids, -1)


def gather_docs(store: PagedStore, doc_ids: torch.Tensor):
    """Materialise docs from their pages: ``(...,)`` slot ids -> (tokens
    ``(..., pmax * page, d)``, mask ``(..., pmax * page)`` bool), the
    tokens zeroed past ``n_tokens``.  ``-1`` ids give an all-False mask and
    zero tokens.  The same token values in the same positions as the paged
    rerank kernels read; the compressed tier is decoded."""
    safe = doc_ids.clamp_min(0).long()
    table = store.page_table[safe].long().clamp_min(0)      # (..., pmax)
    nt = torch.where(doc_ids >= 0, store.n_tokens[safe], 0)
    td = store.pages_per_doc * store.page
    if store.codec is not None:
        toks = residual_decode(store.codec, store.cent_pages[table],
                               store.code_pages[table])  # (..., pmax, page, d)
    else:
        toks = store.tok_pages[table]                        # (..., pmax, page, d)
    toks = toks.reshape(*doc_ids.shape, td, store.d)
    mask = torch.arange(toks.shape[-2], device=toks.device) < nt[..., None]
    return toks.mul_(mask[..., None]), mask                  # toks is a fresh copy


def read_tokens(store: PagedStore, slots: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Token ``t[i]`` of slot ``slots[i]`` (1-D int tensors on the store's
    device, each t below its slot's ``n_tokens``) from the pages -> (n, d)
    fp32, decoded on the compressed tier: single tokens, without the dense
    layout."""
    pg = store.page_table[slots, t // store.page].long()
    col = t % store.page
    if store.codec is not None:
        return residual_decode(store.codec, store.cent_pages[pg, col], store.code_pages[pg, col])
    return store.tok_pages[pg, col]


def token_bytes(store: PagedStore) -> int:
    """Bytes of the token payload: the fp32 page pool, or the compressed
    tier's id and code pools plus the codec tables."""
    if store.codec is not None:
        tables = sum(t.numel() * t.element_size() for t in store.codec if t is not None)
        return (store.cent_pages.numel() * 4 + store.code_pages.numel()) + tables
    return store.tok_pages.numel() * 4


def pool_tokens(doc_tokens, doc_mask, budget: int):
    """Index-time constant-space token pooling: each doc's valid tokens are
    agglomerated to at most ``budget`` count-weighted means (greedy
    closest pair, squared Euclidean, the first pair on ties), host-side in
    numpy as in the JAX package.  Returns ``(pooled (n, min(T, budget), d)
    fp32, mask)`` as numpy arrays; ``budget <= 0``, or docs no longer than
    it, pass through."""
    dt = _numpy(doc_tokens).astype(np.float32, copy=False)
    dm = _numpy(doc_mask).astype(bool, copy=False)
    if budget <= 0 or dt.shape[1] <= budget:
        return dt, dm
    n, T, d = dt.shape
    tp = min(T, budget)
    out = np.zeros((n, tp, d), np.float32)
    om = np.zeros((n, tp), bool)
    for i in range(n):
        toks = dt[i][dm[i]]
        if toks.shape[0] > budget:
            toks = _pool_one(toks, budget)
        t = toks.shape[0]
        out[i, :t] = toks
        om[i, :t] = True
    return out, om


def _pool_one(toks: np.ndarray, budget: int) -> np.ndarray:
    """Agglomerate one doc's (t, d) tokens to ``budget`` count-weighted
    means by repeatedly merging the closest pair (fp64)."""
    reps = toks.astype(np.float64)
    w = np.ones(len(reps))
    alive = np.ones(len(reps), bool)
    while int(alive.sum()) > budget:
        idx = np.flatnonzero(alive)
        sub = reps[idx]
        sq = np.sum(np.square(sub), axis=1)
        d2 = sq[:, None] + sq[None, :] - 2.0 * (sub @ sub.T)
        iu = np.triu_indices(len(idx), k=1)
        flatpos = np.argmin(d2[iu])
        i, j = int(idx[iu[0][flatpos]]), int(idx[iu[1][flatpos]])
        reps[i] = (w[i] * reps[i] + w[j] * reps[j]) / (w[i] + w[j])
        w[i] += w[j]
        alive[j] = False
    return reps[alive].astype(np.float32)


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

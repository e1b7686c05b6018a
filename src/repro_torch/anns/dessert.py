"""DESSERT-style LSH set sketches (twin of ``repro/anns/dessert.py``;
Engels et al., NeurIPS 2023).

Build: each doc token is hashed by L SimHash functions of C bits; a doc
keeps, per table, a 2^C-bit occupancy bitmap over the buckets ((m, L, 2^C)
bool).  Search: a query token's hit count against doc j is the number of
tables whose bucket j occupies; the collision rate count / L maps back to a
similarity through the SimHash angle estimate, cos(pi (1 - rate^(1/C)))
(rate clipped to [1e-6, 1]), summed over the valid query tokens.

The JAX package gathers a (B, m, L, Tq) lookup (:func:`search_dessert_direct`
keeps that form, for tests and small inputs).  :func:`search_dessert` gets
the same counts as a product: the (docs, L 2^C) 0/1 occupancy times the
(L 2^C, B Tq) one-hot of the query buckets, a chunk of docs at a time.
The counts are integers in [0, L], exact in bf16 products with fp32
accumulation; each is looked up in an (L + 1)-entry table of the JAX
formula, and each chunk is reduced to (chunk, B) before the next.

The planes come from a ``torch.Generator`` seeded with ``cfg.seed``: JAX's
``jax.random`` draw cannot be replayed, so a caller reproducing a JAX build
passes its ``hyper``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.anns.base import CorpusView, stable_topk
from repro_torch.anns.muvera import bucket_ids
from repro_torch.common.config import ConfigBase

_BUILD_DOCS = 2048    # docs read and hashed at a time
_SEARCH_DOCS = 16384  # docs whose (docs, B Tq) counts live at a time


@dataclasses.dataclass(frozen=True)
class DessertConfig(ConfigBase):
    n_tables: int = 32       # L
    n_bits: int = 5          # C -> 2^C buckets per table
    seed: int = 11


class DessertIndex(NamedTuple):
    occupancy: torch.Tensor  # (m, L, 2^C) bool: bucket occupied by any doc token
    hyper: torch.Tensor      # (L, C, d) SimHash hyperplanes


def draw_hyper(cfg: DessertConfig, d: int, device="cpu") -> torch.Tensor:
    g = torch.Generator().manual_seed(int(cfg.seed))
    return torch.randn((cfg.n_tables, cfg.n_bits, d), generator=g).to(device)


def occupancy(doc_tokens, doc_mask, hyper) -> torch.Tensor:
    """(m, T, d) docs -> (m, L, 2^C) bool bucket-occupancy bitmaps."""
    m = doc_tokens.shape[0]
    L, C, _ = hyper.shape
    nb = 2 ** C
    ids = bucket_ids(doc_tokens, hyper)                           # (m, L, T)
    ids = torch.where(doc_mask[:, None, :], ids, nb)              # masked -> spare bucket
    occ = torch.zeros((m, L, nb + 1), dtype=torch.bool, device=doc_tokens.device)
    occ.scatter_(2, ids, True)
    return occ[..., :nb].contiguous()


def build_dessert(corpus: CorpusView, cfg: DessertConfig, *,
                  hyper: torch.Tensor | None = None) -> DessertIndex:
    """The index over ``corpus``'s docs, read ``_BUILD_DOCS`` at a time, on
    their device; ``hyper`` replaces the seeded draw."""
    occ = []
    for _, toks, mask in corpus.chunks(_BUILD_DOCS):
        if hyper is None:
            hyper = draw_hyper(cfg, toks.shape[-1])
        hyper = hyper.to(toks.device)
        occ.append(occupancy(toks, mask, hyper))
    return DessertIndex(torch.cat(occ), hyper)


def extend_dessert(index: DessertIndex, doc_tokens, doc_mask) -> DessertIndex:
    """Hash the new docs with the frozen planes and append their rows."""
    new = occupancy(doc_tokens, doc_mask, index.hyper)
    return DessertIndex(torch.cat([index.occupancy, new]), index.hyper)


def _sim(rate: torch.Tensor, n_bits: int) -> torch.Tensor:
    """JAX's fp32 angle estimate of a collision rate: cos(pi (1 - p)),
    p = clip(rate, 1e-6, 1) ** (1 / C)."""
    dev = rate.device
    p = torch.pow(rate.clamp(1e-6, 1.0), torch.full((), 1.0 / n_bits, device=dev))
    return torch.cos(torch.full((), math.pi, device=dev) * (1.0 - p))


def sim_table(n_tables: int, n_bits: int, device) -> torch.Tensor:
    """(L + 1,) fp32: the estimate of c hits in L tables (the rate c / L)."""
    rate = (torch.arange(n_tables + 1, dtype=torch.float32, device=device)
            / torch.full((), float(n_tables), device=device))
    return _sim(rate, n_bits)


def search_dessert(index: DessertIndex, q_tokens, q_mask, *, k_prime: int,
                   chunk: int | None = None):
    """q_tokens (B, Tq, d) -> (approx scores (B, k'), int64 ids (B, k')),
    k' clamped to m: hit counts as a product, ``chunk`` docs at a time
    (default ``_SEARCH_DOCS``)."""
    chunk = chunk or _SEARCH_DOCS
    occ, hyper = index.occupancy, index.hyper
    m, L, nb = occ.shape
    B, Tq, _ = q_tokens.shape
    dev = q_tokens.device
    dt = torch.bfloat16 if dev.type == "cuda" else torch.float32
    qh = bucket_ids(q_tokens, hyper)                                   # (B, L, Tq)
    rows = (torch.arange(L, device=dev)[None, :, None] * nb + qh).reshape(-1)
    cols = (torch.arange(B * Tq, device=dev).reshape(B, 1, Tq).expand(B, L, Tq)).reshape(-1)
    onehot = torch.zeros((L * nb, B * Tq), dtype=dt, device=dev)
    onehot[rows, cols] = 1
    # a masked query token reads the table's second half: zeros
    table = torch.cat([sim_table(L, hyper.shape[1], dev),
                       torch.zeros(L + 1, device=dev)])
    off = torch.where(q_mask.reshape(-1), 0, L + 1)
    scores = torch.empty((B, m), dtype=torch.float32, device=dev)
    for lo in range(0, m, chunk):
        cnt = occ[lo:lo + chunk].reshape(-1, L * nb).to(dt) @ onehot   # (n, B Tq)
        sim = table[cnt.long() + off]
        scores[:, lo:lo + chunk] = sim.reshape(-1, B, Tq).sum(-1).T
    return stable_topk(scores, min(k_prime, m))


def search_dessert_direct(index: DessertIndex, q_tokens, q_mask, *, k_prime: int):
    """The JAX package's form: the (B, m, L, Tq) occupancy lookup, its mean
    over the tables, the angle estimate, masked and summed over the query
    tokens.  For tests and small inputs (it holds B m L Tq entries)."""
    occ, hyper = index.occupancy, index.hyper
    m, L, nb = occ.shape
    B, Tq, _ = q_tokens.shape
    qh = bucket_ids(q_tokens, hyper)                                   # (B, L, Tq)
    hits = torch.gather(occ[None].expand(B, m, L, nb), 3,
                        qh[:, None].expand(B, m, L, Tq))               # (B, m, L, Tq)
    sim = _sim(hits.float().mean(2), hyper.shape[1])                   # (B, m, Tq)
    sim = torch.where(q_mask[:, None, :], sim, 0.0)
    return stable_topk(sim.sum(-1), min(k_prime, m))

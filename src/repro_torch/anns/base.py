"""First-stage retrieval protocol and top-k helpers (the port's side of
``repro/anns/base.py``).

Every first-stage backend (exact latent scan, IVF, MUVERA FDEs, DESSERT LSH
sketches, PLAID-style token pruning) implements one :class:`Retriever`
interface and registers by name in :mod:`repro_torch.anns.registry`; the
facade serves any of them through the same pool -> candidates -> rerank
pipeline and never learns a state's type.

``build(generator, corpus, cfg, *, parts=None, clock=None) -> state``
    Offline construction from a :class:`CorpusView`.  ``generator`` (CPU
    ``torch.Generator``) draws the backend's random parts; ``parts``
    (``{name: tensor}``, the names :meth:`pack_state` uses) supplies them
    instead, which is how a caller reproduces another build's draws (the
    JAX package's threefry streams cannot be replayed by a generator).
    ``clock(stage)``, when given, marks the end of a build stage (the
    facade's build log).
``search(state, query, k, params=None) -> (scores, ids)``
    ``(B, k)`` fp32 scores and int32 ids, ``-1``-padded.
``add(state, corpus, *, shared=None) -> state``
    Append documents; their ids continue the numbering.  Functional (the
    old state left as it was), but for IVF, which appends in place after
    copying the fields named in ``shared`` (another view holds them).
``pack_state(state) / unpack_state(arrays, meta)``
    ``{name: tensor}`` plus JSON-able meta under the JAX package's names,
    so either package loads the other's save.
``view(store) -> state`` (optional)
    A backend whose state is the paged store's W rows (bruteforce) returns
    them as a view; :func:`over_store` re-points such a state after every
    write to the store, so it is never a second copy.

``jax.lax.top_k`` returns the lowest index first among equal scores, and
the JAX package's ids depend on it; ``torch.topk`` promises no order on
ties.  So every top-k in the port goes through :func:`stable_topk`, which
orders by score descending, then index ascending.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Protocol, runtime_checkable

import torch

from repro_torch.anns.params import BackendConfig, BackendSearchParams


class CorpusView(NamedTuple):
    """Everything a backend may index.

    latent:     (m, d') latent doc vectors (the OLS W rows), or None for a
                caller without the learned reduction (token backends never
                need it).
    doc_tokens: (m, Td, d) token embeddings, or None when ``read`` serves them.
    doc_mask:   (m, Td) validity mask, or None when ``read`` serves it.
    read:       ``read(lo, hi) -> (tokens, mask)`` of docs [lo, hi): how the
                facade hands the paged store to a build a chunk of docs at a
                time instead of its dense layout (``latent`` then gives m).
    """

    latent: torch.Tensor | None
    doc_tokens: torch.Tensor | None
    doc_mask: torch.Tensor | None
    read: Callable[[int, int], tuple] | None = None

    @property
    def m(self) -> int:
        return (self.doc_tokens if self.doc_tokens is not None else self.latent).shape[0]

    def chunks(self, size: int):
        """Yield ``(lo, tokens, mask)`` for docs ``[lo, lo + n)``, n <= size,
        in doc order."""
        for lo in range(0, self.m, size):
            hi = min(self.m, lo + size)
            if self.read is not None:
                yield (lo, *self.read(lo, hi))
            else:
                yield lo, self.doc_tokens[lo:hi], self.doc_mask[lo:hi]


class QueryBatch(NamedTuple):
    """Both query representations, so any backend can serve the same call.

    latent: (B, d') pooled psi(X) queries (None when there is no psi).
    tokens: (B, Tq, d) query tokens.
    mask:   (B, Tq) validity mask.
    """

    latent: torch.Tensor | None
    tokens: torch.Tensor | None
    mask: torch.Tensor | None


@runtime_checkable
class Retriever(Protocol):
    """Pluggable first-stage candidate generator (module docstring)."""

    name: str
    #: which CorpusView / QueryBatch field drives this backend
    representation: str  # "latent" | "tokens"
    config_cls: type[BackendConfig]
    params_cls: type[BackendSearchParams]

    def build(self, generator, corpus: CorpusView, cfg=None, *, parts=None,
              clock=None) -> Any:
        ...

    def search(self, state, query: QueryBatch, k: int,
               params: BackendSearchParams | None = None):
        ...

    def add(self, state, corpus: CorpusView, *, shared=None) -> Any:
        ...

    def default_params(self, cfg) -> BackendSearchParams:
        ...

    def pack_state(self, state) -> tuple[dict[str, Any], dict]:
        ...

    def unpack_state(self, arrays: dict[str, Any], meta: dict) -> Any:
        ...


def over_store(be: Retriever, state, store):
    """``state`` re-pointed at ``store`` when ``be`` reads the store's W
    rows (its optional ``view``), else ``state`` as it is."""
    view = getattr(be, "view", None)
    return view(store) if view is not None else state


def stable_topk(scores: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest entries along the last axis,
    ties broken by the lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def pad_topk(scores: torch.Tensor, ids: torch.Tensor, k: int):
    """Pad a (B, kk<=k) top-k result out to k columns with (-inf, -1)."""
    kk = scores.shape[1]
    if kk >= k:
        return scores[:, :k], ids[:, :k]
    B = scores.shape[0]
    return (torch.cat([scores, scores.new_full((B, k - kk), float("-inf"))], 1),
            torch.cat([ids, ids.new_full((B, k - kk), -1)], 1))

"""ShardedLemurRetriever: the facade's multi-device serving surface on
``torch.distributed`` (twin of ``repro/retriever/sharded.py``).

Obtained through :meth:`repro_torch.retriever.LemurRetriever.shard` on every
rank of a process group, with the same retriever and the same queries on
each (SPMD)::

    mesh = init_device_mesh("cuda", (n,), mesh_dim_names=("model",))
    r = LemurRetriever.load("idx/")             # on the mesh's device
    sr = r.shard(mesh)                          # this rank's row block
    scores, ids = sr.search(q, qm, SearchParams(k=10))   # merged, every rank
    sr.add(new_tokens, new_mask)                # shard-balanced growth
    sr.delete(sr.last_added_ids)                # rows evicted in place
    sr.save("idx/"); sr = ShardedLemurRetriever.load("idx/", mesh)

The serve step is :mod:`repro_torch.dist.serve`'s: each rank holds one
block of a slot pool (its latent rows and dense token slabs), runs latent
scan -> local top-k' -> exact rerank on it, and the ranks merge their
(k, score) pairs.

* **State build.**  The pool has ``rows_per_shard`` = next_pow2(ceil(m /
  n)) rows a shard; slot i lands on row i, so rank r holds slots ``[r rps,
  (r + 1) rps)``.  ``row_ids`` / ``row_valid`` map rows to the base
  facade's slot ids (free and tombstoned rows ``-1`` and masked out of the
  latent scan; their tokens are masked too).  Rows are kept fp32 or
  scalar-quantized to SQ8 codes with per-row / per-token scales (``sq8``,
  default ``cfg.ivf.sq8``).  The block is filled FILL_SLOTS slots at a time
  from the paged store (decoded on the compressed tier): SQ8 quantizes per
  row and per token, so the chunked block equals the JAX package's
  quantization of the whole corpus, and the dense fp32 corpus is never
  gathered whole.
* **Routes.**  ``SearchParams`` picks the latent scan (``use_one_launch``:
  the ``mips_topk`` kernel, else a product and a stable top-k') and the
  rerank (``use_fused_gather``: the ``rerank_gather_scores`` kernel, else
  the gathered slab).  The first-stage backend and ``use_ann`` are ignored:
  the sharded first stage is the exact latent scan of each block, with the
  per-shard budget ``k_prime_local``.
* **Devices.**  The mesh's device type decides: a ``cuda`` mesh serves on
  the card (the kernels), a ``cpu`` mesh on the plain versions; a base
  retriever on another device type raises.

* **Mutation.**  ``add`` / ``delete`` / ``update`` go through the base
  facade (one version each), then place the new docs in free rows of the
  least-occupied shards (each shard's free rows a LIFO stack; ``_row_of``
  maps ids to rows) and evict deleted rows (W zeroed, tokens masked, ids
  -1), as JAX's do.  Every rank makes the same host-side choice
  and writes only the rows of its own block, in place.  A pool with too few
  free rows, or docs wider than the block's token width, rebuilds the block
  in the next power-of-two bucket.  ``install_refresh`` rebuilds it after
  the base facade's swap.
* **Compile accounting.**  :meth:`trace_count` counts the distinct (params,
  query shape, block shapes) served: what JAX's jit cache would hold, so
  mutations within the pool count nothing and a rebuild counts one.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import dist
from repro_torch.anns.quantization import sq8_quant
from repro_torch.common.device import resolve_device
from repro_torch.core import pages
from repro_torch.core.config import LemurConfig
from repro_torch.kernels.ref import NEG
from repro_torch.retriever.facade import LemurRetriever
from repro_torch.retriever.params import SearchParams

FILL_SLOTS = 25_000   # slots gathered from the pages at a time into the block


def mesh_device(mesh) -> torch.device:
    """The device this rank serves on: its card for a ``cuda`` mesh (raises
    without one), else the mesh's device type."""
    if mesh.device_type == "cuda":
        resolve_device("cuda")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


class ShardedLemurRetriever:
    """Multi-device serving facade over a :class:`LemurRetriever` (see the
    module docstring).  Construct it through ``LemurRetriever.shard(mesh)``."""

    def __init__(self, base: LemurRetriever, mesh, *, sq8: bool | None = None,
                 k_prime_local: int | None = None):
        if base.device.type != mesh.device_type:
            raise ValueError(f"a {mesh.device_type!r} mesh cannot serve a retriever whose "
                             f"tensors are on {base.device}: load it on the mesh's device")
        self._base = base
        self._mesh = mesh
        self._sq8 = bool(base.cfg.ivf.sq8) if sq8 is None else bool(sq8)
        self._k_prime_local = k_prime_local
        self._state: dist.ShardedRetrievalState | None = None
        # host-side allocator, the same on every rank: external id -> row,
        # and per-shard LIFO free rows for balanced placement
        self._row_of: dict[int, int] = {}
        self._free_rows: list[list[int]] = []
        self._rows_per_shard = 0
        self._served: set = set()
        self._trace_counts: dict[tuple, int] = {}
        self._trace_shapes: dict[tuple, int] = {}
        self._rebuild_state()

    # -- introspection ------------------------------------------------------

    @property
    def base(self) -> LemurRetriever:
        return self._base

    @property
    def mesh(self):
        return self._mesh

    @property
    def cfg(self) -> LemurConfig:
        return self._base.cfg

    @property
    def device(self) -> torch.device:
        return self._base.device

    @property
    def m(self) -> int:
        """Slot high-water mark of the base facade (stable external ids)."""
        return self._base.m

    @property
    def n_alive(self) -> int:
        return self._base.n_alive

    @property
    def rows_per_shard(self) -> int:
        """Physical slot-pool rows each shard holds (a power of two)."""
        return self._rows_per_shard

    @property
    def last_added_ids(self) -> np.ndarray:
        """External ids of the most recent add / update (the base's)."""
        return self._base.last_added_ids

    @property
    def version(self) -> int:
        """The base facade's snapshot version."""
        return self._base.version

    @property
    def sq8(self) -> bool:
        return self._sq8

    @property
    def state(self) -> dist.ShardedRetrievalState:
        """This rank's block."""
        return self._state

    def __repr__(self) -> str:
        shape = "x".join(str(s) for s in self._mesh.shape)
        return f"ShardedLemurRetriever(m={self.m}, mesh={shape}, sq8={self._sq8})"

    # -- state build --------------------------------------------------------

    def _rebuild_state(self) -> None:
        """The slot pool of ``repro/retriever/sharded.py:144-189``, this
        rank's block filled FILL_SLOTS slots at a time (module docstring)."""
        st = self._base.index.store
        n = dist.n_corpus_shards(self._mesh)
        m = self._base.m
        rps = max(1, pages.next_pow2(-(-m // n) if m else 1))
        total = n * rps
        alive = st.alive[:m].cpu().numpy()
        row_ids = np.full(total, -1, np.int32)
        row_ids[:m][alive] = np.arange(m, dtype=np.int32)[alive]
        row_valid = row_ids >= 0
        self._rows_per_shard = rps
        self._row_of = {int(i): int(i) for i in np.flatnonzero(alive)}
        free = np.flatnonzero(~row_valid)
        self._free_rows = [
            sorted(free[(free >= s * rps) & (free < (s + 1) * rps)].tolist(), reverse=True)
            for s in range(n)]

        dev = self.device
        rows = dist.local_rows(self._mesh, total)
        td, d = st.pages_per_doc * st.page, st.d
        code = torch.int8 if self._sq8 else torch.float32
        W = torch.zeros((rps, st.d_prime), dtype=code, device=dev)
        toks = torch.zeros((rps, td, d), dtype=code, device=dev)
        mask = torch.zeros((rps, td), dtype=torch.bool, device=dev)
        scales = {}
        if self._sq8:
            # a free row quantizes as a zero row does
            pad = float(sq8_quant(torch.zeros((1, 1)))[1])
            scales = {"W_scales": torch.full((rps,), pad, device=dev),
                      "doc_scales": torch.full((rps, td), pad, device=dev)}
        for s in range(rows.start, min(rows.stop, m), FILL_SLOTS):
            e = min(rows.stop, m, s + FILL_SLOTS)
            t, tm = pages.gather_docs(st, torch.arange(s, e, dtype=torch.int32, device=dev))
            w = st.W[s:e].float()
            r = slice(s - rows.start, e - rows.start)
            mask[r] = tm & st.alive[s:e, None]
            if self._sq8:
                W[r], scales["W_scales"][r] = sq8_quant(w)
                toks[r], scales["doc_scales"][r] = sq8_quant(t)
            else:
                W[r], toks[r] = w, t
            del t, tm, w
        self._state = dist.ShardedRetrievalState(
            psi=self._base.index.psi, W=W, doc_tokens=toks, doc_mask=mask,
            row_ids=torch.as_tensor(row_ids[rows], device=dev),
            row_valid=torch.as_tensor(row_valid[rows], device=dev), **scales)

    # -- query --------------------------------------------------------------

    def resolve(self, params: SearchParams | None = None) -> SearchParams:
        """Resolution is the base facade's (the same cfg defaults)."""
        return self._base.resolve(params)

    @torch.inference_mode()
    def search(self, q_tokens, q_mask=None, params: SearchParams | None = None):
        """q_tokens: (B, Tq, d), the same on every rank -> (scores (B, k),
        doc ids (B, k) int32), merged, on every rank.  Free and tombstoned
        rows come out as (NEG, -1), and rows narrower than k (k above the
        pool) are padded to k with (NEG, -1)."""
        dev = self.device
        q_tokens = torch.as_tensor(q_tokens, dtype=torch.float32).to(dev).contiguous()
        if q_mask is None:
            q_mask = torch.ones(q_tokens.shape[:2], dtype=torch.bool, device=dev)
        q_mask = torch.as_tensor(q_mask).to(device=dev, dtype=torch.bool).contiguous()
        resolved = self.resolve(params)
        self._account(resolved, q_tokens)
        step = dist.make_serve_step(
            self._mesh, self.cfg.replace(k=resolved.k, k_prime=resolved.k_prime),
            k_prime_local=self._k_prime_local, use_fused_gather=resolved.use_fused_gather,
            use_one_launch=resolved.use_one_launch)
        scores, ids = step(self._state, q_tokens, q_mask)
        scores = torch.where(ids >= 0, scores, NEG)
        extra = resolved.k - scores.shape[1]
        if extra > 0:
            B = scores.shape[0]
            scores = torch.cat([scores, scores.new_full((B, extra), NEG)], 1)
            ids = torch.cat([ids, ids.new_full((B, extra), -1)], 1)
        return scores, ids

    # -- compile accounting -------------------------------------------------

    @staticmethod
    def _key(resolved: SearchParams) -> tuple:
        return (resolved.k, resolved.k_prime, resolved.use_fused_gather,
                resolved.use_one_launch, resolved.use_residual)

    def _account(self, resolved: SearchParams, q: torch.Tensor) -> None:
        key = self._key(resolved)
        block = tuple(tuple(t.shape) for t in self._state if isinstance(t, torch.Tensor))
        sig = (key, tuple(q.shape), block)
        if sig in self._served:
            return
        self._served.add(sig)
        self._trace_counts[key] = self._trace_counts.get(key, 0) + 1
        skey = key + (tuple(q.shape),)
        self._trace_shapes[skey] = self._trace_shapes.get(skey, 0) + 1

    def trace_count(self, params: SearchParams | None = None) -> int:
        """Compile-cache entries so far (module docstring): for one resolved
        SearchParams, or in total."""
        if params is None:
            return sum(self._trace_counts.values())
        return self._trace_counts.get(self._key(self.resolve(params)), 0)

    def trace_shapes(self) -> dict[tuple, int]:
        """``{(B, Tq, d): entries}`` over every params."""
        out: dict[tuple, int] = {}
        for (*_, shape), n in self._trace_shapes.items():
            out[shape] = out.get(shape, 0) + n
        return out

    def clone(self) -> "ShardedLemurRetriever":
        """An independent replica over a clone of the base facade (shared
        index and solver, copied on write) on the same mesh, with its own
        block."""
        return ShardedLemurRetriever(self._base.clone(), self._mesh, sq8=self._sq8,
                                     k_prime_local=self._k_prime_local)

    # -- mutation -------------------------------------------------------------

    def add(self, doc_tokens, doc_mask, *, seed: int = 0) -> "ShardedLemurRetriever":
        """Grow through the base facade, then place the new docs in free rows
        of the least-occupied shards (module docstring).  Returns self."""
        self._base.add(doc_tokens, doc_mask, seed=seed)
        self._place(self._base.last_added_ids)
        return self

    def delete(self, doc_ids) -> "ShardedLemurRetriever":
        """Tombstone through the base facade, then evict the rows in place and
        return them to their shards' free rows.  Returns self."""
        self._base.delete(doc_ids)
        self._evict(doc_ids)
        return self

    def update(self, doc_ids, doc_tokens, doc_mask, *, seed: int = 0) -> np.ndarray:
        """Replace docs under one version (the base's delete + add); returns
        the new external ids."""
        ids = self._base.update(doc_ids, doc_tokens, doc_mask, seed=seed)
        self._evict(doc_ids)
        self._place(ids)
        return ids

    def install_refresh(self, refresh) -> "ShardedLemurRetriever":
        """Warm-swap a rebuild through the base facade (its
        ``CorruptIndexError`` leaves the block untouched), then rebuild the
        block from the new index: the refit W rows must reach every rank."""
        self._base.install_refresh(refresh)
        self._rebuild_state()
        return self

    @torch.no_grad()
    def _evict(self, doc_ids) -> None:
        rows = [self._row_of.pop(int(i)) for i in np.asarray(doc_ids).reshape(-1)]
        _, local = self._local(rows)
        if local.numel():
            st = self._state
            st.W[local] = 0
            st.doc_mask[local] = False
            st.row_ids[local] = -1
            st.row_valid[local] = False
        for r in rows:
            self._free_rows[r // self._rows_per_shard].append(r)

    @torch.no_grad()
    def _place(self, new_ids) -> None:
        ids = np.asarray(new_ids, np.int32).reshape(-1)
        if not ids.size:
            return
        st = self._state
        store = self._base.index.store
        if (store.td_max > st.doc_tokens.shape[1]
                or ids.size > sum(len(f) for f in self._free_rows)):
            self._rebuild_state()
            return
        rows = []
        for _ in ids:
            s = max(range(len(self._free_rows)), key=lambda i: len(self._free_rows[i]))
            rows.append(self._free_rows[s].pop())
        for i, r in zip(ids.tolist(), rows):
            self._row_of[i] = r
        mine, local = self._local(rows)
        if not mine:
            return
        gids = torch.as_tensor(ids[mine], device=self.device)
        toks, tmask = pages.gather_docs(store, gids)
        w = store.W[gids.long()].float()
        wide = st.doc_tokens.shape[1] - toks.shape[1]
        if wide:
            toks = torch.nn.functional.pad(toks, (0, 0, 0, wide))
            tmask = torch.nn.functional.pad(tmask, (0, wide))
        if self._sq8:
            # per-row / per-token scales: the new rows quantize alone as they
            # would in the whole block
            w, st.W_scales[local] = sq8_quant(w)
            toks, st.doc_scales[local] = sq8_quant(toks)
        st.W[local] = w.to(st.W.dtype)
        st.doc_tokens[local] = toks.to(st.doc_tokens.dtype)
        st.doc_mask[local] = tmask
        st.row_ids[local] = gids
        st.row_valid[local] = True

    def _local(self, rows) -> tuple[list[int], torch.Tensor]:
        """Which of the global ``rows`` lie in this rank's block (their
        positions in ``rows``) and their rows in the block."""
        block = dist.local_rows(self._mesh, len(self._free_rows) * self._rows_per_shard)
        mine = [j for j, r in enumerate(rows) if block.start <= r < block.stop]
        return mine, torch.as_tensor([rows[j] - block.start for j in mine], dtype=torch.long,
                                     device=self.device)

    # -- persistence --------------------------------------------------------

    def save(self, directory):
        """Persist the underlying retriever (placement is a runtime concern):
        any save reloads onto any mesh through :meth:`load`."""
        return self._base.save(directory)

    @classmethod
    def load(cls, directory, mesh, *, step: int | None = None, sq8: bool | None = None,
             k_prime_local: int | None = None) -> "ShardedLemurRetriever":
        """``LemurRetriever.load`` on the mesh's device, then shard onto ``mesh``."""
        base = LemurRetriever.load(directory, step=step, device=mesh_device(mesh))
        return cls(base, mesh, sq8=sq8, k_prime_local=k_prime_local)

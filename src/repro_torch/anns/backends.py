"""The five first-stage backends behind the registry (twin of
``repro/anns/backends.py``).

====================  ==========  ==============================================
name                  indexes     query side
====================  ==========  ==============================================
``bruteforce``        latent W    pooled psi(X): exact latent MIPS (blocked)
``ivf``               latent W    pooled psi(X): IVF probe scan (CUDA kernels)
``muvera``            tokens      FDE of the query tokens, exact MIPS over FDEs
``dessert``           tokens      LSH sketches of the query tokens
``token_pruning``     tokens      PLAID-style centroid interaction
====================  ==========  ==============================================

``pack_state`` / ``unpack_state`` use the JAX package's array names and
meta, so either package loads the other's save.  MUVERA's state also keeps
its planes and projections (``hyper``, ``final``, ``proj``): the JAX package
regenerates them from the seed at every query, which the port cannot.

The IVF backend serves the port's IVF module unchanged, its scans the CUDA
kernels.  The other first stages are plain PyTorch, as the JAX package
leaves them to XLA; every search through them still runs the psi-pool and
the paged rerank kernels, and every add the token MaxSim kernel (the facade's
OLS fit).

``add`` is functional for every backend but ``ivf``, whose ``extend_ivf``
writes in place: the facade passes it the fields another view holds
(``shared``), which it copies first.  The bruteforce state is the store's W
rows; the facade keeps it a view of them (:meth:`BruteforceRetriever.view`,
``base.over_store``) rather than a copy.
"""
from __future__ import annotations

import torch

from repro_torch.anns import dessert as _dessert
from repro_torch.anns import ivf as _ivf
from repro_torch.anns import muvera as _muvera
from repro_torch.anns import token_pruning as _tp
from repro_torch.anns.base import CorpusView, QueryBatch, pad_topk
from repro_torch.anns.bruteforce import mips_topk
from repro_torch.anns.params import (
    BruteforceBackendConfig,
    DessertBackendConfig,
    IVFBackendConfig,
    IVFSearchParams,
    MuveraBackendConfig,
    NoSearchParams,
    TokenPruningBackendConfig,
    TokenPruningSearchParams,
)
from repro_torch.anns.registry import register

_READ_DOCS = 2048    # docs MUVERA's build reads at a time


def _ids(scores, ids, k):
    return pad_topk(scores, ids.to(torch.int32), k)


@register
class BruteforceRetriever:
    """Exact latent MIPS: the recall ceiling of the first stage."""

    name = "bruteforce"
    representation = "latent"
    config_cls = BruteforceBackendConfig
    params_cls = NoSearchParams

    def build(self, generator, corpus: CorpusView, cfg=None, *, parts=None, clock=None):
        if corpus.latent is None:
            raise ValueError("bruteforce backend needs latent vectors "
                             "(CorpusView.latent is None)")
        return {"W": corpus.latent}

    def search(self, state, query: QueryBatch, k: int, params=None):
        return mips_topk(query.latent, state["W"], k)

    def add(self, state, corpus: CorpusView, *, shared=None):
        return {"W": torch.cat([state["W"], corpus.latent.to(state["W"].dtype)])}

    def view(self, store) -> dict:
        """The state over a paged store: its W rows [0, m), a view.  A delete
        zeroes a row there, where the JAX state keeps it; both mask the id
        after the first stage."""
        return {"W": store.W[: int(store.n_docs[0])]}

    def default_params(self, cfg) -> NoSearchParams:
        return NoSearchParams()

    def pack_state(self, state):
        return {"W": state["W"]}, {}

    def unpack_state(self, arrays, meta):
        return {"W": arrays["W"].float()}


@register
class IVFRetriever:
    """IVF over the latent corpus (:mod:`repro_torch.anns.ivf`)."""

    name = "ivf"
    representation = "latent"
    config_cls = IVFBackendConfig
    params_cls = IVFSearchParams

    def build(self, generator, corpus: CorpusView, cfg: IVFBackendConfig | None = None, *,
              parts=None, clock=None):
        if corpus.latent is None:
            raise ValueError("ivf backend needs latent vectors")
        cfg = cfg or IVFBackendConfig()
        return _ivf.build_ivf(corpus.latent, int(cfg.nlist), sq8=bool(cfg.sq8),
                              residual_bits=int(cfg.residual_bits or 0), generator=generator,
                              centroids=(parts or {}).get("centroids"))

    def search(self, state: _ivf.IVFIndex, query: QueryBatch, k: int,
               params: IVFSearchParams | None = None):
        nprobe = params.nprobe if params is not None else None
        nprobe = min(int(nprobe or min(32, state.nlist)), state.nlist)
        fused = params.use_fused_gather if params is not None else None
        return _ivf.search_ivf(state, query.latent, nprobe, k,
                               use_fused_gather=True if fused is None else bool(fused))

    def add(self, state, corpus: CorpusView, *, shared=None):
        return _ivf.extend_ivf(state, corpus.latent, shared=shared)

    def default_params(self, cfg) -> IVFSearchParams:
        if cfg is None:
            return IVFSearchParams()
        return IVFSearchParams(nprobe=cfg.nprobe, use_fused_gather=cfg.use_fused_gather,
                               use_one_launch=cfg.use_one_launch)

    def pack_state(self, state: _ivf.IVFIndex):
        arrays = {"centroids": state.centroids, "ids": state.ids, "vecs": state.vecs,
                  "counts": state.counts}
        for name in ("scales", "mean", "rq_cuts", "rq_values"):
            if getattr(state, name) is not None:
                arrays[name] = getattr(state, name)
        return arrays, {}

    def unpack_state(self, arrays, meta):
        def opt(name):
            return arrays[name].float() if arrays.get(name) is not None else None

        sq8, rq = arrays.get("scales") is not None, arrays.get("rq_values") is not None
        return _ivf.IVFIndex(
            centroids=arrays["centroids"].float(), ids=arrays["ids"].to(torch.int32),
            vecs=arrays["vecs"].to(torch.uint8 if rq else torch.int8 if sq8 else torch.float32),
            scales=opt("scales"), counts=arrays["counts"].to(torch.int32), mean=opt("mean"),
            rq_cuts=opt("rq_cuts"), rq_values=opt("rq_values"))


class MuveraState:
    """(m, final_dim) doc FDEs, the :class:`~repro_torch.anns.muvera.MuveraConfig`
    that made them and the planes and projections they were made with."""

    def __init__(self, dfde: torch.Tensor, mcfg: _muvera.MuveraConfig,
                 parts: _muvera.MuveraParts):
        self.dfde, self.mcfg, self.parts = dfde, mcfg, parts


@register
class MuveraRetriever:
    """Fixed-dimensional encodings + exact MIPS over the FDEs."""

    name = "muvera"
    representation = "tokens"
    config_cls = MuveraBackendConfig
    params_cls = NoSearchParams

    def build(self, generator, corpus: CorpusView, cfg: MuveraBackendConfig | None = None,
              *, parts=None, clock=None):
        cfg = cfg or MuveraBackendConfig()
        mcfg = _muvera.MuveraConfig(r_reps=int(cfg.r_reps), k_sim=int(cfg.k_sim),
                                    final_dim=int(cfg.final_dim))
        fdes, p = [], None
        for _, toks, mask in corpus.chunks(_READ_DOCS):
            if p is None:
                p = (_muvera.MuveraParts(parts["hyper"], parts.get("proj"), parts["final"])
                     if parts else _muvera.partition_params(mcfg, toks.shape[-1]))
                p = p.to(toks.device)
            fdes.append(_muvera.doc_fde(toks, mask, mcfg, p))
        return MuveraState(torch.cat(fdes), mcfg, p)

    def search(self, state: MuveraState, query: QueryBatch, k: int, params=None):
        qfde = _muvera.query_fde(query.tokens, query.mask, state.mcfg, state.parts)
        return mips_topk(qfde, state.dfde, k)

    def add(self, state: MuveraState, corpus: CorpusView, *, shared=None):
        new = _muvera.doc_fde(corpus.doc_tokens, corpus.doc_mask, state.mcfg, state.parts)
        return MuveraState(torch.cat([state.dfde, new]), state.mcfg, state.parts)

    def default_params(self, cfg) -> NoSearchParams:
        return NoSearchParams()

    def pack_state(self, state: MuveraState):
        arrays = {"dfde": state.dfde, "hyper": state.parts.hyper, "final": state.parts.final}
        if state.parts.proj is not None:
            arrays["proj"] = state.parts.proj
        return arrays, {"mcfg": state.mcfg.to_dict()}

    def unpack_state(self, arrays, meta):
        missing = [k for k in ("hyper", "final") if k not in arrays]
        if missing:
            raise ValueError(
                f"MUVERA state without its projections (ann/{', ann/'.join(missing)}): a "
                f"JAX-saved MUVERA checkpoint keeps only the doc FDEs and regenerates its "
                f"projections from jax.random, which this package cannot replay.  Rebuild "
                f"the first stage with LemurRetriever.with_backend('muvera'), or pass JAX's "
                f"_partition_params to repro_torch.convert.muvera_from_numpy")
        mcfg = _muvera.MuveraConfig.from_dict(meta["mcfg"])
        parts = _muvera.MuveraParts(arrays["hyper"].float(),
                                    arrays["proj"].float() if "proj" in arrays else None,
                                    arrays["final"].float())
        return MuveraState(arrays["dfde"].float(), mcfg, parts)


@register
class DessertRetriever:
    """LSH set-sketch scoring (DESSERT) off the token matrices."""

    name = "dessert"
    representation = "tokens"
    config_cls = DessertBackendConfig
    params_cls = NoSearchParams

    def build(self, generator, corpus: CorpusView, cfg: DessertBackendConfig | None = None,
              *, parts=None, clock=None):
        cfg = cfg or DessertBackendConfig()
        dcfg = _dessert.DessertConfig(n_tables=int(cfg.tables), n_bits=int(cfg.bits))
        return _dessert.build_dessert(corpus, dcfg, hyper=(parts or {}).get("hyper"))

    def search(self, state: _dessert.DessertIndex, query: QueryBatch, k: int, params=None):
        s, ids = _dessert.search_dessert(state, query.tokens, query.mask, k_prime=k)
        return _ids(s, ids, k)

    def add(self, state, corpus: CorpusView, *, shared=None):
        return _dessert.extend_dessert(state, corpus.doc_tokens, corpus.doc_mask)

    def default_params(self, cfg) -> NoSearchParams:
        return NoSearchParams()

    def pack_state(self, state: _dessert.DessertIndex):
        return {"occupancy": state.occupancy, "hyper": state.hyper}, {}

    def unpack_state(self, arrays, meta):
        return _dessert.DessertIndex(occupancy=arrays["occupancy"].to(torch.bool),
                                     hyper=arrays["hyper"].float())


class TokenPruningState:
    """A :class:`~repro_torch.anns.token_pruning.TokenPruningIndex` and the
    corpus size its scores span."""

    def __init__(self, index: _tp.TokenPruningIndex, m: int):
        self.index, self.m = index, int(m)


@register
class TokenPruningRetriever:
    """PLAID-style centroid-interaction pruning over the corpus tokens."""

    name = "token_pruning"
    representation = "tokens"
    config_cls = TokenPruningBackendConfig
    params_cls = TokenPruningSearchParams

    def build(self, generator, corpus: CorpusView,
              cfg: TokenPruningBackendConfig | None = None, *, parts=None, clock=None):
        cfg = cfg or TokenPruningBackendConfig()
        idx = _tp.build_token_pruning(corpus, nlist=int(cfg.nlist), generator=generator,
                                      centroids=(parts or {}).get("centroids"), clock=clock)
        return TokenPruningState(idx, corpus.m)

    def search(self, state: TokenPruningState, query: QueryBatch, k: int,
               params: TokenPruningSearchParams | None = None):
        nprobe = params.nprobe if params is not None else None
        nprobe = min(int(nprobe or 8), state.index.centroids.shape[0])
        s, ids = _tp.search_token_pruning(state.index, query.tokens, query.mask,
                                          nprobe=nprobe, k_prime=k, m=state.m)
        return _ids(s, ids, k)

    def add(self, state: TokenPruningState, corpus: CorpusView, *, shared=None):
        idx = _tp.extend_token_pruning(state.index, corpus.doc_tokens, corpus.doc_mask,
                                       m_old=state.m)
        return TokenPruningState(idx, state.m + corpus.m)

    def default_params(self, cfg) -> TokenPruningSearchParams:
        return TokenPruningSearchParams(nprobe=cfg.nprobe if cfg is not None else None)

    def pack_state(self, state: TokenPruningState):
        return ({"centroids": state.index.centroids, "doc_lists": state.index.doc_lists,
                 "counts": state.index.counts}, {"m": int(state.m)})

    def unpack_state(self, arrays, meta):
        idx = _tp.TokenPruningIndex(centroids=arrays["centroids"].float(),
                                    doc_lists=arrays["doc_lists"].to(torch.int32),
                                    counts=arrays["counts"].to(torch.int32))
        return TokenPruningState(idx, int(meta["m"]))

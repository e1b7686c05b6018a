"""Carry a retriever's state between the JAX package and the port.

The JAX facade saves one flat tree (``repro/retriever/facade.py:700-722``):

    psi/dense/kernel, psi/dense/bias, psi/ln/scale, psi/ln/bias,
    stats/mean, stats/std,
    pages/{tok_pages, page_table, n_tokens, W, alive, n_docs[, cent_pages, code_pages]},
    [codec/{centroids, cuts, values}],
    ann/{centroids, ids, vecs, counts[, scales][, mean][, rq_cuts, rq_values]},
    [solver/x_ols]

plus ``extra = {"format", "cfg", "backend", "ann_meta"}`` in the manifest.
On the compressed tier ``tok_pages`` is (P, page, 0) fp32, ``cent_pages``
(P, page) int32 and ``code_pages`` (P, page, d * bits / 8) uint8, with the
codec's tables beside them (``facade.py:713-720``); residual IVF lists
keep uint8 ``vecs`` and their ``rq_cuts``/``rq_values`` tables
(``anns/backends.py:123-141``).
:func:`index_from_numpy` turns that tree, as numpy arrays, into the port's
:class:`~repro_torch.core.index.LemurIndex` on ``device``;
:func:`index_to_numpy` is its inverse, with the JAX names, shapes and
dtypes, so the JAX package loads what the port saves.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.anns.ivf import IVFIndex
from repro_torch.anns.params import ported_backend
from repro_torch.anns.quantization import ResidualCodec
from repro_torch.common.device import resolve_device
from repro_torch.core.config import LemurConfig
from repro_torch.core.index import LemurIndex
from repro_torch.core.model import Psi, TargetStats
from repro_torch.core.pages import PagedStore

_STORE = ("tok_pages", "page_table", "n_tokens", "W", "alive", "n_docs")
_TOKEN_TIER = ("pages/cent_pages", "pages/code_pages", "codec/centroids", "codec/cuts",
               "codec/values")
_LIST_TIER = ("ann/rq_cuts", "ann/rq_values")
FORMAT = "lemur-retriever-v1"


def index_from_numpy(tree: dict[str, np.ndarray], extra: dict,
                     device="cuda") -> LemurIndex:
    """The port's index from a JAX save-tree (leaf name -> numpy array) and
    its manifest ``extra``.  Raises ``NotImplementedError`` for a backend
    other than ``ivf``, and ``ValueError`` for a tree that is not a paged
    one or holds part of a residual tier's leaves."""
    dev = resolve_device(device)
    ported_backend(extra["backend"])
    missing = [f"pages/{k}" for k in _STORE if f"pages/{k}" not in tree]
    if missing:
        raise ValueError(f"not a paged lemur-retriever-v1 tree; missing {missing}")
    for tier in (_TOKEN_TIER, _LIST_TIER):
        have = [k for k in tier if k in tree]
        if have and len(have) != len(tier):
            raise ValueError(f"residual-tier leaves {have} without "
                             f"{[k for k in tier if k not in have]}")

    def t(name, dtype=None):
        x = torch.from_numpy(np.require(tree[name], requirements=["C", "W"]))
        return x.to(device=dev, dtype=dtype)

    cfg = LemurConfig.from_dict(extra["cfg"])
    psi = Psi.from_arrays(tree["psi/dense/kernel"], tree["psi/dense/bias"],
                          tree["psi/ln/scale"], tree["psi/ln/bias"], device=dev)
    stats = TargetStats(t("stats/mean"), t("stats/std"))
    tier = {}
    if "pages/cent_pages" in tree:
        tier = dict(cent_pages=t("pages/cent_pages", torch.int32),
                    code_pages=t("pages/code_pages", torch.uint8),
                    codec=ResidualCodec(*(t(f"codec/{k}", torch.float32)
                                          for k in ("centroids", "cuts", "values"))))
    store = PagedStore(t("pages/tok_pages", torch.float32),
                       t("pages/page_table", torch.int32),
                       t("pages/n_tokens", torch.int32),
                       t("pages/W", torch.float32),
                       t("pages/alive", torch.bool),
                       t("pages/n_docs", torch.int32), **tier)
    def opt(name):
        return t(name, torch.float32) if name in tree else None

    sq8, rq = "ann/scales" in tree, "ann/rq_values" in tree
    ann = IVFIndex(centroids=t("ann/centroids", torch.float32),
                   ids=t("ann/ids", torch.int32),
                   vecs=t("ann/vecs", torch.uint8 if rq else torch.int8 if sq8
                          else torch.float32),
                   scales=opt("ann/scales"),
                   counts=t("ann/counts", torch.int32),
                   mean=opt("ann/mean"), rq_cuts=opt("ann/rq_cuts"),
                   rq_values=opt("ann/rq_values"))
    return LemurIndex(cfg, psi, stats, store, "ivf", ann)


def index_to_numpy(index: LemurIndex, x_ols=None) -> tuple[dict[str, np.ndarray], dict]:
    """The save-tree of ``index`` (leaf name -> numpy array) and its manifest
    ``extra``: the inverse of :func:`index_from_numpy`.  ``x_ols`` (the OLS
    tokens, when the retriever kept them) is saved as ``solver/x_ols``."""
    def a(t, dtype):
        return np.array(t.detach().cpu().numpy(), dtype=dtype, order="C")

    tree = {k: a(v, np.float32) for k, v in index.psi.params().items()}
    tree["stats/mean"] = a(index.stats.mean.reshape(()), np.float32)
    tree["stats/std"] = a(index.stats.std.reshape(()), np.float32)
    st = index.store
    for name, dtype in zip(_STORE, (np.float32, np.int32, np.int32, np.float32,
                                    np.bool_, np.int32)):
        tree[f"pages/{name}"] = a(getattr(st, name), dtype)
    if st.codec is not None:
        tree["pages/cent_pages"] = a(st.cent_pages, np.int32)
        tree["pages/code_pages"] = a(st.code_pages, np.uint8)
        for k, v in st.codec._asdict().items():
            tree[f"codec/{k}"] = a(v, np.float32)
    ann = index.ann
    tree["ann/centroids"] = a(ann.centroids, np.float32)
    tree["ann/ids"] = a(ann.ids, np.int32)
    tree["ann/vecs"] = a(ann.vecs, np.uint8 if ann.residual else np.int8
                         if ann.scales is not None else np.float32)
    tree["ann/counts"] = a(ann.counts, np.int32)
    for name in ("scales", "mean", "rq_cuts", "rq_values"):
        if getattr(ann, name) is not None:
            tree[f"ann/{name}"] = a(getattr(ann, name), np.float32)
    if x_ols is not None:
        tree["solver/x_ols"] = a(x_ols, np.float32)
    extra = {"format": FORMAT, "cfg": index.cfg.to_dict(), "backend": index.backend,
             "ann_meta": {}}
    return tree, extra

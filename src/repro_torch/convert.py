"""Carry a retriever's state between the JAX package and the port.

The JAX facade saves one flat tree (``repro/retriever/facade.py:700-722``):

    psi/dense/kernel, psi/dense/bias, psi/ln/scale, psi/ln/bias,
    stats/mean, stats/std,
    pages/{tok_pages, page_table, n_tokens, W, alive, n_docs},
    ann/{centroids, ids, vecs, counts[, scales][, mean]},
    [solver/x_ols]

plus ``extra = {"format", "cfg", "backend", "ann_meta"}`` in the manifest.
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
from repro_torch.common.device import resolve_device
from repro_torch.core.config import LemurConfig
from repro_torch.core.index import LemurIndex
from repro_torch.core.model import Psi, TargetStats
from repro_torch.core.pages import PagedStore

_RESIDUAL_LEAVES = ("pages/cent_pages", "pages/code_pages", "codec/centroids",
                    "ann/rq_cuts", "ann/rq_values")
_STORE = ("tok_pages", "page_table", "n_tokens", "W", "alive", "n_docs")
FORMAT = "lemur-retriever-v1"


def index_from_numpy(tree: dict[str, np.ndarray], extra: dict,
                     device="cuda") -> LemurIndex:
    """The port's index from a JAX save-tree (leaf name -> numpy array) and
    its manifest ``extra``.  Raises ``NotImplementedError`` for a residual-tier
    checkpoint or a backend other than ``ivf``."""
    dev = resolve_device(device)
    ported_backend(extra["backend"])
    residual = [k for k in _RESIDUAL_LEAVES if k in tree]
    if residual:
        raise NotImplementedError(
            f"residual-tier checkpoint ({', '.join(residual)}): the compressed "
            f"tier is not ported yet (ROADMAP Queue 1 item 6)")
    missing = [f"pages/{k}" for k in _STORE if f"pages/{k}" not in tree]
    if missing:
        raise ValueError(f"not a paged lemur-retriever-v1 tree; missing {missing}")

    def t(name, dtype=None):
        x = torch.from_numpy(np.require(tree[name], requirements=["C", "W"]))
        return x.to(device=dev, dtype=dtype)

    cfg = LemurConfig.from_dict(extra["cfg"])
    psi = Psi.from_arrays(tree["psi/dense/kernel"], tree["psi/dense/bias"],
                          tree["psi/ln/scale"], tree["psi/ln/bias"], device=dev)
    stats = TargetStats(t("stats/mean"), t("stats/std"))
    store = PagedStore(t("pages/tok_pages", torch.float32),
                       t("pages/page_table", torch.int32),
                       t("pages/n_tokens", torch.int32),
                       t("pages/W", torch.float32),
                       t("pages/alive", torch.bool),
                       t("pages/n_docs", torch.int32))
    sq8 = "ann/scales" in tree
    ann = IVFIndex(centroids=t("ann/centroids", torch.float32),
                   ids=t("ann/ids", torch.int32),
                   vecs=t("ann/vecs", torch.int8 if sq8 else torch.float32),
                   scales=t("ann/scales", torch.float32) if sq8 else None,
                   counts=t("ann/counts", torch.int32),
                   mean=t("ann/mean", torch.float32) if "ann/mean" in tree else None)
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
    ann = index.ann
    tree["ann/centroids"] = a(ann.centroids, np.float32)
    tree["ann/ids"] = a(ann.ids, np.int32)
    tree["ann/vecs"] = a(ann.vecs, np.float32 if ann.scales is None else np.int8)
    tree["ann/counts"] = a(ann.counts, np.int32)
    if ann.scales is not None:
        tree["ann/scales"] = a(ann.scales, np.float32)
    if ann.mean is not None:
        tree["ann/mean"] = a(ann.mean, np.float32)
    if x_ols is not None:
        tree["solver/x_ols"] = a(x_ols, np.float32)
    extra = {"format": FORMAT, "cfg": index.cfg.to_dict(), "backend": index.backend,
             "ann_meta": {}}
    return tree, extra

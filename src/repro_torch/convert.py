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
dtypes, so the JAX package loads what the port saves.  A legacy dense tree
(``W``, ``doc_tokens``, ``doc_mask`` in place of ``pages/``) is paged on
the way in, as the JAX facade migrates it (``facade.py:766-770``).

The OLS solver state and a rebuilt first stage cross too:
:func:`solver_from_numpy` / :func:`solver_to_numpy` (JAX's ``cho_factor``
keeps the upper factor with ``lower=False``, the port the lower one: the
transpose, exactly) and :func:`refresh_from_numpy`, which makes the
:class:`Refresh` that ``LemurRetriever.install_refresh`` takes from a JAX
``lifecycle.build_refresh`` result given as numpy arrays.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.anns.ivf import IVFIndex
from repro_torch.anns.params import ported_backend
from repro_torch.anns.quantization import ResidualCodec
from repro_torch.common.device import resolve_device
from repro_torch.core.config import LemurConfig
from repro_torch.core.index import LemurIndex
from repro_torch.core.model import Psi, TargetStats
from repro_torch.core.pages import PagedStore, from_dense

_STORE = ("tok_pages", "page_table", "n_tokens", "W", "alive", "n_docs")
_TOKEN_TIER = ("pages/cent_pages", "pages/code_pages", "codec/centroids", "codec/cuts",
               "codec/values")
_LIST_TIER = ("ann/rq_cuts", "ann/rq_values")
_DENSE = ("W", "doc_tokens", "doc_mask")
FORMAT = "lemur-retriever-v1"


class Refresh(NamedTuple):
    """What ``LemurRetriever.install_refresh`` reads of a rebuild: the
    backend name, the slot high-water mark m0 it covered, its W rows (m0,
    d'), its IVF state and its OLS solver state."""
    backend: str
    m0: int
    W: torch.Tensor
    ann: IVFIndex
    solver: dict


def index_from_numpy(tree: dict[str, np.ndarray], extra: dict,
                     device="cuda") -> LemurIndex:
    """The port's index from a JAX save-tree (leaf name -> numpy array) and
    its manifest ``extra``.  Raises ``NotImplementedError`` for a backend
    other than ``ivf``, and ``ValueError`` for a tree that is neither a
    paged nor a dense one or holds part of a residual tier's leaves."""
    dev = resolve_device(device)
    ported_backend(extra["backend"])
    missing = [f"pages/{k}" for k in _STORE if f"pages/{k}" not in tree]
    dense = all(k in tree for k in _DENSE)
    if missing and not dense:
        raise ValueError(f"not a paged lemur-retriever-v1 tree; missing {missing}")
    for tier in (_TOKEN_TIER, _LIST_TIER):
        have = [k for k in tier if k in tree]
        if have and len(have) != len(tier):
            raise ValueError(f"residual-tier leaves {have} without "
                             f"{[k for k in tier if k not in have]}")

    def t(name, dtype=None):
        return _tensor(tree[name], dev, dtype)

    cfg = LemurConfig.from_dict(extra["cfg"])
    psi = Psi.from_arrays(tree["psi/dense/kernel"], tree["psi/dense/bias"],
                          tree["psi/ln/scale"], tree["psi/ln/bias"], device=dev)
    stats = TargetStats(t("stats/mean"), t("stats/std"))
    ann = ann_from_numpy({k[4:]: v for k, v in tree.items() if k.startswith("ann/")}, dev)
    if missing:
        # legacy dense checkpoint: page it (JAX's LemurIndex.from_dense)
        store, _ = from_dense(t("W", torch.float32), t("doc_tokens", torch.float32),
                              t("doc_mask", torch.bool))
        return LemurIndex(cfg, psi, stats, store, "ivf", ann)
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
    return LemurIndex(cfg, psi, stats, store, "ivf", ann)


def _tensor(x, dev, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.require(np.asarray(x), requirements=["C", "W"])).to(
        device=dev, dtype=dtype)


def ann_from_numpy(arrays: dict, device="cuda") -> IVFIndex:
    """The port's IVF state from the JAX ``IVFIndex`` fields (name -> array;
    ``scales``, ``mean``, ``rq_cuts`` and ``rq_values`` may be absent)."""
    dev = resolve_device(device)

    def opt(name):
        return _tensor(arrays[name], dev, torch.float32) if arrays.get(name) is not None else None

    sq8, rq = arrays.get("scales") is not None, arrays.get("rq_values") is not None
    return IVFIndex(centroids=_tensor(arrays["centroids"], dev, torch.float32),
                    ids=_tensor(arrays["ids"], dev, torch.int32),
                    vecs=_tensor(arrays["vecs"], dev, torch.uint8 if rq else torch.int8
                                 if sq8 else torch.float32),
                    scales=opt("scales"), counts=_tensor(arrays["counts"], dev, torch.int32),
                    mean=opt("mean"), rq_cuts=opt("rq_cuts"), rq_values=opt("rq_values"))


def solver_from_numpy(solver: dict, device="cuda") -> dict:
    """The port's OLS solver state from JAX's: ``chol`` JAX's ``(factor,
    lower)`` pair (or a bare factor), ``feats``, ``x_ols``.  An upper factor
    is transposed to the port's lower one."""
    dev = resolve_device(device)
    chol = solver["chol"]
    lower = False
    if isinstance(chol, (tuple, list)):
        chol, lower = chol
    chol = _tensor(chol, dev, torch.float32)
    return {"chol": chol if lower else chol.T.contiguous(),
            "feats": _tensor(solver["feats"], dev, torch.float32),
            "x_ols": _tensor(solver["x_ols"], dev, torch.float32)}


def solver_to_numpy(solver: dict) -> dict:
    """JAX's solver state (numpy) from the port's: ``chol`` as the
    ``(upper factor, False)`` pair ``jax.scipy.linalg.cho_solve`` takes."""
    def a(t):
        return t.detach().cpu().numpy()

    return {"chol": (a(solver["chol"].T).copy(), False), "feats": a(solver["feats"]),
            "x_ols": a(solver["x_ols"])}


def refresh_from_numpy(backend: str, m0: int, W, ann: dict, solver: dict,
                       device="cuda") -> Refresh:
    """A :class:`Refresh` on ``device`` from a rebuild's parts as numpy
    arrays: ``ann`` the IVF fields by name, ``solver`` as in
    :func:`solver_from_numpy`."""
    dev = resolve_device(device)
    return Refresh(backend, int(m0), _tensor(W, dev, torch.float32),
                   ann_from_numpy(ann, dev), solver_from_numpy(solver, dev))


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

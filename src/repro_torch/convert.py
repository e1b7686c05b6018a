"""Carry a retriever's state between the JAX package and the port.

The JAX facade saves one flat tree (``repro/retriever/facade.py:700-722``):

    psi/dense/kernel, psi/dense/bias, psi/ln/scale, psi/ln/bias,
    stats/mean, stats/std,
    pages/{tok_pages, page_table, n_tokens, W, alive, n_docs[, cent_pages, code_pages]},
    [codec/{centroids, cuts, values}],
    ann/{the backend's pack_state arrays},
    [solver/x_ols]

plus ``extra = {"format", "cfg", "backend", "ann_meta"}`` in the manifest.
On the compressed tier ``tok_pages`` is (P, page, 0) fp32, ``cent_pages``
(P, page) int32 and ``code_pages`` (P, page, d * bits / 8) uint8, with the
codec's tables beside them (``facade.py:713-720``); residual IVF lists
keep uint8 ``vecs`` and their ``rq_cuts``/``rq_values`` tables
(``anns/backends.py:123-141``).  Each backend's state crosses under its
``pack_state`` names and ``ann_meta`` (IVF ``centroids, ids, vecs, counts``
and the optional tables; bruteforce ``W``; MUVERA ``dfde`` and the meta
``mcfg``; DESSERT ``occupancy, hyper``; token pruning ``centroids,
doc_lists, counts`` and the meta ``m``).  The port's MUVERA state also
saves its planes and projections (``ann/hyper``, ``ann/final``,
``ann/proj``), which JAX's ``unpack_state`` ignores; a JAX-saved MUVERA
state lacks them and is refused (:func:`muvera_from_numpy` builds one from
JAX's ``_partition_params``).  A bruteforce state loads as a view of the
store's W rows, not a second copy.
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
:class:`~repro_torch.lifecycle.refresh.RefreshResult` that
``LemurRetriever.install_refresh`` takes (the port's own ``build_refresh``
makes one too) from a JAX ``lifecycle.build_refresh`` result given as numpy
arrays.

A model's parameters (LM, recsys, GNN) and optimizer states cross leaf by
leaf under the ``named_leaves`` names both packages give them
(``stack_0/pos_0/attn/wq``, ``table/embedding``, ``proc/edge/mlp/layer_0/kernel``
...): :func:`params_from_numpy` / :func:`params_to_numpy` (the LM's
through :func:`lm_params_from_numpy`, which checks ``cfg.pdtype``),
:func:`adam_state_from_numpy` (``OptState``) and
:func:`adam8_state_from_numpy` (``Opt8State``, whose moments are ``Q8``
codes and row scales).  bfloat16 leaves (``ml_dtypes.bfloat16`` numpy
arrays) keep their bits; ``params_to_numpy`` gives them as fp32 (every
bf16 value is one).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.anns import muvera as _muvera
from repro_torch.anns import registry
from repro_torch.anns.base import over_store
from repro_torch.anns.backends import MuveraState
from repro_torch.anns.quantization import ResidualCodec
from repro_torch.common.device import resolve_device
from repro_torch.common.pytree import named_leaves, tree_map
from repro_torch.core.config import LemurConfig
from repro_torch.core.index import LemurIndex
from repro_torch.core.model import Psi, TargetStats
from repro_torch.core.pages import PagedStore, from_dense
from repro_torch.lifecycle.refresh import RefreshResult
from repro_torch.optim.adam import OptState
from repro_torch.optim.adam8bit import Opt8State, Q8

_STORE = ("tok_pages", "page_table", "n_tokens", "W", "alive", "n_docs")
_TOKEN_TIER = ("pages/cent_pages", "pages/code_pages", "codec/centroids", "codec/cuts",
               "codec/values")
_LIST_TIER = ("ann/rq_cuts", "ann/rq_values")
_DENSE = ("W", "doc_tokens", "doc_mask")
FORMAT = "lemur-retriever-v1"


def index_from_numpy(tree: dict[str, np.ndarray], extra: dict,
                     device="cuda") -> LemurIndex:
    """The port's index from a JAX save-tree (leaf name -> numpy array) and
    its manifest ``extra``.  Raises ``KeyError`` for a backend nobody
    registers, and ``ValueError`` for a tree that is neither a paged nor a
    dense one, holds part of a residual tier's leaves, or is a JAX MUVERA
    state without its projections."""
    dev = resolve_device(device)
    backend = registry.canonical(extra["backend"])
    be = registry.get_backend(backend)
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
    ann = ann_from_numpy({k[4:]: v for k, v in tree.items() if k.startswith("ann/")}, dev,
                         backend=backend, meta=extra.get("ann_meta", {}))
    if missing:
        # legacy dense checkpoint: page it (JAX's LemurIndex.from_dense)
        store, _ = from_dense(t("W", torch.float32), t("doc_tokens", torch.float32),
                              t("doc_mask", torch.bool))
        return LemurIndex(cfg, psi, stats, store, backend, over_store(be, ann, store))
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
    return LemurIndex(cfg, psi, stats, store, backend, over_store(be, ann, store))


def psi_params_from_numpy(params: dict, device="cuda") -> dict:
    """JAX's ψ param dict (``{"dense": {"kernel", "bias"}, "ln": {"scale",
    "bias"}}``, numpy arrays) with fp32 tensor leaves on ``device``, the
    form ``kernels.ops.fused_psi`` takes beside a ``Psi``."""
    dev = resolve_device(device)
    return {group: {k: _tensor(v, dev, torch.float32) for k, v in leaves.items()}
            for group, leaves in params.items()}


def _tensor(x, dev, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.require(np.asarray(x), requirements=["C", "W"])).to(
        device=dev, dtype=dtype)


def ann_from_numpy(arrays: dict, device="cuda", *, backend: str = "ivf",
                   meta: dict | None = None):
    """The port's state of ``backend`` from its packed arrays (name -> array,
    the JAX ``pack_state`` names; for IVF ``scales``, ``mean``, ``rq_cuts``
    and ``rq_values`` may be absent) and meta, on ``device``."""
    dev = resolve_device(device)
    tensors = {k: _tensor(v, dev) for k, v in arrays.items() if v is not None}
    return registry.get_backend(backend).unpack_state(tensors, meta or {})


def muvera_from_numpy(dfde, mcfg, hyper, final, proj=None, device="cuda") -> MuveraState:
    """A MUVERA state from JAX's doc FDEs, its ``MuveraConfig`` (or its
    dict) and the planes and projections of its ``_partition_params``
    (``hyper, proj, final``): what serves a JAX-saved MUVERA first stage,
    whose save holds no projections."""
    dev = resolve_device(device)
    if not isinstance(mcfg, dict):
        mcfg = mcfg.to_dict()
    parts = _muvera.MuveraParts(_tensor(hyper, dev, torch.float32),
                                None if proj is None else _tensor(proj, dev, torch.float32),
                                _tensor(final, dev, torch.float32))
    return MuveraState(_tensor(dfde, dev, torch.float32),
                       _muvera.MuveraConfig.from_dict(mcfg), parts)


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
                       device="cuda", *, ann_meta: dict | None = None) -> RefreshResult:
    """A :class:`RefreshResult` on ``device`` from a rebuild's parts as numpy
    arrays: ``ann`` the backend's packed arrays by name and ``ann_meta`` its
    meta (as :func:`ann_from_numpy`), ``solver`` as in
    :func:`solver_from_numpy`.  Its ``version``, ``seed`` and ``wall_s``
    are 0: ``install_refresh`` reads none of them."""
    dev = resolve_device(device)
    return RefreshResult(backend, 0, int(m0), _tensor(W, dev, torch.float32),
                         ann_from_numpy(ann, dev, backend=registry.canonical(backend),
                                        meta=ann_meta),
                         solver_from_numpy(solver, dev), 0, 0.0)


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
    arrays, meta = registry.get_backend(index.backend).pack_state(index.ann)
    for name, v in arrays.items():
        tree[f"ann/{name}"] = a(v, None)
    if x_ols is not None:
        tree["solver/x_ols"] = a(x_ols, np.float32)
    extra = {"format": FORMAT, "cfg": index.cfg.to_dict(), "backend": index.backend,
             "ann_meta": meta}
    return tree, extra


# ---------------------------------------------------------------------------
# model parameters (LM, recsys, GNN) and optimizer states
# ---------------------------------------------------------------------------

def _leaf_from_numpy(x, dev, dtype=None) -> torch.Tensor:
    """A numpy array (bfloat16 by its bits) as a tensor on ``dev``; raises
    where ``dtype`` is given and the array is of another."""
    a = np.require(np.asarray(x), requirements=["C", "W"])
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"leaf of dtype {t.dtype}, the config says {dtype}")
    return t.to(dev)


def _nested(tree):
    """A flat ``{"a/b": array}`` dict as the nested dict it names; a nested
    tree as it is."""
    if not (isinstance(tree, dict) and any("/" in k for k in tree)):
        return tree
    out: dict = {}
    for name, x in tree.items():
        node = out
        *head, last = name.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[last] = x
    return out


def params_from_numpy(tree, device="cuda", dtype=None):
    """A model's parameters (a nested dict of numpy arrays as
    ``jax.tree_util.tree_map(np.asarray, params)`` gives it, or its flat
    ``named_leaves`` dict) as tensors on ``device``, leaf for leaf: the
    recsys and GNN trees (the GNN's ``proc`` leaves keep their leading layer
    axis) and, through :func:`lm_params_from_numpy`, the LM's.  ``dtype``:
    every leaf must be of it (None: each keeps its own)."""
    dev = resolve_device(device)
    return tree_map(lambda x: _leaf_from_numpy(x, dev, dtype), _nested(tree))


def params_to_numpy(params) -> dict[str, np.ndarray]:
    """``{named_leaves name: numpy array}``; bfloat16 leaves as fp32."""
    return {name: (t.detach().float() if t.dtype == torch.bfloat16 else t.detach()).cpu().numpy()
            for name, t in named_leaves(params)}


def lm_params_from_numpy(tree, cfg, device="cuda"):
    """The LM's parameters as tensors of ``cfg.pdtype`` on ``device``
    (:func:`params_from_numpy`)."""
    return params_from_numpy(tree, device, cfg.pdtype)


lm_params_to_numpy = params_to_numpy


def adam_state_from_numpy(state, device="cuda") -> OptState:
    """JAX's ``OptState`` (step, mu, nu as numpy) on ``device``."""
    dev = resolve_device(device)
    conv = lambda tree: tree_map(lambda x: _leaf_from_numpy(x, dev), _nested(tree))
    return OptState(_leaf_from_numpy(state.step, dev, torch.int32), conv(state.mu),
                    conv(state.nu))


def adam8_state_from_numpy(state, device="cuda") -> Opt8State:
    """JAX's ``Opt8State`` (its moments trees of ``Q8(q, scale)``, numpy) on
    ``device``, the moments as the port's ``Q8``."""
    dev = resolve_device(device)
    is_q8 = lambda x: isinstance(x, tuple) and getattr(x, "_fields", None) == ("q", "scale")
    conv = lambda tree: tree_map(
        lambda s: Q8(_leaf_from_numpy(s.q, dev, torch.int8),
                     _leaf_from_numpy(s.scale, dev, torch.float32)), tree, is_leaf=is_q8)
    return Opt8State(_leaf_from_numpy(state.step, dev, torch.int32), conv(state.mu),
                     conv(state.nu))


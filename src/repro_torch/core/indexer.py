"""Scalable LEMUR indexing (§4.3): training-token selection, then frozen psi
plus a per-document OLS output layer (twin of ``repro/core/indexer.py``).

The Gram matrix (Psi^T Psi + ridge n' I) is factorized once; each document's
latent row w_j is then a Cholesky solve against its target column
g_j(x_i) = max_{c in C_j} <c, x_i> over the n' OLS tokens.  On a CUDA
device the features go through the psi kernel (``kernels/fused_psi``) and
the targets through the token MaxSim kernel (``kernels/maxsim``), one launch
per block of docs.  ``torch.linalg.cholesky`` gives the lower factor where
JAX's ``cho_factor`` gives the upper one: the same solve, rounded
differently.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import maxsim
from repro_torch.core.model import Psi, TargetStats
from repro_torch.data import synthetic
from repro_torch.kernels import fused_psi


def make_training_tokens(corpus, cfg, seed: int = 0) -> np.ndarray:
    """§4.2 training-set selection -> (n, d) fp32 numpy token embeddings.
    numpy's ``default_rng(seed)`` makes the draws in the JAX order, so one
    corpus and seed give the JAX package's tokens.  ``corpus.doc_tokens`` /
    ``doc_mask`` may be numpy arrays or tensors on any device."""
    rng = np.random.default_rng(seed)
    if cfg.query_strategy == "corpus-query":
        n_docs = max(1, cfg.n_train // 8)
        q = synthetic.queries_from_corpus_query(corpus, n_docs, q_tokens=8, seed=seed)
        toks = q.reshape(-1, corpus.d)
    elif cfg.query_strategy == "corpus":
        if isinstance(corpus.doc_tokens, torch.Tensor):
            flat = corpus.doc_tokens[corpus.doc_mask.bool()]
            idx = rng.integers(0, flat.shape[0], size=cfg.n_train)
            toks = flat[torch.as_tensor(idx, device=flat.device)].cpu().numpy()
        else:
            flat = corpus.doc_tokens[corpus.doc_mask]
            toks = flat[rng.integers(0, flat.shape[0], size=cfg.n_train)]
    elif cfg.query_strategy == "query":
        q = synthetic.queries_held_out(corpus, max(1, cfg.n_train // 8), q_tokens=8,
                                       seed=seed)
        toks = q.reshape(-1, corpus.d)
    else:
        raise ValueError(cfg.query_strategy)
    if toks.shape[0] > cfg.n_train:
        toks = toks[rng.permutation(toks.shape[0])[: cfg.n_train]]
    return np.ascontiguousarray(toks, dtype=np.float32)


def gram_factor(psi: Psi, x_ols: torch.Tensor, ridge: float):
    """Lower Cholesky factor of (Psi^T Psi + ridge n' I) and the features
    Psi (n', d') -> (chol, feats)."""
    feats = fused_psi.fused_psi(x_ols, *psi.params().values())
    n, dp = feats.shape
    gram = feats.T @ feats
    gram.diagonal().add_(ridge * n)
    return torch.linalg.cholesky(gram), feats


def ols_solver_state(psi: Psi, x_ols: torch.Tensor, cfg) -> dict:
    """Reusable solver state: build and incremental indexing share it."""
    chol, feats = gram_factor(psi, x_ols, cfg.ridge)
    return {"chol": chol, "feats": feats, "x_ols": x_ols}


def fit_docs(solver_state: dict, doc_tokens, doc_mask, stats: TargetStats | None = None):
    """W rows (mb, d') for one block of docs: token MaxSim targets over the
    OLS tokens, standardized with the pre-training stats, then the solve."""
    g = maxsim.token_maxsim(solver_state["x_ols"], doc_tokens, doc_mask)   # (n', mb)
    if stats is not None:
        g = (g - stats.mean) / stats.std
    rhs = solver_state["feats"].T @ g                                       # (d', mb)
    return torch.cholesky_solve(rhs, solver_state["chol"]).T


def fit_output_layer_ols(psi: Psi, x_ols, doc_tokens, doc_mask, cfg,
                         stats: TargetStats | None = None, *, doc_block: int = 2048,
                         solver_state: dict | None = None) -> torch.Tensor:
    """Solve eq. (7) for every document, ``doc_block`` docs at a time ->
    W (m, d') fp32.  Pass ``solver_state`` (:func:`ols_solver_state`) to
    reuse a factorized Gram matrix."""
    if solver_state is None:
        solver_state = ols_solver_state(psi, x_ols, cfg)
    solver_state = {**solver_state, "x_ols": x_ols}
    m = doc_tokens.shape[0]
    feats = solver_state["feats"]
    W = torch.empty((m, feats.shape[1]), dtype=torch.float32, device=feats.device)
    for lo in range(0, m, doc_block):
        W[lo:lo + doc_block] = fit_docs(solver_state, doc_tokens[lo:lo + doc_block],
                                        doc_mask[lo:lo + doc_block], stats)
    return W

"""Synthetic multi-vector corpora and the paper's three query strategies
(the port's copy of the corpus half of ``repro/data/synthetic.py``).

The draws are numpy's, in the JAX package's order, so one seed gives the
JAX package's corpus and queries.  The query generators also take a corpus
whose ``doc_tokens`` / ``doc_mask`` are tensors, on any device (a corpus
made on the card): the random draws stay numpy, the token gather runs where
the tokens are, and the result is numpy as before.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MultiVectorCorpus:
    doc_tokens: np.ndarray  # (m, T_max, d) fp32, unit-norm rows (zeros padded)
    doc_mask: np.ndarray    # (m, T_max) bool
    topics: np.ndarray      # (m, n_topics_per_doc) int32 (generator metadata)
    centers: np.ndarray     # (K, d)

    @property
    def m(self) -> int:
        return self.doc_tokens.shape[0]

    @property
    def d(self) -> int:
        return self.doc_tokens.shape[-1]


def _unit(x: np.ndarray, axis: int = -1) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=axis, keepdims=True), 1e-9)


def _numpy(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _doc_counts(corpus) -> np.ndarray:
    """Valid tokens per doc, int64."""
    return _numpy(corpus.doc_mask.sum(1)).astype(np.int64)


def _take_tokens(doc_tokens, docs: np.ndarray, pick: np.ndarray) -> np.ndarray:
    """doc_tokens[docs[:, None], pick] as numpy, gathered where the tokens are."""
    if isinstance(doc_tokens, torch.Tensor):
        dev = doc_tokens.device
        return _numpy(doc_tokens[torch.as_tensor(docs, device=dev)[:, None],
                                 torch.as_tensor(pick, device=dev)])
    return doc_tokens[docs[:, None], pick]


def make_corpus(
    m: int = 20000,
    d: int = 64,
    avg_tokens: int = 24,
    max_tokens: int = 32,
    n_centers: int = 256,
    topics_per_doc: int = 2,
    topic_strength: float = 1.2,
    seed: int = 0,
) -> MultiVectorCorpus:
    rng = np.random.default_rng(seed)
    centers = _unit(rng.standard_normal((n_centers, d), dtype=np.float32))
    topics = rng.integers(0, n_centers, size=(m, topics_per_doc), dtype=np.int32)
    counts = np.clip(rng.poisson(avg_tokens, size=m), 4, max_tokens).astype(np.int32)

    tok = rng.standard_normal((m, max_tokens, d), dtype=np.float32)
    which = rng.integers(0, topics_per_doc, size=(m, max_tokens))
    c = centers[np.take_along_axis(topics, which, axis=1)]  # (m, T, d)
    tok = _unit(tok + topic_strength * c)
    mask = np.arange(max_tokens)[None, :] < counts[:, None]
    tok = tok * mask[..., None]
    return MultiVectorCorpus(tok.astype(np.float32), mask, topics, centers)


def queries_from_corpus_query(
    corpus: MultiVectorCorpus,
    n_queries: int,
    q_tokens: int = 8,
    encoder_noise: float = 0.25,
    seed: int = 1,
) -> np.ndarray:
    """Paper-default *corpus-query* strategy: re-encode sampled docs as
    queries (subset of doc tokens + query-encoder perturbation, fixed
    length).  Returns (n_queries, q_tokens, d) unit-norm."""
    rng = np.random.default_rng(seed)
    docs = rng.integers(0, corpus.m, size=n_queries)
    counts = _doc_counts(corpus)[docs]
    pick = (rng.random((n_queries, q_tokens)) * counts[:, None]).astype(np.int64)
    toks = _take_tokens(corpus.doc_tokens, docs, pick)  # (n, q, d)
    toks = toks + encoder_noise * rng.standard_normal(toks.shape).astype(np.float32)
    return _unit(toks)


def queries_from_corpus(
    corpus: MultiVectorCorpus, n_queries: int, q_tokens: int = 8, seed: int = 1
) -> np.ndarray:
    """*corpus* strategy (App. D.1): raw document-encoder token samples."""
    rng = np.random.default_rng(seed)
    docs = rng.integers(0, corpus.m, size=n_queries)
    counts = _doc_counts(corpus)[docs]
    pick = (rng.random((n_queries, q_tokens)) * counts[:, None]).astype(np.int64)
    return _take_tokens(corpus.doc_tokens, docs, pick).astype(np.float32)


def queries_held_out(
    corpus: MultiVectorCorpus, n_queries: int, q_tokens: int = 8,
    topic_strength: float = 1.2, seed: int = 2
) -> np.ndarray:
    """*query* strategy (App. D.2): fresh queries from the same topic model."""
    rng = np.random.default_rng(seed)
    d = corpus.d
    t = rng.integers(0, corpus.centers.shape[0], size=n_queries)
    tok = rng.standard_normal((n_queries, q_tokens, d), dtype=np.float32)
    return _unit(tok + topic_strength * _numpy(corpus.centers)[t][:, None, :])

"""Synthetic data (the port's copy of ``repro/data/synthetic.py``):
multi-vector corpora and the paper's three query strategies, LM token
streams, MeshGraphNet-style graphs and recsys click logs.

The draws are numpy's, in the JAX package's order, so one seed gives the
JAX package's arrays bit for bit.  The query generators also take a corpus
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


# ---------------------------------------------------------------------------
# LM token streams
# ---------------------------------------------------------------------------

def lm_token_batches(vocab: int, batch: int, seq: int, n_batches: int, seed: int = 0):
    """Zipf-ish synthetic token stream; yields (tokens, labels) int32 pairs."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = 1.0 / ranks
    p /= p.sum()
    for _ in range(n_batches):
        toks = rng.choice(vocab, size=(batch, seq + 1), p=p).astype(np.int32)
        yield toks[:, :-1], toks[:, 1:]


# ---------------------------------------------------------------------------
# graphs (MeshGraphNet-style simulation meshes + big CSR graphs)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Graph:
    senders: np.ndarray     # (E,) int32
    receivers: np.ndarray   # (E,) int32
    node_feat: np.ndarray   # (N, d) fp32
    edge_feat: np.ndarray   # (E, de) fp32
    labels: np.ndarray      # (N, dy) fp32 regression targets
    row_ptr: np.ndarray     # (N+1,) CSR over incoming edges (for sampling)
    col_idx: np.ndarray     # (E,)


def make_mesh_graph(n_nodes: int, avg_degree: int = 6, d_feat: int = 16,
                    d_edge: int = 4, d_out: int = 2, seed: int = 0) -> Graph:
    """Random geometric graph ~= a 2-D simulation mesh (MeshGraphNet regime)."""
    rng = np.random.default_rng(seed)
    pos = rng.random((n_nodes, 2), dtype=np.float32)
    # k-nearest by grid hashing (cheap O(N k) approximation, fine for synthesis)
    k = max(2, avg_degree // 2)
    idx = np.argsort(pos[:, 0], kind="stable")
    senders, receivers = [], []
    for j in range(1, k + 1):
        senders.append(idx[:-j])
        receivers.append(idx[j:])
    s = np.concatenate(senders + receivers)
    r = np.concatenate(receivers + senders)
    rel = pos[s] - pos[r]
    dist = np.linalg.norm(rel, axis=1, keepdims=True)
    edge_feat = np.concatenate(
        [rel, dist, np.ones_like(dist)], axis=1
    )[:, :d_edge].astype(np.float32)
    node_feat = np.concatenate(
        [pos, rng.standard_normal((n_nodes, max(0, d_feat - 2)), dtype=np.float32)], axis=1
    )[:, :d_feat].astype(np.float32)
    labels = np.stack(
        [np.sin(4 * np.pi * pos[:, 0]), np.cos(4 * np.pi * pos[:, 1])], axis=1
    )[:, :d_out].astype(np.float32)

    order = np.argsort(r, kind="stable")
    s, r = s[order].astype(np.int32), r[order].astype(np.int32)
    edge_feat = edge_feat[order]
    row_ptr = np.zeros(n_nodes + 1, np.int64)
    np.add.at(row_ptr, r + 1, 1)
    row_ptr = np.cumsum(row_ptr).astype(np.int64)
    return Graph(s, r, node_feat, edge_feat, labels, row_ptr, s.copy())


# ---------------------------------------------------------------------------
# recsys click logs
# ---------------------------------------------------------------------------

def make_clicks(batch: int, n_fields: int, vocab_sizes: np.ndarray, seed: int = 0,
                hist_len: int = 0, n_items: int = 0):
    """Power-law categorical ids + planted-logistic labels.  Returns dict."""
    rng = np.random.default_rng(seed)
    ids = np.stack(
        [
            np.minimum(
                rng.zipf(1.2, size=batch) - 1, vocab_sizes[f] - 1
            ).astype(np.int32)
            for f in range(n_fields)
        ],
        axis=1,
    )  # (batch, n_fields)
    w = rng.standard_normal(n_fields).astype(np.float32) * 0.3
    logit = (np.sin(ids[:, : n_fields]) * w[None, :]).sum(1)
    labels = (rng.random(batch) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    out = {"ids": ids, "labels": labels}
    if hist_len:
        out["history"] = np.minimum(
            rng.zipf(1.2, size=(batch, hist_len)) - 1, n_items - 1
        ).astype(np.int32)
        out["target_item"] = np.minimum(
            rng.zipf(1.2, size=batch) - 1, n_items - 1
        ).astype(np.int32)
    return out

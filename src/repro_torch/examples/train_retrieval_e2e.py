"""End-to-end example: train a small multi-vector ENCODER for a few hundred
steps (contrastive MaxSim objective), then index its token embeddings with
LEMUR and serve queries — the full train->index->serve lifecycle of a
multi-vector retrieval system (twin of ``examples/train_retrieval_e2e.py``).

The encoder is a small decoder-stack LM (the same ``repro_torch.models.lm``
the LM archs use) read out at every position, ColBERT-style.

  PYTHONPATH=src python -m repro_torch.examples.train_retrieval_e2e [--steps 300]
  PYTHONPATH=src python -m repro_torch.examples.train_retrieval_e2e --steps 2 --docs 300 --device cpu

It runs on the card and raises without one unless ``--device cpu`` is
passed.  ``--docs`` sets the indexed corpus (the JAX twin's 2,000).
``main`` returns the last loss, the recall and the top-1 rate.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.common.pytree import tree_size, value_and_grad
from repro_torch.core import LemurConfig, build_index, maxsim, recall_at
from repro_torch.core.index import query
from repro_torch.data.synthetic import MultiVectorCorpus
from repro_torch.models import lm
from repro_torch.optim import adam_init, adam_update


def make_encoder_cfg(d_model=256, n_layers=8, vocab=8192):
    # ~100M-class config scaled for a small budget (n_layers*12*d^2 + vocab*d)
    return lm.LMConfig(n_layers=n_layers, d_model=d_model, n_heads=8, n_kv_heads=8,
                       head_dim=d_model // 8, d_ff=4 * d_model, vocab=vocab,
                       q_block=32, kv_block=32, loss_chunk=32, remat="none")


def encode(params, tokens, cfg):
    """Per-token unit-norm embeddings (late-interaction representation)."""
    h, _ = lm.forward_train(params, tokens, cfg)
    return h / torch.clamp(torch.linalg.vector_norm(h, dim=-1, keepdim=True), min=1e-6)


def maxsim_logits(qe, de):
    """(B, Tq, d) x (B, Td, d) -> (B, B) in-batch MaxSim score matrix."""
    s = torch.einsum("bqd,ctd->bcqt", qe, de)
    return torch.amax(s, dim=-1).sum(dim=-1)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--docs", type=int, default=2000, help="docs indexed by LEMUR")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = make_encoder_cfg()
    params = lm.init_lm(torch.Generator().manual_seed(0), cfg, device=dev)
    print(f"encoder params: {tree_size(params)/1e6:.1f}M")
    opt = adam_init(params)

    rng = np.random.default_rng(0)

    # synthetic paired data: queries are noisy prefixes of their documents
    def batch(seed):
        r = np.random.default_rng(seed)
        docs = r.integers(0, cfg.vocab, (args.batch, 24)).astype(np.int64)
        qs = docs[:, :8].copy()
        flip = r.random((args.batch, 8)) < 0.1
        qs[flip] = r.integers(0, cfg.vocab, flip.sum())
        return torch.as_tensor(qs).to(dev), torch.as_tensor(docs).to(dev)

    def step(params, opt, qt, dt):
        def loss_fn(p):
            qe = encode(p, qt, cfg)
            de = encode(p, dt, cfg)
            logits = maxsim_logits(qe, de) / 0.5
            lse = torch.logsumexp(logits, dim=-1)
            return torch.mean(lse - torch.diagonal(logits))

        loss, grads = value_and_grad(loss_fn, params)
        with torch.no_grad():
            params, opt, _ = adam_update(grads, opt, params, lr=3e-4, grad_clip=1.0)
        return params, opt, loss

    t0 = time.time()
    loss = None
    for i in range(args.steps):
        qt, dt = batch(i)
        params, opt, loss = step(params, opt, qt, dt)
        if (i + 1) % 50 == 0:
            print(f"step {i+1}/{args.steps} contrastive loss {float(loss):.4f} "
                  f"({(i+1)/(time.time()-t0):.1f} steps/s)")

    # ---- index the encoder's corpus embeddings with LEMUR ----
    m_docs = args.docs
    doc_tok_ids = torch.as_tensor(rng.integers(0, cfg.vocab, (m_docs, 24))).to(dev)
    with torch.no_grad():
        de = encode(params, doc_tok_ids, cfg)
    corpus = MultiVectorCorpus(de, torch.ones(de.shape[:2], dtype=torch.bool, device=dev),
                               np.zeros((m_docs, 1), np.int32),
                               np.zeros((1, de.shape[-1]), np.float32))

    lcfg = LemurConfig(d=cfg.d_model, d_prime=128, m_pretrain=512, n_train=8192,
                       n_ols=2048, epochs=10, k=10, k_prime=128,
                       query_strategy="corpus")
    index = build_index(torch.Generator().manual_seed(1), corpus, lcfg, verbose=True,
                        device=dev)

    # queries = encoded prefixes of a sample of docs
    qids = torch.as_tensor(rng.integers(0, m_docs, 32)).to(dev)
    with torch.no_grad():
        q = encode(params, doc_tok_ids[qids, :8], cfg)
    qm = torch.ones(q.shape[:2], dtype=torch.bool, device=dev)
    _, truth = maxsim.true_topk(q, qm, index.doc_tokens, index.doc_mask, 10)
    _, got = query(index, q, qm)
    rec = float(recall_at(got, truth).mean())
    self_hit = float((got[:, 0].long() == qids).float().mean())
    print(f"LEMUR over trained encoder: recall@10={rec:.3f}, "
          f"query->own-doc top-1 rate={self_hit:.2f}")
    return {"loss": None if loss is None else float(loss), "recall": rec,
            "self_hit": self_hit}


if __name__ == "__main__":
    main()

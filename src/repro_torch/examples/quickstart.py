"""Quickstart: build a LEMUR retriever on a synthetic multi-vector corpus
and retrieve with the full Fig. 1 pipeline — ψ pooling -> latent ANN ->
exact MaxSim rerank — through the LemurRetriever facade, then round-trip it
through save/load (twin of ``examples/quickstart.py``).

  PYTHONPATH=src python -m repro_torch.examples.quickstart
  PYTHONPATH=src python -m repro_torch.examples.quickstart --m 800 --epochs 8   # CI smoke
  PYTHONPATH=src python -m repro_torch.examples.quickstart --m 800 --epochs 8 --device cpu
"""
import argparse
import tempfile

import torch

from repro_torch.common.device import resolve_device
from repro_torch.core import LemurConfig, maxsim, recall_at
from repro_torch.data import synthetic
from repro_torch.retriever import IVFBackendConfig, LemurRetriever, SearchParams


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--m", type=int, default=3000, help="corpus size")
    p.add_argument("--epochs", type=int, default=30, help="psi pretrain epochs")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. a corpus of multi-vector documents (sets of unit-norm token embeddings)
    corpus = synthetic.make_corpus(m=args.m, d=32, avg_tokens=12, max_tokens=16, seed=0)

    # 2. LEMUR: learn ψ against m' sampled docs, fit W rows by OLS, index W.
    #    Backend knobs live in per-backend config namespaces (cfg.ivf, ...).
    cfg = LemurConfig(d=32, d_prime=192, m_pretrain=768, n_train=12288, n_ols=3072,
                      epochs=args.epochs, k=10, k_prime=256, anns="ivf",
                      ivf=IVFBackendConfig(nprobe=48))
    retriever = LemurRetriever.build(corpus, cfg, generator=torch.Generator().manual_seed(0),
                                     device=dev, verbose=True)

    # 3. query (corpus-query strategy mirrors the paper's default); every
    #    query-time knob is a typed, hashable SearchParams
    q = torch.as_tensor(synthetic.queries_from_corpus_query(corpus, 32, q_tokens=8,
                                                            seed=1)).to(dev)
    q_mask = torch.ones(q.shape[:2], dtype=torch.bool, device=dev)
    params = SearchParams(k=10)
    scores, doc_ids = retriever.search(q, q_mask, params)

    # 4. evaluate against exact MaxSim ground truth
    idx = retriever.index
    _, truth = maxsim.true_topk(q, q_mask, idx.doc_tokens, idx.doc_mask, cfg.k)
    recall = float(recall_at(doc_ids, truth).mean())
    print(f"recall@{cfg.k}: {recall:.3f}")
    print("top-3 docs for query 0:", doc_ids[0, :3].tolist(),
          "scores:", [round(float(s), 3) for s in scores[0, :3]])

    # 5. persistence: save/load reproduces the search ids bit-identically
    with tempfile.TemporaryDirectory() as d:
        retriever.save(d)
        reloaded = LemurRetriever.load(d, device=dev)
        _, ids2 = reloaded.search(q, q_mask, params)
        assert torch.equal(ids2, doc_ids)
        print(f"save/load round-trip OK ({reloaded!r}, "
              f"jit traces after reload: {reloaded.trace_count(params)})")
    return {"recall": recall}


if __name__ == "__main__":
    main()

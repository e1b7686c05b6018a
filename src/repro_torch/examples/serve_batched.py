"""Batched serving example: the serving loop with latency percentiles —
any registered first-stage backend vs exact MaxSim on the same corpus,
through the LemurRetriever facade (twin of ``examples/serve_batched.py``).

Doubles as the smoke test of the gather-at-source serving kernels: by
default the fused path serves (``use_fused_gather=True``, the config
default) and the legacy gathered path is timed next to it; pass
``--no-fused-gather`` to serve legacy-only.  The per-query gathered-bytes
count shows what the fused path saves: the legacy path writes every
gathered byte to device memory and reads it back before any math runs.

A third mode serves the ONE-LAUNCH first stage (``use_one_launch=True``:
the probe scan + top-k' in one ``query_fused`` call on the ivf backend)
and every row prints its per-search ``launches`` breakdown — the facade's
plan, in which the one-launch row shows 1 pre-rerank launch (on the card
that one ``query_fused`` call is four CUDA launches).

  PYTHONPATH=src python -m repro_torch.examples.serve_batched
  PYTHONPATH=src python -m repro_torch.examples.serve_batched --backend muvera
  PYTHONPATH=src python -m repro_torch.examples.serve_batched --no-fused-gather
  PYTHONPATH=src python -m repro_torch.examples.serve_batched --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.core import LemurConfig, maxsim, recall_at
from repro_torch.data import synthetic
from repro_torch.retriever import (
    IVFBackendConfig,
    IVFSearchParams,
    LemurRetriever,
    SearchParams,
)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--backend", default="ivf",
                   help="first-stage backend (repro_torch.anns.registry name)")
    p.add_argument("--no-fused-gather", action="store_true",
                   help="serve ONLY the legacy gathered path (skip the fused "
                        "gather-at-source kernels)")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    corpus = synthetic.make_corpus(m=6000, d=32, avg_tokens=12, max_tokens=16, seed=0)
    cfg = LemurConfig(d=32, d_prime=128, m_pretrain=512, n_train=8192, n_ols=2048,
                      epochs=15, k=10, k_prime=128, anns=args.backend,
                      ivf=IVFBackendConfig(nprobe=16))
    retriever = LemurRetriever.build(corpus, cfg, generator=torch.Generator().manual_seed(0),
                                     device=dev, verbose=True)

    idx = retriever.index

    def _params(fused: bool, one_launch: bool = False) -> SearchParams:
        backend = None
        if retriever.backend == "ivf":
            backend = IVFSearchParams(use_fused_gather=fused,
                                      use_one_launch=one_launch)
        return SearchParams(use_fused_gather=fused, backend=backend,
                            use_one_launch=one_launch)

    def _gathered_bytes_per_query(fused: bool) -> int:
        """Device-memory bytes the two serving gathers touch PER QUERY: probed
        IVF lists (ids + vecs [+ scales]) and k' candidate token slabs.  The
        fused path reads these once; the legacy path also WRITES them back as
        the materialized gather and re-reads them in the scoring op (3 trips)."""
        n = 0
        if retriever.backend == "ivf":
            ann = idx.ann
            nprobe = min(cfg.ivf.nprobe, ann.nlist)
            item = 1 if ann.scales is not None else 4
            per_slot = cfg.d_prime * item + 4 + (4 if ann.scales is not None else 0)
            n += nprobe * ann.capacity * per_slot
        td = idx.store.td_max
        n += cfg.k_prime * td * (cfg.d * 4 + 4)
        return n if fused else 3 * n

    doc_tokens, doc_mask = idx.dense_view()
    exact = lambda q, m: maxsim.true_topk(q, m, doc_tokens, doc_mask, cfg.k)  # noqa: E731
    p50 = lambda xs: np.percentile(xs, 50) * 1e3  # noqa: E731
    p99 = lambda xs: np.percentile(xs, 99) * 1e3  # noqa: E731

    # query batches + exact ground truth ONCE (truth depends only on the batch;
    # the exact scan is the slowest op here, no reason to repeat it per mode)
    batches, lat_exact = [], []
    for b in range(8):
        q = torch.as_tensor(synthetic.queries_from_corpus_query(corpus, 32, 8,
                                                                seed=200 + b)).to(dev)
        qm = torch.ones(q.shape[:2], dtype=torch.bool, device=dev)
        t0 = time.perf_counter()
        _, truth = exact(q, qm)
        sync()
        lat_exact.append(time.perf_counter() - t0)
        batches.append((q, qm, truth))
    lat_exact = lat_exact[1:]  # drop the first (warm-up) batch

    def _serve(params):
        lat, recs = [], []
        for q, qm, truth in batches:
            t0 = time.perf_counter()
            s, ids = retriever.search(q, qm, params)
            sync()
            lat.append(time.perf_counter() - t0)
            recs.append(float(recall_at(ids, truth).mean()))
        return lat[1:], recs[1:]  # drop the first (warm-up) batch

    modes = [(False, False, "legacy")] if args.no_fused_gather else \
            [(True, False, "fused "), (False, False, "legacy"),
             (True, True, "1launch")]
    results, rows = {}, {}
    for fused, one_launch, label in modes:
        params = _params(fused, one_launch)
        lat, recs = _serve(params)
        results[label] = lat
        est = _gathered_bytes_per_query(fused)
        plan = retriever.launches(params)
        pre = sum(v for name, v in plan.items() if name != "rerank")
        rows[label.strip()] = dict(params=params, plan=plan, p50_ms=p50(lat),
                                   p99_ms=p99(lat), recall=float(np.mean(recs)))
        print(f"LEMUR[{retriever.backend}|{label}]: p50={p50(lat):.1f}ms "
              f"p99={p99(lat):.1f}ms / 32-query batch "
              f"(~{est/1e6:.2f} MB gathered/query, "
              f"jit traces: {retriever.trace_count(params)}, "
              f"launches: {plan} = {pre} pre-rerank)  "
              f"recall@10={np.mean(recs):.3f}")

    print(f"exact : p50={p50(lat_exact):.1f}ms p99={p99(lat_exact):.1f}ms")
    base = results.get("legacy", next(iter(results.values())))
    print(f"speedup vs exact x{np.mean(lat_exact)/np.mean(base):.1f}")
    if len(results) == 2:
        print(f"fused vs legacy x{np.mean(results['legacy'])/np.mean(results['fused ']):.2f}")
    return {"retriever": retriever, "batches": batches, "rows": rows}


if __name__ == "__main__":
    main()

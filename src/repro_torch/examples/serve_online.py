"""Online serving demo: ragged queries, micro-batching, streaming add (twin
of ``examples/serve_online.py``).

Where ``serve_batched`` times fixed-shape offline slabs, this demo runs the
ONLINE path end to end: a ``RetrieverServer`` in front of the facade, fed a
Poisson trace of ragged single queries (the workload the paper's "order of
magnitude faster online" claim is about), with a streaming ``add()``
landing mid-traffic:

* requests are padded onto the Tq bucket ladder and coalesced into
  micro-batches (``max_batch``/``max_wait_us``), so the number of served
  shapes stays within ``ladder.compile_bound()`` forever;
* ``add()`` is a FIFO barrier — earlier queries answer from the old corpus
  snapshot, the swap is atomic between micro-batches, and a post-add query
  provably retrieves a just-added document;
* the report shows the latency/occupancy tradeoff knobs.

  PYTHONPATH=src python -m repro_torch.examples.serve_online
  PYTHONPATH=src python -m repro_torch.examples.serve_online --rate 300 --max-wait-us 5000
  PYTHONPATH=src python -m repro_torch.examples.serve_online --m 1000 --duration 2 --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.core import LemurConfig
from repro_torch.data import synthetic
from repro_torch.retriever import IVFBackendConfig, LemurRetriever, SearchParams
from repro_torch.serving import (
    BucketLadder,
    RetrieverServer,
    poisson_trace,
    ragged_queries,
    replay,
    warm_buckets,
)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--m", type=int, default=4000)
    p.add_argument("--rate", type=float, default=150.0,
                   help="offered load, queries/second")
    p.add_argument("--duration", type=float, default=6.0)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-wait-us", type=int, default=2000,
                   help="head-of-line budget: higher -> fuller batches, "
                        "higher p50")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    corpus = synthetic.make_corpus(m=args.m, d=32, avg_tokens=12, max_tokens=16,
                                   seed=0)
    cfg = LemurConfig(d=32, d_prime=64, m_pretrain=512, n_train=8192, n_ols=2048,
                      epochs=10, k=10, k_prime=128, anns="ivf",
                      ivf=IVFBackendConfig(nprobe=16))
    retriever = LemurRetriever.build(corpus, cfg, generator=torch.Generator().manual_seed(0),
                                     device=dev, verbose=True)

    ladder = BucketLadder((8, 16, 32), max_batch=args.max_batch)
    queries = ragged_queries(256, 32, tq_range=(2, 24), seed=1)
    print(f"ladder: Tq buckets {ladder.tq_ladder}, batch sizes "
          f"{ladder.batch_sizes()}, compile bound {ladder.compile_bound()}")

    with RetrieverServer(retriever, ladder=ladder,
                         max_wait_us=args.max_wait_us) as server:
        warm_buckets(retriever, ladder, 32)
        print(f"warmed {server.trace_count()} bucketed shapes "
              f"(<= bound {ladder.compile_bound()})")

        # phase 1: steady-state Poisson traffic
        _, report = replay(server, queries,
                           poisson_trace(args.rate, args.duration, seed=2))
        print(f"steady:   p50={report['p50_ms']:.2f}ms p95={report['p95_ms']:.2f}ms "
              f"p99={report['p99_ms']:.2f}ms  qps={report['qps']:.0f} "
              f"(offered {report['offered_qps']:.0f})  "
              f"occupancy={report['mean_occupancy']:.2f}")
        print(f"occupancy histogram (requests per micro-batch): "
              f"{report['occupancy_hist']}")

        # phase 2: streaming add lands mid-traffic
        extra = synthetic.make_corpus(m=64, d=32, avg_tokens=12, max_tokens=16,
                                      seed=9)
        add_fut = server.add(extra.doc_tokens, extra.doc_mask)
        _, report2 = replay(server, queries,
                            poisson_trace(args.rate, 2.0, seed=3))
        new_m = add_fut.result(timeout=300)
        target = extra.doc_tokens[0][extra.doc_mask[0]]
        # exact latent scan with full coverage: the new doc MUST come back top-1
        exact = SearchParams(use_ann=False, k_prime=new_m)
        _, ids = server.search(np.asarray(target), params=exact, timeout=300)
        found = bool(ids[0] >= args.m)
        print(f"add:      corpus {args.m} -> {new_m} docs mid-traffic; "
              f"post-add query retrieves new doc {int(ids[0])} "
              f"({'OK' if found else 'MISSING'})")
        print(f"post-add: p50={report2['p50_ms']:.2f}ms "
              f"p99={report2['p99_ms']:.2f}ms  qps={report2['qps']:.0f}")
        print(f"jit traces total: {server.trace_count()} "
              f"(bound {ladder.compile_bound()} per snapshot)")
    return {"steady": report, "post_add": report2, "new_doc_found": found}


if __name__ == "__main__":
    main()

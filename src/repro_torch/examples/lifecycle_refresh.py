"""Learned-index lifecycle demo: drift -> background refresh -> warm swap
(twin of ``examples/lifecycle_refresh.py``).

A LEMUR index is a *fit*: the OLS latent map and the IVF centroids are
optimal for the corpus they were built on.  Stream in enough
distribution-shifted documents and first-stage recall silently decays —
nothing errors, results just get worse.  This demo walks the closed loop
that repairs it, then injects a fault to show the failure contract:

1. serve a built index and feed the ``DriftMonitor`` an in-distribution
   trickle: the coverage signal stays near baseline, NO trigger;
2. add a topic-shifted burst: first-stage self-retrieval coverage of the
   new docs collapses and the monitor trips with a typed ``DriftReport``;
3. a chaos-injected refresh dies mid-rebuild: serving is bit-identically
   untouched, the manager records ``RefreshFailed`` and retries;
4. the retry re-fits W + re-clusters IVF off-thread and warm-swaps through
   the server's FIFO barrier: searches submitted before the swap answer
   from the old snapshot (stamped with its version), later ones from the
   refit index, zero requests dropped.

  PYTHONPATH=src python -m repro_torch.examples.lifecycle_refresh
  PYTHONPATH=src python -m repro_torch.examples.lifecycle_refresh --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.core import LemurConfig
from repro_torch.data import synthetic
from repro_torch.lifecycle import ChaosInjector, DriftMonitor, LifecycleManager
from repro_torch.retriever import IVFBackendConfig, LemurRetriever, SearchParams
from repro_torch.serving import BucketLadder, RetrieverServer

M, D = 600, 32


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    corpus = synthetic.make_corpus(m=M, d=D, avg_tokens=12, max_tokens=16, seed=0)
    cfg = LemurConfig(d=D, d_prime=64, m_pretrain=256, n_train=4096, n_ols=1024,
                      epochs=4, k=10, k_prime=128, anns="ivf",
                      ivf=IVFBackendConfig(nprobe=16))
    retriever = LemurRetriever.build(corpus, cfg, generator=torch.Generator().manual_seed(0),
                                     device=dev, verbose=True)

    chaos = ChaosInjector()
    chaos.fail_at("refresh:refit")          # kill the FIRST rebuild mid-train

    with RetrieverServer(retriever, ladder=BucketLadder((8, 16), max_batch=8),
                         max_wait_us=2000) as srv:
        # the trigger threshold is an operating knob: this corpus' in-dist
        # coverage ratio sits around 0.7 of baseline, the burst's around 0.4,
        # so trigger halfway; probe the whole reservoir for a stable read
        monitor = DriftMonitor(retriever, seed=0, probe_docs=192,
                               coverage_ratio_threshold=0.55)
        mgr = LifecycleManager(srv, monitor=monitor, seed=1, chaos=chaos,
                               cooldown_s=0.0, min_reservoir=64)
        mgr.start(auto=False)               # manual polling, so the demo narrates

        # -- 1. in-distribution adds: the monitor stays quiet ------------------
        indist = synthetic.make_corpus(m=M + 96, d=D, avg_tokens=12,
                                       max_tokens=16, seed=0)
        fa = srv.add(indist.doc_tokens[M:], indist.doc_mask[M:])
        fa.result(timeout=300)
        report = monitor.report()
        print(f"in-dist adds : coverage={report.coverage:.3f} "
              f"(baseline {report.baseline_coverage:.3f})  "
              f"triggered={report.triggered}")
        assert not report.triggered

        # -- 2. topic-shifted burst: coverage collapses, the monitor trips -----
        # the in-distribution docs churn away (a delete also drops them from
        # the monitor's reservoir), so RECENT mutations are burst-dominated
        burst = synthetic.make_corpus(m=192, d=D, avg_tokens=12, max_tokens=16,
                                      n_centers=6, topic_strength=4.0, seed=777)
        srv.add(burst.doc_tokens, burst.doc_mask).result(timeout=300)
        srv.delete(np.asarray(fa.added_ids)).result(timeout=300)
        srv.delete(np.arange(96)).result(timeout=300)
        report = monitor.report()
        print(f"topic burst  : coverage={report.coverage:.3f} -> "
              f"triggered={report.triggered}  ({report.reason})")
        assert report.triggered

        # -- 3. chaos kills the first refresh: serving untouched, typed event --
        q = np.asarray(burst.doc_tokens[0][burst.doc_mask[0]], np.float32)
        pre = srv.submit(q)
        v0 = retriever.version
        ok = mgr.poll_once()
        failed = mgr.events()[-1]
        print(f"chaos refresh: swap_completed={ok}  last_event={failed.kind}"
              f"(phase={getattr(failed, 'phase', '?')})  "
              f"version still {retriever.version}")
        assert not ok and retriever.version == v0

        # -- 4. the retry succeeds and warm-swaps behind the FIFO barrier ------
        ok = mgr.poll_once()
        s, ids = pre.result(timeout=300)
        print(f"retry        : swap_completed={ok}  "
              f"version {v0} -> {retriever.version}  "
              f"pre-swap future answered by snapshot v{pre.snapshot_version}")
        assert ok and retriever.version == v0 + 1 and pre.snapshot_version <= v0

        _, post_ids = srv.search(q, params=SearchParams(k=10, k_prime=128),
                                 timeout=300)
        print(f"post-swap    : top-1 for a burst-doc query = doc "
              f"{int(post_ids[0])} (burst slots start at {M + 96})")

        print("\nevent log:")
        for ev in mgr.events():
            print(f"  {ev.kind:>16}: {ev}")
        mgr.stop()
    print("done")
    return {"events": mgr.events(), "version": retriever.version}


if __name__ == "__main__":
    main()

"""Serving launcher: single replica or fleet, with the learned-index
lifecycle optionally closed behind ``--refresh``.

The counterpart of the repository's top-level ``launch/serve.py`` (the JAX
script; the port keeps its launchers under ``repro_torch.launch``), with its
flags, its fixed config (d' = 64) and its printed lines, plus ``--device``.

Builds a LEMUR retriever over a synthetic corpus, fronts it with the online
runtime (one ``RetrieverServer``, or ``--replicas N`` behind the fleet
``Router``), and replays Poisson traffic.  With ``--refresh`` a
``LifecycleManager`` polls the ``DriftMonitor`` in the background: when the
first-stage coverage of recently-mutated docs decays past the trigger, it
re-fits the latent map and re-clusters the first stage off-thread, then
warm-swaps the rebuilt index through the server/fleet FIFO barrier —
in-flight searches keep answering from the snapshot they were stamped with
and zero requests are dropped.  ``--drift-burst`` injects a topic-shifted
document burst mid-traffic so the whole loop can be watched end to end (it
then serves on for up to 120 s waiting for a swap):

  PYTHONPATH=src python -m repro_torch.launch.serve_lifecycle --m 2000 --duration 6
  PYTHONPATH=src python -m repro_torch.launch.serve_lifecycle --refresh --drift-burst 256
  PYTHONPATH=src python -m repro_torch.launch.serve_lifecycle --replicas 3 --refresh \\
      --drift-burst 256 --refresh-min-reservoir 64
  PYTHONPATH=src python -m repro_torch.launch.serve_lifecycle --m 2000 --device cpu

``main`` returns the last replay's report, the manager's swap count and
event log, and the monitor's last report, for callers that run it
in-process.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def _version(target) -> int:
    v = getattr(target, "version", None)   # Router property; servers expose
    return int(v if v is not None else target.retriever.version)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--m", type=int, default=2000)
    p.add_argument("--d", type=int, default=32)
    p.add_argument("--rate", type=float, default=100.0,
                   help="offered load, queries/second (Poisson)")
    p.add_argument("--duration", type=float, default=6.0,
                   help="seconds per replay slice")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-wait-us", type=int, default=2000)
    p.add_argument("--backend", default="ivf")
    p.add_argument("--epochs", type=int, default=6)
    p.add_argument("--replicas", type=int, default=1,
                   help=">1 serves through the fleet Router")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--refresh", action="store_true",
                   help="run the lifecycle loop: drift detection, "
                        "background refresh, zero-downtime warm swap")
    p.add_argument("--refresh-interval", type=float, default=0.25,
                   help="drift poll interval, seconds")
    p.add_argument("--refresh-cooldown", type=float, default=2.0,
                   help="min seconds between refresh attempts")
    p.add_argument("--refresh-min-reservoir", type=int, default=64,
                   help="mutated docs required before a drift report")
    p.add_argument("--refresh-threshold", type=float, default=0.25,
                   help="coverage-ratio trigger: refresh when first-stage "
                        "coverage of recent mutations falls below this "
                        "fraction of the post-build baseline")
    p.add_argument("--refresh-seed", type=int, default=1,
                   help="seed for the background rebuild (determinism)")
    p.add_argument("--drift-burst", type=int, default=0,
                   help="inject N topic-shifted docs mid-traffic (plus "
                        "N//2 deletes) to exercise the refresh")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default: the card; raises without one) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    from repro_torch.common.device import resolve_device
    from repro_torch.core import LemurConfig
    from repro_torch.data import synthetic
    from repro_torch.fleet import Router, clone_replicas
    from repro_torch.lifecycle import DriftMonitor, LifecycleManager
    from repro_torch.retriever import IVFBackendConfig, LemurRetriever
    from repro_torch.serving import (
        BucketLadder,
        RetrieverServer,
        poisson_trace,
        ragged_queries,
        replay,
        warm_buckets,
    )

    args = parse_args(argv)
    dev = resolve_device(args.device)
    corpus = synthetic.make_corpus(m=args.m, d=args.d, avg_tokens=12,
                                   max_tokens=16, seed=args.seed)
    cfg = LemurConfig(d=args.d, d_prime=64, m_pretrain=min(512, args.m),
                      n_train=8192, n_ols=2048, epochs=args.epochs, k=10,
                      k_prime=min(128, args.m), anns=args.backend,
                      ivf=IVFBackendConfig(nprobe=16))
    retriever = LemurRetriever.build(corpus, cfg,
                                     generator=torch.Generator().manual_seed(args.seed),
                                     device=dev, verbose=True)
    ladder = BucketLadder((8, 16, 32), max_batch=args.max_batch)
    queries = ragged_queries(256, args.d, tq_range=(2, 24), seed=args.seed + 1)

    if args.replicas > 1:
        replicas = clone_replicas(retriever, args.replicas)
        target = Router(replicas, ladder=ladder,
                        max_wait_us=args.max_wait_us)
        served = replicas[0]
    else:
        target = RetrieverServer(retriever, ladder=ladder,
                                 max_wait_us=args.max_wait_us)
        served = retriever
    mgr = mon = None
    reports = []
    with target:
        if args.replicas > 1:
            for rep in replicas:
                warm_buckets(rep, ladder, args.d)
        else:
            warm_buckets(retriever, ladder, args.d)
        if args.refresh:
            # monitor the SERVED index (replica 0 for a fleet — replicas are
            # bit-identical between barriers), not the unserved build
            mon = DriftMonitor(
                served, seed=args.seed,
                coverage_ratio_threshold=args.refresh_threshold)
            mgr = LifecycleManager(
                target, monitor=mon, seed=args.refresh_seed,
                poll_interval_s=args.refresh_interval,
                cooldown_s=args.refresh_cooldown,
                min_reservoir=args.refresh_min_reservoir)
            mgr.start()
            print(f"lifecycle: polling every {args.refresh_interval}s, "
                  f"trigger at coverage < {args.refresh_threshold} * "
                  f"baseline, min reservoir "
                  f"{args.refresh_min_reservoir}")

        _, rep = replay(target, queries,
                        poisson_trace(args.rate, args.duration,
                                      seed=args.seed + 2))
        reports.append(rep)
        print(f"steady:   p50={rep['p50_ms']:.2f}ms p99={rep['p99_ms']:.2f}ms "
              f"qps={rep['qps']:.0f} lost={rep['n_lost']} "
              f"version={_version(target)}")

        if args.drift_burst:
            burst = synthetic.make_corpus(
                m=args.drift_burst, d=args.d, avg_tokens=12, max_tokens=16,
                n_centers=6, topic_strength=4.0, seed=777)
            fa = target.add(burst.doc_tokens, burst.doc_mask)
            fd = target.delete(np.arange(args.drift_burst // 2))
            _, rep = replay(target, queries,
                            poisson_trace(args.rate, args.duration,
                                          seed=args.seed + 3))
            reports.append(rep)
            fa.result(timeout=300)
            fd.result(timeout=300)
            print(f"drift:    +{args.drift_burst}/-{args.drift_burst // 2} "
                  f"docs mid-traffic; p99={rep['p99_ms']:.2f}ms "
                  f"lost={rep['n_lost']} version={_version(target)}")
            if mgr is not None:
                # keep serving while the background loop detects + swaps
                deadline = time.perf_counter() + 120.0
                while mgr.n_swaps == 0 and time.perf_counter() < deadline:
                    _, rep = replay(target, queries,
                                    poisson_trace(args.rate, 1.0,
                                                  seed=args.seed + 4))
                    reports.append(rep)
                    if rep["n_lost"]:
                        raise SystemExit(f"lost {rep['n_lost']} requests")
                print(f"swap:     n_swaps={mgr.n_swaps} "
                      f"version={_version(target)} p99={rep['p99_ms']:.2f}ms")

        if mgr is not None:
            mgr.stop()
            for ev in mgr.events():
                print(f"  event: {ev.kind} {ev}")
        version = _version(target)
    print("done")
    return {"reports": reports, "version": version,
            "n_swaps": mgr.n_swaps if mgr is not None else 0,
            "events": mgr.events() if mgr is not None else [],
            "monitor_report": mon.report() if mon is not None else None}


if __name__ == "__main__":
    main()

"""Fleet serving demo: replicated router, deadlines, SLO-adaptive search
(twin of ``examples/serve_fleet.py``).

Where ``serve_online`` runs ONE micro-batching server, this demo fronts N
replicas of the same retriever with ``repro_torch.fleet.Router`` and
exercises the fleet semantics end to end:

* **dispatch + parity** — least-outstanding-requests routing; sampled fleet
  answers are re-checked bit-identical against a direct facade search;
* **deadlines + admission control** — every request carries a deadline and
  the router's outstanding-request bound turns excess load into typed
  ``Overloaded`` rejects instead of unbounded queueing;
* **SLO-adaptive search** — an ``SLOController`` watches the windowed p99
  and walks ``SearchParams`` down a pre-warmed rung ladder (smaller
  ``nprobe``/``k_prime``) under sustained breach, with hysteretic recovery;
* **snapshot-consistent add** — one ``add()`` fans out to every replica
  behind a write barrier: the aggregate resolves only when ALL replicas
  sit at the same ``snapshot_version``, and a post-add query retrieves the
  new document on whichever replica answers;
* **chaos** — a replica is wedged mid-traffic; the health monitor
  quarantines it and re-homes its in-flight requests (nothing lost).

  PYTHONPATH=src python -m repro_torch.examples.serve_fleet
  PYTHONPATH=src python -m repro_torch.examples.serve_fleet --replicas 3 --rate 2000
  PYTHONPATH=src python -m repro_torch.examples.serve_fleet --duration 2 --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.core import LemurConfig
from repro_torch.data import synthetic
from repro_torch.fleet import (
    Router,
    SLOController,
    build_rungs,
    clone_replicas,
    warm_replicas,
)
from repro_torch.retriever import IVFBackendConfig, LemurRetriever, SearchParams
from repro_torch.serving import BucketLadder, poisson_trace, ragged_queries, replay


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--m", type=int, default=2000)
    p.add_argument("--replicas", type=int, default=2)
    p.add_argument("--rate", type=float, default=1000.0,
                   help="offered load for the overload phase, queries/second")
    p.add_argument("--duration", type=float, default=4.0)
    p.add_argument("--deadline-ms", type=float, default=250.0)
    p.add_argument("--queue-depth", type=int, default=48)
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    d = 32
    corpus = synthetic.make_corpus(m=args.m, d=d, avg_tokens=12, max_tokens=16,
                                   seed=0)
    cfg = LemurConfig(d=d, d_prime=64, m_pretrain=512, n_train=8192, n_ols=2048,
                      epochs=10, k=10, k_prime=128, anns="ivf",
                      ivf=IVFBackendConfig(nprobe=16))
    retriever = LemurRetriever.build(corpus, cfg, generator=torch.Generator().manual_seed(0),
                                     device=dev, verbose=True)

    ladder = BucketLadder((8, 16, 32), max_batch=8)
    queries = ragged_queries(256, d, tq_range=(2, 24), seed=1)
    reps = clone_replicas(retriever, args.replicas)
    rungs = build_rungs(retriever)
    print(f"\nfleet: {args.replicas} replicas, rung ladder "
          f"{[(r.k_prime, getattr(r.backend, 'nprobe', None)) for r in rungs]}")
    warmed = warm_replicas(reps, ladder, d, params_list=rungs)
    print(f"warmed {warmed} shapes "
          f"(= replicas x ladder.compile_bound({len(rungs)}))")

    # phase 1: light traffic — parity + balanced dispatch --------------------
    with Router(reps, ladder=ladder, max_queue_depth=args.queue_depth,
                default_deadline_s=args.deadline_ms / 1e3,
                stall_timeout_s=60.0) as router:
        futs = [router.submit(q) for q in queries[:32]]
        served = set()
        for f, q in zip(futs, queries[:32]):
            _, ids = f.result(timeout=120)
            _, want = retriever.search(q[None], np.ones((1, len(q)), bool))
            assert np.array_equal(ids, want.cpu().numpy()[0]), "parity broke"
            served.add(f.replica)
        print(f"\n[1] parity ok over 32 requests, served by replicas {sorted(served)}")

        # phase 2: snapshot-consistent add ----------------------------------
        grow = synthetic.make_corpus(m=4, d=d, avg_tokens=12, max_tokens=16,
                                     seed=7)
        af = router.add(grow.doc_tokens, grow.doc_mask)
        new_m = af.result(timeout=300)
        probe = np.asarray(grow.doc_tokens[0][grow.doc_mask[0]])
        f = router.submit(probe, params=SearchParams(use_ann=False, k_prime=new_m))
        _, ids = f.result(timeout=120)
        print(f"[2] add barrier: m {args.m} -> {new_m}, every replica at "
              f"snapshot {af.snapshot_version}; post-add probe found doc "
              f"{int(ids[0])} (expected {args.m}) on replica {f.replica}")
        added_found = int(ids[0]) == args.m

    # the add grew the corpus, so every served shape's state is new — re-warm
    # outside the serving path so phases 3/4 measure serving, not first
    # launches (and the chaos phase's tight stall timeout doesn't mistake a
    # slow first launch for a wedged replica)
    warm_replicas(reps, ladder, d, params_list=rungs)

    # phase 3: overload — SLO downshift + typed rejects ----------------------
    slo = SLOController(rungs, target_p99_ms=25.0, window=64, min_window=16,
                        eval_every=16)
    arrivals = poisson_trace(args.rate, args.duration, seed=2)
    with Router(reps, ladder=ladder, max_queue_depth=args.queue_depth,
                default_deadline_s=args.deadline_ms / 1e3, slo=slo,
                stall_timeout_s=60.0) as router:
        _, report = replay(router, queries, arrivals)
        print(f"\n[3] overload at {args.rate:g} qps for {args.duration:g}s: "
              f"p50={report['p50_ms']:.1f}ms p99={report['p99_ms']:.1f}ms "
              f"achieved={report['qps']:.0f}qps rejected={report['n_rejected']} "
              f"expired={report['n_expired']} lost={report['n_lost']}")
        for tr in slo.transitions:
            print(f"    slo {tr.direction}: rung {tr.from_rung} -> {tr.to_rung} "
                  f"(windowed p99 {tr.p99_ms:.1f}ms vs target {tr.target_ms:.1f}ms)")
        print(f"    final rung {slo.rung}/{len(rungs) - 1}")

    # phase 4: chaos — wedge a replica, watch the quarantine -----------------
    with Router(reps, ladder=ladder, max_queue_depth=None,
                stall_timeout_s=0.4, health_interval_s=0.05) as router:
        router.servers[0].pause()          # wedge replica 0 mid-traffic
        futs = [router.submit(q) for q in queries[:12]]
        for f in futs:
            f.result(timeout=120)          # all complete despite the wedge
        time.sleep(0.1)
        quarantined = router.quarantined()
        print(f"\n[4] chaos: wedged replica 0 -> quarantined={quarantined} "
              f"healthy={router.n_healthy}/{args.replicas}, all 12 in-flight "
              f"requests re-homed and completed")
        for ev in router.events():
            print(f"    event: {ev}")
    return {"overload": report, "added_found": added_found, "quarantined": quarantined}


if __name__ == "__main__":
    main()

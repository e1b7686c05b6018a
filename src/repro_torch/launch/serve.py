"""Serving launcher: build a LEMUR retriever over a synthetic corpus and
serve batched retrieval requests, reporting QPS + recall for any registered
first-stage backend (twin of ``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --m 8000 --batch 64
  PYTHONPATH=src python -m repro_torch.launch.serve --backend muvera --m 4000
  PYTHONPATH=src python -m repro_torch.launch.serve --backend all --m 4000
  PYTHONPATH=src python -m repro_torch.launch.serve --m 1200 --device cpu

It runs on the card (``--device cuda``, the default) and raises without
one unless ``--device cpu`` is passed.  ``--backend`` takes any name from
``repro_torch.anns.registry`` (or ``all`` to sweep every backend over the
SAME trained reduction via ``LemurRetriever.with_backend``).  The facade
counts one compile-cache entry per (backend, SearchParams, batch shape), as
JAX's jit would hold, and the launcher reports that count (``jit_traces``).
The first batch is excluded from BOTH the QPS and the recall aggregates,
so the reported operating point is steady-state.

``--mesh 1x8`` additionally serves through ``LemurRetriever.shard(mesh)``
(the corpus block-sharded over the flattened mesh, per-shard latent scan +
rerank, merged top-k) and reports sharded QPS next to the single-device
numbers.  A ``torch.distributed`` mesh is a process a rank: ``--mesh 1``
runs in this process, ``--mesh N`` under ``torchrun``, every rank building
the same retriever and rank 0 printing:

  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \\
      --m 8000 --mesh 4

``--online`` switches from offline fixed-shape batches to the online
runtime (``repro_torch.serving``): ragged single queries replayed from a
seeded Poisson trace through ``RetrieverServer`` (shape-bucketed
micro-batching, ``--online-rate`` offered QPS for ``--online-duration``
seconds), reporting p50/p95/p99 latency, achieved QPS, micro-batch
occupancy, and the served-shape count against the bucket-ladder bound:

  PYTHONPATH=src python -m repro_torch.launch.serve --m 8000 --online \\
      --online-rate 200 --online-duration 10

``--fleet N`` serves the same Poisson replay through
``repro_torch.fleet.Router`` fronting N replicas (least-outstanding
dispatch, per-request deadlines via ``--fleet-deadline-ms``, admission
control via ``--fleet-queue-depth``, and — with ``--fleet-slo-ms`` — the
SLO controller walking the rung ladder under load):

  PYTHONPATH=src python -m repro_torch.launch.serve --m 8000 --fleet 2 \\
      --online-rate 400 --fleet-slo-ms 50

``main`` returns the retriever it served, the query batches (with their
exact top-k) and the printed rows, for callers that run it in-process.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import time

import torch


def _serve_loop(search, batches, args):
    """(qps, recall) over ``batches``, excluding the first batch from both
    aggregates so the operating point is steady-state; the clock stops once
    the card (the ids' device) has finished."""
    from repro_torch.core import recall_at

    total_q, total_t, recs = 0, 0.0, []
    for b, (q, qm, truth) in enumerate(batches):
        t0 = time.time()
        s, ids = search(q, qm)
        if ids.device.type == "cuda":
            torch.cuda.synchronize(ids.device)
        dt = time.time() - t0
        if b > 0:  # skip the first batch in QPS *and* recall
            total_q += args.batch
            total_t += dt
            recs.append(float(recall_at(ids, truth).mean()))
        elif len(batches) == 1:  # recall is timing-free: better one sample
            recs.append(float(recall_at(ids, truth).mean()))  # than a fake 0
    return total_q / max(total_t, 1e-9), sum(recs) / max(len(recs), 1)


def serve_backend(retriever, backend, batches, args, *, generator=None):
    """Serve ``batches`` through ``retriever`` re-pointed at ``backend``;
    returns a metrics dict.  ``batches`` is a list of (q, qm, truth) —
    ground truth is computed once in main() since the query stream is
    identical across backends; ``generator`` draws a rebuilt backend's
    random parts."""
    from repro_torch.anns import registry
    from repro_torch.retriever import SearchParams

    # serve the retriever's own state when it already runs this backend
    # (so --save-dir round-trips actually serve the LOADED first-stage
    # state); rebuild only when sweeping onto a different backend
    if retriever.backend == registry.canonical(backend):
        r = retriever
    else:
        r = retriever.with_backend(backend, generator=generator)
    params = SearchParams(k=args.k)
    qps, rec = _serve_loop(lambda q, qm: r.search(q, qm, params), batches, args)
    traces = r.trace_count()
    print(f"[serve] backend={backend:13s} QPS={qps:.0f}  "
          f"recall@{args.k}={rec:.3f}  jit_traces={traces}")
    return {"backend": backend, "qps": qps, f"recall@{args.k}": rec,
            "jit_traces": traces}


def serve_sharded(retriever, mesh_spec, batches, args):
    """Serve ``batches`` through ``retriever.shard(mesh)`` and report the
    sharded operating point next to the single-device rows."""
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.retriever import SearchParams

    mesh = make_serving_mesh(mesh_spec, device=retriever.device)
    sr = retriever.shard(mesh)
    rows = []
    # flip the one-launch scan both ways: the per-shard mips_topk kernel
    # AND the blocked product + top-k' (distinct compile keys; ids agree)
    for one_launch in (False, True):
        params = SearchParams(k=args.k, use_one_launch=one_launch)
        qps, rec = _serve_loop(lambda q, qm: sr.search(q, qm, params),
                               batches, args)
        traces = sr.trace_count()
        print(f"[serve] mesh={mesh_spec:>7s} sharded QPS={qps:.0f}  "
              f"recall@{args.k}={rec:.3f}  jit_traces={traces}  "
              f"sq8={sr.sq8}  one_launch={one_launch}")
        rows.append({"mesh": mesh_spec, "qps": qps, f"recall@{args.k}": rec,
                     "jit_traces": traces, "one_launch": one_launch})
    return rows[-1]


def serve_online(retriever, args):
    """Online operating point: Poisson replay of ragged single queries
    through the micro-batching server; prints the latency/occupancy row."""
    from repro_torch.serving import (
        BucketLadder,
        RetrieverServer,
        poisson_trace,
        ragged_queries,
        replay,
        warm_buckets,
    )

    ladder = BucketLadder(tuple(int(t) for t in args.online_ladder.split(",")),
                          max_batch=args.online_max_batch)
    queries = ragged_queries(256, retriever.cfg.d,
                             tq_range=(2, ladder.tq_ladder[-1]), seed=17)
    arrivals = poisson_trace(args.online_rate, args.online_duration, seed=18)
    offline_traces = retriever.trace_count()   # the offline phase's shapes
    with RetrieverServer(retriever, ladder=ladder,
                         max_wait_us=args.online_max_wait_us) as srv:
        warm_buckets(retriever, ladder, retriever.cfg.d)
        _, report = replay(srv, queries, arrivals)
    bound = ladder.compile_bound(1)
    online_traces = report["trace_count"] - offline_traces
    print(f"[serve] online rate={args.online_rate:g}qps "
          f"p50={report['p50_ms']:.2f}ms p95={report['p95_ms']:.2f}ms "
          f"p99={report['p99_ms']:.2f}ms achieved={report['qps']:.0f}qps "
          f"occupancy={report['mean_occupancy']:.2f} "
          f"jit_traces={online_traces}/{bound}")
    assert online_traces <= bound, "bucket-ladder compile bound blown"
    return report


def serve_fleet(retriever, args):
    """Fleet operating point: the --online Poisson replay through a
    replicated Router — deadlines, admission control, and (optionally) the
    SLO-adaptive rung ladder.  Prints the fleet row + any rung transitions."""
    from repro_torch.fleet import Router, SLOController, build_rungs, \
        clone_replicas, warm_replicas
    from repro_torch.serving import BucketLadder, poisson_trace, ragged_queries, \
        replay

    ladder = BucketLadder(tuple(int(t) for t in args.online_ladder.split(",")),
                          max_batch=args.online_max_batch)
    queries = ragged_queries(256, retriever.cfg.d,
                             tq_range=(2, ladder.tq_ladder[-1]), seed=17)
    arrivals = poisson_trace(args.online_rate, args.online_duration, seed=18)

    reps = clone_replicas(retriever, args.fleet)
    slo = None
    params_list = (None,)
    if args.fleet_slo_ms is not None:
        rungs = build_rungs(retriever)
        slo = SLOController(rungs, target_p99_ms=args.fleet_slo_ms)
        params_list = rungs
    warmed = warm_replicas(reps, ladder, retriever.cfg.d,
                           params_list=params_list)
    deadline_s = (args.fleet_deadline_ms / 1e3
                  if args.fleet_deadline_ms is not None else None)
    with Router(reps, ladder=ladder, max_wait_us=args.online_max_wait_us,
                max_queue_depth=args.fleet_queue_depth,
                default_deadline_s=deadline_s, slo=slo) as router:
        _, report = replay(router, queries, arrivals)
        bound = router.compile_bound(len(params_list))
        traces = router.trace_count()
        print(f"[serve] fleet replicas={args.fleet} "
              f"rate={args.online_rate:g}qps "
              f"p50={report['p50_ms']:.2f}ms p99={report['p99_ms']:.2f}ms "
              f"achieved={report['qps']:.0f}qps "
              f"rejected={report['n_rejected']} expired={report['n_expired']} "
              f"lost={report['n_lost']} healthy={router.n_healthy} "
              f"jit_traces={traces}/{bound} (warmed {warmed})")
        if slo is not None:
            for tr in slo.transitions:
                print(f"[serve]   slo {tr.direction}: rung {tr.from_rung} -> "
                      f"{tr.to_rung} (p99 {tr.p99_ms:.1f}ms, "
                      f"target {tr.target_ms:.1f}ms)")
            print(f"[serve]   slo final rung={slo.rung}/{len(slo.rungs) - 1}")
        assert traces <= bound, "bucket-ladder compile bound blown"
        assert report["n_lost"] == 0, "fleet lost requests without an outcome"
    return report


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--m", type=int, default=8000)
    p.add_argument("--d", type=int, default=48)
    p.add_argument("--d-prime", type=int, default=128)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--n-batches", type=int, default=5)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--backend", default="ivf",
                   help="registered anns backend name, or 'all'")
    p.add_argument("--save-dir", default=None,
                   help="optional: persist the built retriever here "
                        "(LemurRetriever.save) and reload before serving")
    p.add_argument("--mesh", default=None,
                   help="also serve sharded over this mesh, e.g. '1x8' "
                        "(one rank a device: torchrun for more than 1)")
    p.add_argument("--online", action="store_true",
                   help="also serve a Poisson replay of ragged single "
                        "queries through the online micro-batching runtime")
    p.add_argument("--online-rate", type=float, default=100.0,
                   help="offered load for --online, queries/second")
    p.add_argument("--online-duration", type=float, default=8.0,
                   help="Poisson replay length for --online, seconds")
    p.add_argument("--online-ladder", default="8,16,32",
                   help="comma Tq bucket ladder for --online")
    p.add_argument("--online-max-batch", type=int, default=8)
    p.add_argument("--online-max-wait-us", type=int, default=2000)
    p.add_argument("--fleet", type=int, default=0, metavar="N",
                   help="also serve the Poisson replay through a Router "
                        "fronting N replicas (reuses the --online-* knobs)")
    p.add_argument("--fleet-queue-depth", type=int, default=128,
                   help="fleet admission bound: outstanding requests beyond "
                        "this are rejected with a typed Overloaded")
    p.add_argument("--fleet-deadline-ms", type=float, default=None,
                   help="per-request deadline for --fleet; expired requests "
                        "resolve with a typed DeadlineExceeded")
    p.add_argument("--fleet-slo-ms", type=float, default=None,
                   help="attach the SLO controller with this p99 target; "
                        "sustained breach walks SearchParams down the "
                        "pre-warmed rung ladder")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default: the card; raises without one) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    import numpy as np

    from repro_torch.common.device import resolve_device
    from repro_torch.launch import mesh as mesh_mod

    args = parse_args(argv)
    dev = resolve_device(args.device)
    if args.mesh:
        mesh_mod.ensure_devices(int(np.prod(mesh_mod.parse_mesh_spec(args.mesh))))
        mesh_mod.init_serving_group(dev)   # before the build: a rank's card
    try:
        # every rank serves; rank 0 prints
        quiet = mesh_mod.rank() != 0
        with contextlib.redirect_stdout(io.StringIO()) if quiet else contextlib.nullcontext():
            return _main(args, dev)
    finally:
        mesh_mod.release_serving_group()


def _main(args, dev):
    import torch.distributed as tdist

    from repro_torch.anns import registry
    from repro_torch.core import LemurConfig, maxsim
    from repro_torch.data import synthetic
    from repro_torch.launch.mesh import rank
    from repro_torch.retriever import IVFBackendConfig, LemurRetriever

    names = registry.list_backends() if args.backend == "all" else [args.backend]
    for n in names:
        registry.get_backend(n)  # fail fast on typos, before the build

    corpus = synthetic.make_corpus(m=args.m, d=args.d, avg_tokens=16, max_tokens=24,
                                   seed=0)
    cfg = LemurConfig(d=args.d, d_prime=args.d_prime, m_pretrain=1024, n_train=16384,
                      n_ols=4096, epochs=25, k=args.k, k_prime=256,
                      anns=names[0], ivf=IVFBackendConfig(nprobe=32, sq8=True))
    t0 = time.time()
    retriever = LemurRetriever.build(corpus, cfg,
                                     generator=torch.Generator().manual_seed(0),
                                     device=dev, verbose=True)
    print(f"[serve] index built in {time.time()-t0:.1f}s "
          f"({args.m/(time.time()-t0):.0f} docs/s)")
    if args.save_dir:
        # one writer: every rank built the same retriever
        path = retriever.save(args.save_dir) if rank() == 0 else None
        if tdist.is_initialized():
            tdist.barrier()
        retriever = LemurRetriever.load(args.save_dir, device=dev)
        print(f"[serve] persisted + reloaded retriever from {path}")

    toks, tmask = retriever.index.dense_view()
    batches = []
    for b in range(args.n_batches):
        q = torch.as_tensor(synthetic.queries_from_corpus_query(
            corpus, args.batch, 8, seed=100 + b)).to(dev)
        qm = torch.ones(q.shape[:2], dtype=torch.bool, device=dev)
        _, truth = maxsim.true_topk(q, qm, toks, tmask, args.k)
        batches.append((q, qm, truth))
    del toks, tmask

    rows = {"backends": [serve_backend(retriever, name, batches, args,
                                       generator=torch.Generator().manual_seed(1))
                         for name in names]}
    if args.mesh:
        rows["sharded"] = serve_sharded(retriever, args.mesh, batches, args)
    if args.online:
        rows["online"] = serve_online(retriever, args)
    if args.fleet:
        rows["fleet"] = serve_fleet(retriever, args)
    return {"retriever": retriever, "batches": batches, "rows": rows}


if __name__ == "__main__":
    main()

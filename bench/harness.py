"""One run of one cell: set-up, warm-up, the measured window, the traced
sub-window, the comparison with the reference, the result line.

The loop is closed: one batch of ``batch`` queries in flight at a time.  A
batch's queries are drawn on the device from the seed (outside its latency
clock, inside the window), then ``LemurRetriever.search`` runs from submit to
``torch.cuda.synchronize()``.  The window ends with the batch that crosses
``--seconds``.  End-to-end metrics (``--trace 0``): ``qps`` (queries
completed / window seconds), ``p95_ms`` (of every batch's latency),
``peak_mem_gib`` (``max_memory_allocated`` over the window, reset at its
start: the resident index and the working set) and ``setup_s`` (process
start to the window's start: CUDA, kernel build or load, corpus, index,
warm-up).  A traced run (``--trace 1``) records CUDA events around each
search and its rerank entry in the window, then profiles ``PROFILE_S`` more
seconds of the same loop, and reports the per-layer metrics of
``metrics/``.  Both kinds judge the same sample of the window's answers.
"""
from __future__ import annotations

import gc
import random
import sys
import time

import numpy as np
import torch

from bench import compare, counts, peaks, system
from bench.corpus import Corpus, mix
from bench.reference import Reference
from bench.spec import metric_reader
from bench.tracing import RerankTap, profile_loop

PROFILE_S = 1.0
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is JAX's, Flax's or the
    JAX package's (``repro_torch`` is not ``repro``)."""
    return sorted({n for n in list(sys.modules) if n.split(".", 1)[0] in FORBIDDEN})


class Reservoir:
    """A uniform sample of ``k`` of the window's batches, drawn from the
    seed as the batches come (the window's length is not known ahead)."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng = k, random.Random(mix(seed, "sample"))

    def slot(self, n: int):
        if n < self.k:
            return n
        j = self.rng.randrange(n + 1)
        return j if j < self.k else None


class BadRun(RuntimeError):
    pass


def _draw(corpus, i: int, tr: dict, g, side, main):
    """Batch ``i``'s queries, drawn on the ``side`` stream (where there is
    one) and handed to ``main``."""
    if side is None:
        return corpus.queries(i, tr, g)
    with torch.cuda.stream(side):
        q, qm = corpus.queries(i, tr, g)
    q.record_stream(main)
    qm.record_stream(main)
    return q, qm


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: float | None = None) -> dict:
    """One run -> the result line's dict (its ``checks`` last)."""
    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cfg, tr = cell.cfg, cell.traffic
    search, B, k = tr["search"], int(tr["batch"]), int(tr["search"]["k"])

    # -- set-up ---------------------------------------------------------------
    corpus = Corpus(cfg, seed, dev, int(tr["source_docs"]))
    r, params, notes = system.build(corpus, cfg, search)
    t_warm = time.perf_counter()
    g = torch.Generator(device=dev)
    for j in range(int(tr["warmup_batches"])):
        r.search(*corpus.queries(-1 - j, tr, g), params)
    tap = RerankTap(spans=trace and cuda).install()
    system.sync(dev)
    notes["warmup_s"] = time.perf_counter() - t_warm
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    # -- the window -------------------------------------------------------------
    # batch n+1's queries are drawn on a side stream while batch n's search
    # runs, so the draw's host work overlaps the device's; the latency clock
    # waits for the search's stream alone
    main = torch.cuda.current_stream(dev) if cuda else None
    side = torch.cuda.Stream(dev) if cuda else None
    res = Reservoir(int(tr["check_batches"]), seed)
    kept, lat, spans = {}, [], []
    n = 0
    t_first = time.perf_counter()
    t_end = t_first + seconds
    q, qm = _draw(corpus, 0, tr, g, side, main)
    system.sync(dev)
    while True:
        slot = res.slot(n)
        tap.keep, tap.kept, tap.events = slot is not None, None, None
        t0 = time.perf_counter()
        if tap.spans:
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record()
        s, ids = r.search(q, qm, params)
        if tap.spans:
            e3 = torch.cuda.Event(enable_timing=True)
            e3.record()
        q, qm = _draw(corpus, n + 1, tr, g, side, main)
        if cuda:
            main.synchronize()
        t1 = time.perf_counter()
        if cuda:
            side.synchronize()
        lat.append(t1 - t0)
        if tap.spans:
            spans.append((e0, tap.events, e3))
        if slot is not None:
            kept[slot] = (n, s, ids, tap.kept)
        n += 1
        if t1 >= t_end:
            break
    window_s = t1 - t_first
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    tap.keep = False

    prof = None
    if trace and cuda:
        nxt = iter(range(n, n + 10 ** 9))

        def serve(batch):
            r.search(*batch, params)
        prof = profile_loop(lambda: corpus.queries(next(nxt), tr, g), serve, PROFILE_S)
        del serve
    tap.uninstall()

    span_ms = None
    if spans and all(ev is not None for _, ev, _ in spans):
        span_ms = {"first_stage_ms": [a.elapsed_time(ev[0]) for a, ev, _ in spans],
                   "rerank_ms": [ev[0].elapsed_time(ev[1]) for _, ev, _ in spans],
                   "search_ms": [a.elapsed_time(b) for a, _, b in spans]}
    sample = sorted(kept.values(), key=lambda x: x[0])
    captured = all(c is not None for *_, c in sample)
    del r, params, spans, s, ids, q, qm
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # -- the reference --------------------------------------------------------------
    t_ref = time.perf_counter()
    ref = Reference(corpus, cfg).build()
    qs = [corpus.queries(b, tr, g) for b, *_ in sample]
    q_all = torch.cat([x[0] for x in qs])
    qm_all = torch.cat([x[1] for x in qs])
    cand_ref, probes = ref.search_first_stage(q_all, qm_all, int(search["nprobe"]),
                                              int(search["k_prime"]))
    if not captured:
        raise BadRun("the timed search did not call its rerank entry (ops."
                     "fused_rerank_paged or fused_rerank_paged_res): the harness cannot "
                     "see its candidates")
    misfit, parts = 0, {"cand": [], "ids": [], "scores": []}
    for _, s_b, i_b, c_b in sample:
        for key, t, cols, fill in (("cand", c_b, int(search["k_prime"]), -1),
                                   ("ids", i_b, k, -1), ("scores", s_b, k, 0.0)):
            t, bad = compare.fit(t, B, cols, fill)
            parts[key].append(t)
            misfit += bad
    values = compare.numbers(ref, q_all, qm_all, cand_ref, torch.cat(parts["cand"]),
                             torch.cat(parts["ids"]), torch.cat(parts["scores"]), k, misfit)
    correct = compare.verdict(values, cell.limits)
    ref_s = time.perf_counter() - t_ref

    # -- the result -----------------------------------------------------------------
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
                   "count": int(cell.chips),
                   "memory_peak_bytes": int(max(setup_peak, window_peak))}
    metrics = {}
    out = {"correct": bool(correct), "attempted": n * B, "failed": 0}
    if not trace:
        lat_ms = np.asarray(lat) * 1e3
        e2e = {"qps": n * B / window_s, "p95_ms": float(np.percentile(lat_ms, 95)),
               "peak_mem_gib": window_peak / 2 ** 30, "setup_s": t_first - t_start}
        for mt in cell.end_to_end:
            if mt["name"] in e2e:
                metrics[mt["name"]] = {"value": e2e[mt["name"]], "unit": mt["unit"]}
    else:
        per_batch = []
        for j, (b, *_) in enumerate(sample):
            sl = slice(j * B, (j + 1) * B)
            per_batch.append({"batch": b,
                              "first_stage": counts.first_stage(cfg, ref.ivf.counts,
                                                                probes[sl], qm_all[sl]),
                              "rerank": counts.rerank(cfg, corpus.counts, cand_ref[sl],
                                                      qm_all[sl], k)})
        ctx = {"spans": span_ms, "sample": per_batch, "peaks": peaks, "profile": prof,
               "window": {"batches": n, "window_s": window_s, "batch": B}}
        for mt in cell.per_layer:
            v = metric_reader(mt["name"])(ctx)
            if v is not None:
                metrics[mt["name"]] = {"value": v, "unit": mt["unit"]}
        if prof and prof["busy_s"]:
            device_info.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
            out["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    out["metrics"] = metrics
    out["device"] = device_info
    if "breakdown" in out:
        out["breakdown"] = out.pop("breakdown")
    out["checks"] = {name: {"value": values[name], "limit": cell.limits[name]}
                     for name in compare.NAMES}
    lat_ms = np.asarray(lat) * 1e3
    out["notes"] = dict(notes, batches=n, window_s=window_s, reference_s=ref_s,
                        sampled_queries=int(q_all.shape[0]),
                        p50_ms=float(np.median(lat_ms)), mean_ms=float(lat_ms.mean()),
                        max_ms=float(lat_ms.max()))
    out["checks"] = out.pop("checks")
    return out

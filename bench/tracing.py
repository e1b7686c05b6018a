"""The benchmark's own spans and its reading of the profiler's trace.

:class:`RerankTap` wraps the rerank entry that ``search_pipeline`` calls
(``repro_torch.kernels.ops.fused_rerank_paged`` and ``..._res``), from this
process and without a change to the program: it keeps the candidates the timed search handed the rerank when asked (the comparison
judges them), and on traced runs records CUDA events around the call.  With
an event before ``search`` and one after it, a search splits into the first
stage (search start to the rerank entry) and the rerank.

:func:`profile_loop` runs the same closed loop under ``torch.profiler`` and
reads what the device did: busy time (the union of its operations'
intervals), the traced window, launches, the operations that took most time
and the host's activity in the device's idle gaps (``idle_gaps``: a frozen
copy of ``chip_smoke.idle_gaps``).
"""
from __future__ import annotations

import bisect
import time

import torch

RERANK_ENTRIES = ("fused_rerank_paged", "fused_rerank_paged_res")


class RerankTap:
    def __init__(self, spans: bool):
        self.spans = spans
        self.keep = False
        self.kept = None
        self.events = None          # (start, end) of the last call, traced runs
        self._ops = None
        self._orig = {}

    def install(self) -> "RerankTap":
        from repro_torch.kernels import ops

        self._ops = ops
        for name in RERANK_ENTRIES:
            fn = getattr(ops, name)
            self._orig[name] = fn
            setattr(ops, name, self._wrap(fn))
        return self

    def uninstall(self) -> None:
        for name, fn in self._orig.items():
            setattr(self._ops, name, fn)
        self._orig.clear()

    def _wrap(self, fn):
        def tapped(q, q_mask, cand, *rest):
            if self.keep:
                self.kept = cand
            if not self.spans:
                return fn(q, q_mask, cand, *rest)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(q, q_mask, cand, *rest)
            e1.record()
            self.events = (e0, e1)
            return out
        return tapped


def _device(e) -> bool:
    """A device operation (not the device-side copy of a user range)."""
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("bench::"))


def profile_loop(draw, search, seconds: float) -> dict:
    """Run the closed loop for ``seconds`` under torch.profiler: ``draw()``
    makes a batch (synchronised), ``search(batch)`` serves it (synchronised)
    inside a ``bench::search`` range.  -> {busy_s, window_s (the whole
    traced loop), batches, launches (device operations that start inside
    the searches, copies not counted), search_busy_s and search_s (the
    device's busy time inside the searches, their length), device_ops,
    idle_gaps (inside the searches)}; busy_s None where the trace holds no
    device operation."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    n = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_end = time.perf_counter() + seconds
        while True:
            batch = draw()
            torch.cuda.synchronize()
            with record_function("bench::search"):
                search(batch)
                torch.cuda.synchronize()
            n += 1
            if time.perf_counter() >= t_end:
                break
    events = prof.events()
    dev = sorted((e.time_range.start, e.time_range.end) for e in events if _device(e))
    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    ranges = sorted((e.time_range.start, e.time_range.end) for e in cpu
                    if e.name == "bench::search")
    out = {"batches": n, "busy_s": None, "window_s": None, "launches": 0,
           "search_busy_s": None, "search_s": None, "device_ops": [], "idle_gaps": []}
    if not dev or not cpu or not ranges:
        return out
    t0 = min(e.time_range.start for e in cpu)
    t1 = max(max(b for _, b in dev), max(e.time_range.end for e in cpu))
    starts = [a for a, _ in ranges]

    def inside(t):
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= ranges[i][1]

    def union(iv):
        total, ca, cb = 0.0, None, None
        for a, b in iv:
            if cb is None or a > cb:
                if cb is not None:
                    total += cb - ca
                ca, cb = a, b
            else:
                cb = max(cb, b)
        return total + (cb - ca if cb is not None else 0.0)

    clipped = []
    for ra, rb in ranges:
        clipped += [(max(a, ra), min(b, rb)) for a, b in dev if a < rb and b > ra]
    rows = {}
    launches = 0
    for e in events:
        if _device(e) and inside(e.time_range.start):
            rows[e.name] = rows.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e6
            launches += not e.name.startswith("Memcpy")
    out.update(busy_s=union(dev) / 1e6, window_s=(t1 - t0) / 1e6, launches=launches,
               search_busy_s=union(sorted(clipped)) / 1e6,
               search_s=sum(b - a for a, b in ranges) / 1e6)
    out["device_ops"] = [[k[:120], v] for k, v in sorted(rows.items(), key=lambda x: -x[1])[:10]]
    out["idle_gaps"] = idle_gaps(events, ranges)[:10]
    return out


def idle_gaps(events, ranges) -> list:
    """The device's idle gaps inside the searches (``ranges``) and the host
    activity in them: [name, seconds] of each top-level host op and each
    CUDA runtime call that overlaps a gap, largest first."""
    dev = sorted((e.time_range.start, e.time_range.end) for e in events if _device(e))
    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    gaps = []
    for ra, rb in ranges:
        t = ra
        for a, b in dev:
            if b <= t or a >= rb:
                continue
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if t < rb:
            gaps.append((t, rb))
    ends = [b for _, b in gaps]

    def overlap(e):
        t0, t1 = e.time_range.start, e.time_range.end
        o, i = 0.0, bisect.bisect_right(ends, t0)
        while i < len(gaps) and gaps[i][0] < t1:
            a, b = gaps[i]
            o += max(0.0, min(b, t1) - max(a, t0))
            i += 1
        return o

    acc = {}
    for e in cpu:
        if e.name == "bench::search" or not (e.name.startswith("cuda")
                                             or e.cpu_parent is None
                                             or e.cpu_parent.name == "bench::search"):
            continue
        o = overlap(e)
        if o > 0:
            name = e.name[:120]
            acc[name] = acc.get(name, 0.0) + o / 1e6
    return [[k, v] for k, v in sorted(acc.items(), key=lambda x: -x[1])]

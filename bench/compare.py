"""The comparison that decides ``correct``.

On a sample of the window's batches (drawn from the seed, reservoir-style,
among all the batches the window finished) the program's outputs are held
against the plain reference (``reference.py``), which works everything out
again from the inputs:

``bad_ids``
    ids that no answer may hold: tombstoned, out of range, or twice in one
    row, among the served ids and the first stage's candidates (the
    candidates the timed search handed its rerank), and answers of the
    wrong shape; exact, limit 0.
``cand_miss``
    the first stage: the share of the reference's top-k' candidates (its own
    psi-pool, probes, scan and top-k') missing from the program's.  Near
    ties at the probe and k' boundaries move a few; a wrong pool, probe,
    scan, selection or build moves many.
``score_err``
    the rerank's scores: the largest gap between a served score and the
    reference's exact MaxSim of the served id, over ``max(1, |MaxSim|)``.
``topk_gap``
    the rerank's selection: over the program's own candidates, the
    reference's j-th best MaxSim less the reference's MaxSim of the j-th
    served id, over ``max(1, |best MaxSim of the row|)``; largest over rows
    and ranks.  A missing, extra, duplicated or misplaced answer reads large.
"""
from __future__ import annotations

import torch

from bench.reference import NEG, stable_topk

NAMES = ("bad_ids", "cand_miss", "score_err", "topk_gap")


def fit(t: torch.Tensor, rows: int, cols: int, fill) -> tuple[torch.Tensor, int]:
    """``t`` cut or padded (with ``fill``) to (rows, cols) -> (tensor, the
    entries that were missing or extra): an answer of the wrong shape."""
    t = t.reshape(t.shape[0], -1) if t.dim() else t.reshape(1, 1)
    out = torch.full((rows, cols), fill, dtype=t.dtype, device=t.device)
    r, c = min(rows, t.shape[0]), min(cols, t.shape[1])
    out[:r, :c] = t[:r, :c]
    return out, rows * cols + t.shape[0] * t.shape[1] - 2 * r * c


def numbers(ref, q, qm, cand_ref, cand_p, ids_p, scores_p, k: int, misfit: int = 0) -> dict:
    """``q`` (N, Tq, d), ``qm`` (N, Tq): the sampled queries; ``cand_ref``
    (N, k') the reference's candidates; ``cand_p`` (N, k'), ``ids_p`` and
    ``scores_p`` (N, k): the program's candidates and served answer;
    ``misfit`` entries of them were of the wrong shape (``fit``)."""
    N = q.shape[0]
    m = ref.corpus.m
    alive = ref.corpus.alive
    cand_p, ids_p = cand_p.long(), ids_p.long()
    # every (row, doc) pair to score, each once
    allp = torch.cat([cand_ref, cand_p, ids_p], 1)
    rows = torch.arange(N, device=q.device)[:, None].expand_as(allp)
    valid = (allp >= 0) & (allp < m)
    key = torch.where(valid, rows * m + allp, -1)
    uk, inv = torch.unique(key, return_inverse=True)
    real = uk >= 0
    sc = torch.full(uk.shape, NEG, device=q.device)
    sc[real] = ref.pair_scores(q, qm, uk[real] // m, uk[real] % m)
    ms = sc[inv]
    kr, kp = cand_ref.shape[1], cand_p.shape[1]
    ms_cp, ms_served = ms[:, kr:kr + kp], ms[:, kr + kp:]

    def bad(ids):
        dead = (ids >= 0) & (ids < m) & ~alive[ids.clamp(0, m - 1)]
        srt = ids.sort(1).values
        twice = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
        return int(dead.sum()) + int((ids >= m).sum()) + int(twice.sum())

    ref_ok = cand_ref >= 0
    in_p = torch.isin(torch.where(ref_ok, rows[:, :kr] * m + cand_ref, -1),
                      torch.where(cand_p >= 0, rows[:, :kp] * m + cand_p, -2))
    n_ref = int(ref_ok.sum())
    served = (ids_p >= 0) & (ids_p < m)
    err = (scores_p.float() - ms_served).abs() / ms_served.abs().clamp_min(1.0)
    score_err = float(err[served].max()) if bool(served.any()) else 0.0
    best = stable_topk(torch.where(cand_p >= 0, ms_cp, NEG), k)[0]
    if best.shape[1] < k:
        best = torch.cat([best, best.new_full((N, k - best.shape[1]), NEG)], 1)
    gap = (best - ms_served) / best[:, :1].abs().clamp_min(1.0)
    gap = torch.where((best <= NEG / 2) & (ms_served <= NEG / 2), 0.0, gap)
    return {"bad_ids": bad(ids_p) + bad(cand_p) + misfit,
            "cand_miss": float((ref_ok & ~in_p).sum()) / max(1, n_ref),
            "score_err": score_err,
            "topk_gap": float(gap.max())}


def verdict(values: dict, limits: dict) -> bool:
    """Every number within its limit (a number that is not finite fails)."""
    for name in NAMES:
        v = values[name]
        if not (v == v and v <= limits[name]):       # NaN fails
            return False
    return True

"""A whole run (set-up, window, comparison) on the CPU at a tiny size, past
the harness' look for a card: sound, it is correct; with the timed path
broken underneath it, ``correct`` comes out false, once for each fault a
search can have.  (A search keeps no state a step could leave unchanged, and
one chip exchanges nothing, so those two faults do not apply.)"""
import pytest
import torch

from bench import harness


def run(cell):
    return harness.run_cell(cell, 2 ** 31 + 77, 0.2, False, "cpu")


@pytest.mark.parametrize("residual", [False, True])
def test_sound_run_is_correct(tiny_cell, residual):
    out = run(tiny_cell(residual))
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert {"qps", "p95_ms", "peak_mem_gib", "setup_s"} == set(out["metrics"])
    assert out["attempted"] > 0 and out["failed"] == 0


def _answer_altered(monkeypatch):
    """One answer of every batch replaced where the rerank produces it."""
    from repro_torch.kernels import ops

    orig = ops._rerank_topk

    def altered(s, cand, k):
        top, ids = orig(s, cand, k)
        ids = ids.clone()
        ids[0, 0] = (ids[0, 0] + 1) % 3000
        return top, ids
    monkeypatch.setattr(ops, "_rerank_topk", altered)


def _half_batch(monkeypatch):
    """Only the first half of each batch searched; its answers stand in
    for the rest."""
    from repro_torch.retriever import facade

    orig = facade.search_pipeline

    def half(index, q, qm, params):
        h = q.shape[0] // 2
        s, ids = orig(index, q[:h], qm[:h], params)
        return torch.cat([s, s]), torch.cat([ids, ids])
    monkeypatch.setattr(facade, "search_pipeline", half)


def _tombstones_ignored(monkeypatch):
    from repro_torch.core import pages

    monkeypatch.setattr(pages, "mask_dead", lambda store, cand: cand)


def _first_stage_one_probe(monkeypatch):
    from repro_torch.anns import ivf

    orig = ivf.search_ivf
    monkeypatch.setattr(ivf, "search_ivf", lambda index, q, nprobe, k, **kw:
                        orig(index, q, 1, k, **kw))


def _rerank_scores_off(monkeypatch):
    """The rerank's scores off by one part in 10,000 (about TF32's error)."""
    from repro_torch.kernels import gather_scan

    orig = gather_scan.rerank_paged_scores
    monkeypatch.setattr(gather_scan, "rerank_paged_scores",
                        lambda *a: orig(*a) * (1 + 1e-4))


@pytest.mark.parametrize("fault, caught_by", [
    (_answer_altered, ("score_err", "bad_ids")),
    (_half_batch, ("topk_gap", "score_err", "cand_miss")),
    (_tombstones_ignored, ("bad_ids",)),
    (_first_stage_one_probe, ("cand_miss",)),
    (_rerank_scores_off, ("score_err",)),
])
def test_broken_timed_path_is_not_correct(tiny_cell, monkeypatch, fault, caught_by):
    fault(monkeypatch)
    out = run(tiny_cell())
    assert not out["correct"]
    over = {k for k, c in out["checks"].items() if c["value"] > c["limit"]}
    assert over & set(caught_by), out["checks"]

"""The byte and operation counts on shapes small enough to count by hand."""
import torch

from bench import counts, peaks

SQ8 = {"d": 4, "d_prime": 8, "ivf": {"residual_bits": 0, "sq8": True},
       "residual": {"enabled": False, "bits": 4}}
RES = {"d": 4, "d_prime": 8, "ivf": {"residual_bits": 4, "sq8": False},
       "residual": {"enabled": True, "bits": 4}}


def test_row_and_token_bytes():
    assert counts.row_bytes(SQ8) == 8 + 4 + 4
    assert counts.row_bytes(RES) == 8 * 4 // 8 + 4
    fp32 = {**SQ8, "ivf": {"residual_bits": 0, "sq8": False}}
    assert counts.row_bytes(fp32) == 4 * 8 + 4
    assert counts.token_bytes(SQ8) == 16
    assert counts.token_bytes(RES) == 4 + 2


def test_first_stage_counts_each_probed_list_once():
    lists = torch.tensor([3, 5, 0, 7])                   # rows a list
    probes = torch.tensor([[0, 1], [1, 3]])              # list 1 probed twice
    qm = torch.tensor([[True, True, False], [True, False, False]])
    nbytes, ops = counts.first_stage(SQ8, lists, probes, qm)
    distinct_rows = 3 + 5 + 7
    want_bytes = (distinct_rows * 16 + 4 * 8 * 4 + (4 * 8 + 3 * 8) * 4 + 2 * 3 * 4 * 4 + 2 * 3)
    assert nbytes == want_bytes
    scanned = (3 + 5) + (5 + 7)
    assert ops == 2 * 3 * 4 * 8 + 2 * 2 * 4 * 8 + 2 * scanned * 8


def test_rerank_counts_distinct_candidates_once_and_every_pair():
    doc_counts = torch.tensor([2, 3, 5, 7])
    cand = torch.tensor([[0, 1, -1], [1, 3, 2]])
    qm = torch.tensor([[True, False], [True, True]])
    nbytes, ops = counts.rerank(SQ8, doc_counts, cand, qm, k=2)
    assert nbytes == (2 + 3 + 5 + 7) * 16 + 2 * 2 * 4 * 4 + 4 + 6 * 4 + 2 * 2 * 8
    assert ops == 2 * 4 * ((2 + 3) * 1 + (3 + 7 + 5) * 2)


def test_bound_is_the_larger_side():
    assert peaks.bound_s(3.35e12, 0) == 1.0
    assert peaks.bound_s(0, 495e12) == 1.0
    assert peaks.bound_s(3.35e12, 2 * 495e12) == 2.0

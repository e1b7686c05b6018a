"""The control: the reference in the program's place, its products in TF32,
must come out not correct under the cells' limits (here at a tiny size on
the CPU; on the card at the cells' sizes: ``python3 bench/control.py``)."""
import json
import pathlib

import pytest
import torch

from bench import compare, control

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("residual", [False, True])
def test_tf32_control_fails_every_cells_limits(tiny_cell, residual):
    cell = tiny_cell(residual)
    for seed in (1, 2, 3):
        v = control.control_numbers(cell, seed, "cpu")
        for name in CELLS:
            limits = json.loads((ROOT / "bench" / "limits" / f"{name}.json").read_text())
            assert not compare.verdict(v, limits), (name, seed, v)


def test_fp32_reference_in_the_programs_place_passes(tiny_cell):
    """The same path with the fp32 reference as the 'program' reads zero."""
    from bench.corpus import Corpus
    from bench.reference import Reference

    cell = tiny_cell()
    c = Corpus(cell.cfg, 4, "cpu", 64)
    ref = Reference(c, cell.cfg).build(fill_pool=True)
    q, qm = c.queries(0, cell.traffic, torch.Generator())
    cand, _ = ref.search_first_stage(q, qm, 8, 64)
    scores, ids = ref.serve(q, qm, cand, 10)
    v = compare.numbers(ref, q, qm, cand, cand, ids, scores, 10)
    assert v == {"bad_ids": 0, "cand_miss": 0.0, "score_err": 0.0, "topk_gap": 0.0}


@pytest.mark.chip
def test_control_fails_at_a_cells_size_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from bench import spec

    cell = spec.cell("msmarco-sq8-np64-k100", ROOT / "BENCHMARK.json")
    v = control.control_numbers(cell, 2 ** 31 + 5, "cuda")
    assert not compare.verdict(v, cell.limits), v

"""Tests of the benchmark itself (``test_bench_*.py``), on the CPU at tiny
sizes; a test that needs the card carries the ``chip`` marker and skips
inside the test where there is none."""
import json
import pathlib
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parent
for p in (str(HERE.parent), str(HERE.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips without one "
        "(run on the card: python -m pytest -m chip bench/)")


def tiny(residual: bool = False, traffic: str = "rerank_heavy"):
    """A cell of the benchmark's configurations at a size the CPU runs in a
    second: 3,000 docs of at most 12 tokens, d 16, d' 64, batches of 16
    queries of 8 tokens, the limits of the cell it shrinks.  The IVF keeps
    the program's own k-means sample and iterations."""
    from bench import spec

    name = "lemur-msmarco-res4" if residual else "lemur-msmarco-sq8"
    cell = ("msmarco-res4-" if residual else "msmarco-sq8-") + (
        "k1024" if traffic == "rerank_heavy" else "np64-k100")
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    cfg.update(m=3000, d=16, d_prime=64, doc_tokens_mean=8, doc_tokens_min=2,
               doc_tokens_max=12, topic_centers=24, doc_chunk=1000, delete_share=0.01)
    cfg["residual"].update(ncent=16, train_sample=512)
    tr = json.loads((HERE / "traffic" / f"{traffic}.json").read_text())
    tr.update(batch=16, q_tokens=8, short_min=2, source_docs=64, check_batches=4,
              warmup_batches=1)
    tr["search"].update(k=10, k_prime=64, nprobe=8)
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    limits = json.loads((HERE / "limits" / f"{cell}.json").read_text())
    return spec.Cell("tiny", 1, cfg, tr, limits, bench["end_to_end"], bench["per_layer"])


@pytest.fixture
def tiny_cell():
    return tiny

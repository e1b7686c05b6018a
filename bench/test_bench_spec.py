"""``BENCHMARK.json`` against the benchmark's contract, and every part of
every cell found by its name."""
import json
import math
import pathlib
import re

import pytest

from bench import spec

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/")
        assert ".." not in p.split("/") and (ROOT / p).is_dir()
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells: 2 + 14 x 24 runs of run_seconds + 60 s, 2 x 90 s
    # of compiling a cell, 1,200 s spare
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.fullmatch(e["name"]), e["name"]
            names.append((group, e["name"]))
            if "unit" in e:
                assert UNIT.fullmatch(e["unit"]), e["unit"]
    for group in ("configs", "workloads"):
        got = [e["name"] for e in BENCH[group]]
        assert len(got) == len(set(got))
    metrics = [e["name"] for e in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.fullmatch(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        for text in (c["source"], c["why"]):
            assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_cells_and_metrics():
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.fullmatch(w["traffic"]) and 1 <= len(w["why"]) <= 200
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(BENCH["workloads"])
    assert {w["config"] for w in BENCH["workloads"]} == configs
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert {"qps", "p95_ms", "peak_mem_gib", "setup_s"} <= e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["better"] in ("lower", "higher") and m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in SOURCES and m["better"] in ("lower", "higher")
        assert 1 <= len(m["layer"]) <= 200 and set(m["workloads"]) <= set(CELLS)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert any("mfu" in m["name"] for m in BENCH["per_layer"])


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_parts(cell):
    c = spec.cell(cell, ROOT / "BENCHMARK.json")
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert c.cfg["name"] == entry["config"]
    assert c.traffic["search"]["backend"] == "ivf"
    assert set(c.limits) == {"bad_ids", "cand_miss", "score_err", "topk_gap"}
    assert c.limits["bad_ids"] == 0
    assert {m["name"] for m in c.end_to_end} == {"qps", "p95_ms", "peak_mem_gib", "setup_s"}
    assert c.per_layer
    for m in c.per_layer:
        assert callable(spec.metric_reader(m["name"]))
    cfg = c.cfg
    assert cfg["m"] % cfg["doc_chunk"] == 0
    for key, why in cfg["reduced"].items():
        assert key in cfg and why
    assert sorted(cfg["reduced"]) == sorted(
        next(x for x in BENCH["configs"] if x["name"] == cfg["name"])["reduced"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_readers_return_nothing_without_a_trace(metric):
    """A reader with nothing to read gives None, never 0."""
    from bench import peaks

    ctx = {"spans": None, "sample": [], "peaks": peaks, "profile": None,
           "window": {"batches": 0, "window_s": 1.0, "batch": 256}}
    assert spec.metric_reader(metric)(ctx) is None


def test_shares_read_from_a_trace():
    from bench import peaks

    ctx = {"spans": {"first_stage_ms": [2.0, 4.0], "rerank_ms": [1.0, 3.0],
                     "search_ms": [3.5, 7.5]},
           "sample": [{"batch": 1, "first_stage": (3.35e9, 0), "rerank": (0, 495e9)}],
           "peaks": peaks,
           "profile": {"busy_s": 0.9, "window_s": 1.0, "search_busy_s": 0.8,
                       "search_s": 1.0, "launches": 30, "batches": 10},
           "window": {"batches": 100, "window_s": 2.0, "batch": 256}}
    read = {m["name"]: spec.metric_reader(m["name"])(ctx) for m in BENCH["per_layer"]}
    assert read["first_stage_ms"] == 3.0 and read["rerank_ms"] == 2.0
    assert math.isclose(read["first_stage_roofline"], 25.0)      # 1 ms bound / 4 ms
    assert math.isclose(read["rerank_roofline"], 100 / 3)         # 1 ms bound / 3 ms
    assert math.isclose(read["search_mfu"], 100 * 495e9 * 100 / 2.0 / 495e12)
    assert math.isclose(read["device_idle_share"], 20.0)
    assert read["launches_per_batch"] == 3.0

"""Finding a cell's parts by name.

``BENCHMARK.json`` names each cell's configuration and traffic; the rest is
data under this folder: the configuration's file (``configs``' ``file``),
the traffic mix ``traffic/<traffic>.json`` (its loop, batch, query shape,
source docs and the search semantics a request carries: backend, k, k',
nprobe), the limits of the comparison ``limits/<cell>.json`` and a reader
``metrics/<metric>.py`` for each per-layer metric.  A cell, a traffic mix,
a configuration or a metric is added by adding files and entries.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str, bench_file=ROOT / "BENCHMARK.json") -> Cell:
    bench = load_json(bench_file)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_file}; known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}

    def applies(metric):
        return "workloads" not in metric or name in metric["workloads"]

    return Cell(
        name=name, chips=int(w["chips"]),
        cfg=load_json(ROOT / configs[w["config"]]["file"]),
        traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(HERE / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)])


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read(ctx)``: the metric's value, or None
    where the run holds nothing to read."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read

"""What the benchmark loads: never JAX or the JAX package (top-level names
compared whole: ``repro_torch`` is not ``repro``), and the reference not
even the program."""
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, json, sys
sys.path[:0] = [{root!r}, {src!r}]
for name in {mods!r}:
    globals()[name.rsplit(".", 1)[-1]] = importlib.import_module(name)
{run}
print(json.dumps(sorted({{n.split(".", 1)[0] for n in sys.modules}})))
"""


def loaded(mods, run=""):
    code = PROBE.format(root=str(ROOT), src=str(ROOT / "src"), mods=mods, run=run)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    return set(json.loads(out.splitlines()[-1]))


def test_harness_loads_no_jax_and_no_jax_package():
    tops = loaded(["bench.harness", "bench.control", "bench.spec", "bench.tracing",
                   "bench.system"])
    assert not tops & {"jax", "jaxlib", "flax", "repro"}, tops


def test_reference_loads_nothing_of_the_program():
    tops = loaded(["bench.reference", "bench.compare", "bench.counts", "bench.corpus"])
    assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}, tops


def test_a_run_on_the_cpu_loads_no_jax():
    """A whole tiny run in a process of its own loads the program, and still
    neither JAX nor the JAX package."""
    tops = loaded(["bench.conftest", "bench.harness"],
                  run="harness.run_cell(conftest.tiny(), 5, 0.2, False, 'cpu')")
    assert "repro_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}, tops


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    from bench import harness

    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxlike.sub", sys)
    assert "repro_torch_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro.core" in harness.forbidden_modules()


def test_no_file_of_the_benchmark_reads_the_jax_benchmarks():
    for p in ROOT.joinpath("bench").rglob("*.py"):
        if p.name == pathlib.Path(__file__).name:
            continue
        text = p.read_text()
        assert "benchmarks/" not in text.replace("bench/", ""), p
        assert "import jax" not in text and "from repro " not in text and "from repro." not in text

"""Run one cell of ``BENCHMARK.json`` once.

    python3 bench/run.py --workload msmarco-sq8-k1024 --seed 1 --seconds 10 --trace 0

Prints the numbers the comparison holds against their limits as the last
lines of standard error, and one JSON line as the last line of standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and ``checks`` last.  Exits
non-zero, printing no result, without a CUDA card (or fewer than the cell
asks for), when the program cannot be imported, or when JAX or the JAX
package is loaded once the window has closed.  Kernel builds stay in the
checkout (``build/``).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(var, str(ROOT / "build" / sub))
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench import harness, spec

    cell = spec.cell(args.workload, ROOT / "BENCHMARK.json")
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"bench: needs {cell.chips} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, {torch.cuda.device_count() if torch.cuda.is_available() else 0} "
              "found", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401  (the system under test)
    except ImportError as e:
        print(f"bench: the program (src/repro_torch) cannot be imported: {e}", file=sys.stderr)
        return 2
    try:
        out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    except Exception:
        traceback.print_exc()
        return 1
    found = harness.forbidden_modules()      # the window has closed
    if found:
        print(f"bench: JAX or the JAX package is loaded: {found}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        harness.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    harness.log(f"correct {out['correct']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

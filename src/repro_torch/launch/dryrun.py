"""Dry run of the production mesh: one rank's step of every (arch x shape)
cell, traced without real data, with its memory, cost and collective
statistics (twin of ``repro/launch/dryrun.py``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh multi

JAX lowers and compiles each cell on 256 or 512 forced host devices.  The
twin is one rank of the production mesh (rank 0 of a 256- or 512-rank
process group on torch's ``fake`` backend, whose collectives move
nothing): :func:`run_cell` builds the cell (``configs.registry.build_cell``),
makes the rank's blocks of its arguments on the ``meta`` device (shapes and
dtypes only, nothing allocated; ``FakeTensorMode`` does the same at four
times the host time a step, since it wraps every operation) and runs the
step once under the step cost analysis (``launch/hlo_analysis.py``),
``FlopCounterMode`` (the twin of XLA's ``cost_analysis``, kept as a
cross-check) and ``MemTracker``.

Its record has JAX's keys that ``launch/roofline.py`` reads: ``flops``
(``FlopCounterMode``), ``flops_loop_corrected``, ``bytes_loop_corrected``
and ``collectives_loop_corrected`` (the cost analysis: eager mode
dispatches every loop iteration, so nothing needs correcting; the bytes are
the unfused eager traffic), and ``memory``: ``argument_bytes`` (the rank's
blocks of the arguments), ``output_bytes``, ``alias_bytes`` (the donated
arguments), ``peak_bytes`` (``MemTracker``'s peak, arguments included) and
``temp_bytes`` (the peak above the arguments).  ``compile_s`` and
``generated_code_bytes`` have no meaning in eager mode and are not written;
``run_s`` is the trace's wall time on the host.  The kernels dispatch by
device (a meta tensor takes their CUDA path), so the LEMUR cells, whose
steps reach them, run on fake CPU tensors under ``FakeTensorMode``, which
take the plain versions: the right operations for counting.

Results are merged into results/dryrun_<mesh>.json (a cell's record
replaces its earlier one), which ``launch/roofline.py`` reads.  Importing
this module opens no process group and touches no device: :func:`main`
(or the caller, with :func:`fake_group`) makes the group and destroys it.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.common.pytree import tree_leaves, tree_map
from repro_torch.dist.sharding import P, axis_sizes, local_shape


def _fake_store():
    """The store of torch's ``fake`` process-group backend (a testing
    module of torch: its one use here)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    return FakeStore()


@contextlib.contextmanager
def fake_group(world_size: int, rank: int = 0):
    """A ``fake`` process group of ``world_size`` ranks in this process, as
    rank ``rank``; destroyed on exit."""
    dist.init_process_group("fake", store=_fake_store(), rank=rank, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _is_spec(x) -> bool:
    return isinstance(x, P)


def _fill(t: torch.Tensor) -> torch.Tensor:
    """Stand-in values for a real run: zeros for integers (a valid id
    everywhere), True for masks, small normals for floats."""
    if t.dtype == torch.bool:
        return t.fill_(True)
    if t.dtype.is_floating_point:
        return t.normal_(0.0, 0.02)
    return t.zero_()


def local_args(cell, mesh, device="cpu", *, fill: bool = False) -> tuple:
    """This rank's blocks of the cell's arguments, as empty tensors of
    ``local_shape`` on ``device`` (``meta``: shapes only); with ``fill``,
    stand-in values (:func:`_fill`)."""
    def one(spec, x):
        t = torch.empty(local_shape(tuple(x.shape), spec, mesh), dtype=x.dtype, device=device)
        return _fill(t) if fill else t

    return tuple(tree_map(one, spec, arg, is_leaf=_is_spec)
                 for spec, arg in zip(cell.in_shardings, cell.args))


def tree_nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def run_cell(arch: str, shape: str, mesh) -> dict:
    """One rank's step of the cell on ``meta`` tensors (the LEMUR cells on
    fake CPU tensors) -> its record (see the module docstring).  ``mesh`` is
    a DeviceMesh over a live (``fake``) process group."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.registry import build_cell
    from repro_torch.launch.hlo_analysis import CostAnalysis

    t0 = time.time()
    cell = build_cell(arch, shape, mesh)
    # the LEMUR steps reach the kernels, which dispatch by device: fake CPU
    # tensors take their plain versions
    fake = FakeTensorMode() if cell.kind.startswith("lemur") else contextlib.nullcontext()
    with fake:
        args = local_args(cell, mesh, "cpu" if cell.kind.startswith("lemur") else "meta")
        arg_bytes = tree_nbytes(args)
        alias_bytes = sum(tree_nbytes(args[i]) for i in cell.donate_argnums)
        mt = MemTracker()
        mt.track_external(*[t for t in tree_leaves(args) if isinstance(t, torch.Tensor)])
        with mt, FlopCounterMode(display=False) as fc, CostAnalysis() as ca:
            out = cell.fn(*args)
        peak = sum(v["Total"] for v in mt.get_tracker_snapshot("peak").values())
        out_bytes = tree_nbytes(out)
    cost = ca.result()
    coll = {"bytes": cost["collective_bytes"], "count": cost["collective_count"],
            "total_bytes": cost["total_collective_bytes"]}
    return {
        "arch": arch,
        "shape": shape,
        "kind": cell.kind,
        "mesh": axis_sizes(mesh),
        "run_s": round(time.time() - t0, 2),
        "flops": float(fc.get_total_flops()),
        "flops_loop_corrected": cost["flops"],
        "bytes_loop_corrected": cost["bytes"],
        "collectives_loop_corrected": coll,
        "memory": {
            "argument_bytes": int(arg_bytes),
            "output_bytes": int(out_bytes),
            "temp_bytes": int(max(0, peak - arg_bytes)),
            "alias_bytes": int(alias_bytes),
            "peak_bytes": int(peak),
        },
        "collectives": coll,
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None)
    p.add_argument("--all", action="store_true")
    p.add_argument("--mesh", choices=["single", "multi"], default="single")
    p.add_argument("--out", default="results")
    p.add_argument("--continue-on-error", action="store_true")
    args = p.parse_args(argv)

    from repro_torch.configs.registry import all_cells
    from repro_torch.launch.mesh import make_production_mesh

    if args.all:
        todo = all_cells()
    else:
        if not args.arch or not args.shape:
            p.error("--arch and --shape required unless --all")
        todo = [(args.arch, args.shape)]
    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    outfile = outdir / f"dryrun_{args.mesh}.json"
    existing = {}
    if outfile.exists():
        for r in json.loads(outfile.read_text()):
            existing[(r["arch"], r["shape"])] = r

    multi = args.mesh == "multi"
    failures = []
    with fake_group(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
        for arch, shape in todo:
            key = f"{arch} × {shape} [{args.mesh}]"
            try:
                rec = run_cell(arch, shape, mesh)
                existing[(arch, shape)] = rec
                m = rec["memory"]
                print(f"[ok] {key}: {rec['run_s']:.1f}s  "
                      f"flops/dev {rec['flops_loop_corrected']:.3e}  "
                      f"args {m['argument_bytes'] / 2**30:.2f}GiB  "
                      f"peak {m['peak_bytes'] / 2**30:.2f}GiB  "
                      f"coll {rec['collectives_loop_corrected']['total_bytes'] / 2**30:.3f}GiB",
                      flush=True)
            except Exception as e:  # noqa: BLE001
                failures.append((key, repr(e)))
                print(f"[FAIL] {key}: {e}", file=sys.stderr)
                traceback.print_exc()
                if not args.continue_on_error:
                    raise
            finally:
                # re-merge against the file (other cells may have landed since it
                # was read) and write atomically
                merged = {}
                if outfile.exists():
                    try:
                        for r in json.loads(outfile.read_text()):
                            merged[(r["arch"], r["shape"])] = r
                    except Exception:  # noqa: BLE001 -- a torn file is rewritten whole
                        pass
                merged.update(existing)
                tmp = outfile.with_suffix(".tmp")
                tmp.write_text(json.dumps(list(merged.values()), indent=1))
                tmp.rename(outfile)

    print(f"\n{len(existing)} cells recorded -> {outfile}")
    if failures:
        print(f"{len(failures)} FAILURES:")
        for k, e in failures:
            print(" ", k, e)
        sys.exit(1)


if __name__ == "__main__":
    main()

"""The control of the comparison: the reference put in the program's place,
its products computed in TF32 (the precision below the configuration's
fp32 with TF32 off), judged by the same numbers and limits as a run.  The
control has to come out not correct; its readings set the limits' upper
ends (PERF.md).  It needs no program: the inputs, the fp32 reference and the
TF32 control are all this folder's.

    python3 bench/control.py --workload msmarco-sq8-k1024 --seeds 11,12,13

prints one JSON line a seed: the control's numbers, the limits and whether
the control passed (it must not).  On a machine without a card it runs on
the CPU (``--device cpu``), at the cell's size: slow.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def control_numbers(cell, seed: int, device) -> dict:
    """The control's numbers on the batches a run would sample first (the
    first ``check_batches`` of the traffic)."""
    import torch

    from bench import compare
    from bench.corpus import Corpus
    from bench.reference import Reference

    tr, search = cell.traffic, cell.traffic["search"]
    corpus = Corpus(cell.cfg, seed, device, int(tr["source_docs"]))
    ref = Reference(corpus, cell.cfg, "fp32").build(fill_pool=True)
    ctl = Reference(corpus, cell.cfg, "tf32").build()
    g = torch.Generator(device=corpus.dev)
    qs = [corpus.queries(b, tr, g) for b in range(int(tr["check_batches"]))]
    q, qm = torch.cat([x[0] for x in qs]), torch.cat([x[1] for x in qs])
    nprobe, kp, k = int(search["nprobe"]), int(search["k_prime"]), int(search["k"])
    cand_ref, _ = ref.search_first_stage(q, qm, nprobe, kp)
    cand_c, _ = ctl.search_first_stage(q, qm, nprobe, kp)
    del ctl.ivf
    scores_c, ids_c = ctl.serve(q, qm, cand_c, k)
    return compare.numbers(ref, q, qm, cand_ref, cand_c, ids_c, scores_c, k)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import compare, spec

    cell = spec.cell(args.workload, ROOT / "BENCHMARK.json")
    for seed in (int(s) for s in args.seeds.split(",")):
        v = control_numbers(cell, seed, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": v,
                          "limits": cell.limits,
                          "control_passes": compare.verdict(v, cell.limits)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

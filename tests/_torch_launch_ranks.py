"""Two gloo ranks running ``repro_torch.launch.serve.main`` with ``--mesh
2``, for ``tests/test_torch_launch.py``: the launcher under a process group
it finds (as under ``torchrun``), every rank building the same retriever.

    python tests/_torch_launch_ranks.py OUT_DIR LAUNCHER_ARGS...

Each rank sets up its group from a ``file://`` store in OUT_DIR (concurrent
runs never share a port), runs the launcher with its stdout captured, checks
that the launcher left the group it found alive, and writes what it printed
to ``OUT_DIR/rank_r.txt``.  This file imports no JAX.
"""
import contextlib
import io
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 2


def rank_main(rank, out_dir, argv):
    from repro_torch.launch import serve

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/pg_store",
                            world_size=WORLD, rank=rank)
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve.main(argv)
        assert dist.is_initialized(), "the launcher destroyed a group it did not make"
        with open(f"{out_dir}/rank_{rank}.txt", "w") as f:
            f.write(buf.getvalue())
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(rank_main, args=(sys.argv[1], sys.argv[2:]), nprocs=WORLD, join=True)

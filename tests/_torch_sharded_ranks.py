"""Eight gloo ranks of the port's corpus-sharded serving on a (2, 4)
("data", "model") DeviceMesh, for ``tests/test_torch_sharded.py``.

    python tests/_torch_sharded_ranks.py INPUTS.npz CHECKPOINT OUT_DIR

INPUTS.npz holds the queries (``q``, ``qm``), the index step's inputs
(psi's four arrays, ``x_ols``, ``docs``, ``mask``) and the docs the
mutation adds (``new_tokens``, ``new_mask``).  Every rank loads the
checkpoint on the CPU, shards it onto the mesh (fp32 and SQ8) and serves
each route of ROUTES; fits the W rows of its block of ``docs`` with
``make_index_step``; then, on a fresh shard of each kind, adds, deletes and
updates docs (its block saved, with its first row), adds past the pool's
free rows (a rebuild; the block saved again) and serves the default route.  Rank r writes ``OUT_DIR/rank_r.npz``.  The process
group is set up from a ``file://`` store in OUT_DIR, so concurrent runs
never share a port.  This file imports no JAX.
"""
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import init_device_mesh

WORLD = 8
#: route name -> SearchParams keyword arguments
ROUTES = {"fused": {}, "one_launch": {"use_one_launch": True},
          "legacy": {"use_fused_gather": False}}


def save_block(res, prefix, sr, mesh):
    """This rank's block of the sharded state and its first global row."""
    from repro_torch.dist import local_rows

    for k, v in sr.state._asdict().items():
        if isinstance(v, torch.Tensor):
            res[prefix + k] = v.numpy()
    res[prefix + "start"] = np.array(
        local_rows(mesh, sr.rows_per_shard * len(sr._free_rows)).start)


def rank_main(rank, inputs, ckpt, out_dir):
    from repro_torch.core import indexer
    from repro_torch.core.config import LemurConfig
    from repro_torch.core.model import Psi
    from repro_torch.dist import local_rows, make_index_step
    from repro_torch.retriever import SearchParams, ShardedLemurRetriever

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/pg_store",
                            world_size=WORLD, rank=rank)
    try:
        mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
        z = np.load(inputs)
        res = {}
        for sq8 in (False, True):
            sr = ShardedLemurRetriever.load(ckpt, mesh, sq8=sq8)
            tag = "sq8" if sq8 else "fp32"
            res[f"{tag}_rows"] = np.array(sr.rows_per_shard)
            for name, kw in ROUTES.items():
                s, i = sr.search(z["q"], z["qm"], SearchParams(**kw))
                res[f"{tag}_{name}_scores"], res[f"{tag}_{name}_ids"] = s.numpy(), i.numpy()
        psi = Psi.from_arrays(*(z[k] for k in ("kernel", "bias", "ln_scale", "ln_bias")),
                              device="cpu")
        x = torch.as_tensor(z["x_ols"])
        chol, feats = indexer.gram_factor(psi, x, float(z["ridge"]))
        rows = local_rows(mesh, z["docs"].shape[0])
        step = make_index_step(mesh, LemurConfig(d=16, d_prime=32), doc_block=12)
        res["W"] = step(chol, feats, x, torch.as_tensor(z["docs"][rows]),
                        torch.as_tensor(z["mask"][rows]), torch.zeros(()),
                        torch.ones(())).numpy()
        res["rows"] = np.array([rows.start, rows.stop])
        new_t, new_m = z["new_tokens"], z["new_mask"]
        for sq8 in (False, True):
            sr = ShardedLemurRetriever.load(ckpt, mesh, sq8=sq8)
            tag = "mut_sq8" if sq8 else "mut_fp32"
            sr.add(new_t[:10], new_m[:10])
            sr.delete([5, 91])
            sr.update([6, 94], new_t[10:13], new_m[10:13])
            save_block(res, f"{tag}1_", sr, mesh)
            sr.add(new_t[13:53], new_m[13:53])
            save_block(res, f"{tag}2_", sr, mesh)
            res[f"{tag}_rows"] = np.array(sr.rows_per_shard)
            s, i = sr.search(z["q"], z["qm"])
            res[f"{tag}_scores"], res[f"{tag}_ids"] = s.numpy(), i.numpy()
        np.savez(f"{out_dir}/rank_{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(rank_main, args=tuple(sys.argv[1:4]), nprocs=WORLD, join=True)

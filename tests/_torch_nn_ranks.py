"""Eight gloo ranks of the port's mesh forms, for ``tests/test_torch_nn_mesh.py``.

    python tests/_torch_nn_ranks.py INPUTS.npz OUT_DIR

INPUTS.npz holds global arrays: the MoE params (``moe/<leaf>``, the shared
expert as ``moe/shared/<leaf>``) and its tokens ``moe_x`` (B, T, d); the
attention's ``q``, ``k``, ``v`` (B, T, H, D) and ``pos`` (B, T); the
gradients ``ef_g`` (steps, 4, n) of the error-feedback all-reduce.  Every
rank cuts its own blocks (``nn.moe.moe_local_params`` / ``local_tokens``,
the attention's (batch, sequence) block), and runs:

* ``moe_apply`` in the ``ep`` layout on a (2, 2, 2) ("pod", "data",
  "model") mesh and in the ``ffslice`` layout on a (2, 4) ("data",
  "model") mesh, each with the token-gather body (threshold 4,096) and the
  weight-gather body (threshold 0), at capacity factors 8 and 1 (the latter
  drops tokens);
* ``flash_attention_cp`` on a (4, 2) ("data", "model") mesh, causal and
  chunked;
* ``ef_int8_allreduce`` over the "data" axis of that mesh for each step.

Rank r writes ``OUT_DIR/rank_r.npz``.  The process group is set up from a
``file://`` store in OUT_DIR.  This file imports no JAX.
"""
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import init_device_mesh

WORLD = 8
#: (layout, mesh shape, mesh axis names)
MOE_MESHES = (("ep", (2, 2, 2), ("pod", "data", "model")),
              ("ffslice", (2, 4), ("data", "model")))
BODIES = {"gather_tokens": 4096, "gather_weights": 0}
FACTORS = (8.0, 1.0)


def moe_params(z):
    p = {k[4:]: torch.as_tensor(v) for k, v in z.items()
         if k.startswith("moe/") and not k.startswith("moe/shared/")}
    p["shared"] = {}
    for k, v in z.items():
        if k.startswith("moe/shared/"):
            node = p["shared"]
            *head, last = k[len("moe/shared/"):].split("/")
            for part in head:
                node = node.setdefault(part, {})
            node[last] = torch.as_tensor(v)
    return p


def rank_main(rank, inputs, out_dir):
    from repro_torch.common import collectives
    from repro_torch.nn import attention, moe
    from repro_torch.optim.compress import ef_int8_allreduce

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/pg_store",
                            world_size=WORLD, rank=rank)
    try:
        z = dict(np.load(inputs))
        res = {}
        params = moe_params(z)
        x = torch.as_tensor(z["moe_x"])
        n_tokens = x.shape[0] * x.shape[1]
        for layout, shape, names in MOE_MESHES:
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
            local_p = moe.moe_local_params(params, layout, mesh)
            local_x = moe.local_tokens(x, mesh)
            for body, threshold in BODIES.items():
                for factor in FACTORS:
                    y, aux = moe.moe_apply(local_p, local_x, layout=layout, n_experts=8,
                                           top_k=2, mesh=mesh, n_tokens=n_tokens,
                                           capacity_factor=factor,
                                           token_gather_threshold=threshold)
                    tag = f"{layout}_{body}_{factor:g}"
                    res[tag + "_y"], res[tag + "_aux"] = y.numpy(), aux.numpy()
        mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
        i, j = (collectives.axis_index(mesh, a) for a in ("data", "model"))
        B, T_ = z["q"].shape[:2]
        bs, ts = B // 4, T_ // 2
        cut = lambda a: torch.as_tensor(a[i * bs:(i + 1) * bs, j * ts:(j + 1) * ts])
        for chunk in (None, 4):
            o = attention.flash_attention_cp(cut(z["q"]), cut(z["k"]), cut(z["v"]),
                                             cut(z["pos"]), mesh, chunk=chunk, q_block=8,
                                             kv_block=4)
            res[f"cp_{chunk}"] = o.numpy()
        err = {"g": torch.zeros(z["ef_g"].shape[-1])}
        for s, g in enumerate(z["ef_g"]):
            red, err = ef_int8_allreduce({"g": torch.as_tensor(g[i])}, err,
                                         mesh.get_group("data"))
            res[f"ef_{s}_reduced"], res[f"ef_{s}_error"] = red["g"].numpy(), err["g"].numpy()
        res["coord"] = np.array([i, j])
        np.savez(f"{out_dir}/rank_{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(rank_main, args=tuple(sys.argv[1:3]), nprocs=WORLD, join=True)

"""Eight gloo ranks of the models' mesh forms, for
``tests/test_torch_dist_models.py``.

    python tests/_torch_dist_ranks.py INPUTS.npz CKPT_DIR OUT_DIR CASES

INPUTS.npz holds whole arrays under ``<case>/...`` (see the test): each
rank cuts its blocks (``dist.sharding``), runs the mesh form and gathers
its outputs whole again (``gather_block`` by their specs), so every rank
writes the whole result to ``OUT_DIR/rank_r.npz``.  CASES is a comma list
of ``models`` (the lookup, the GNN, the recsys archs, the loader and the
checkpoint) and LM arch ids:

* ``lookup``: ``recsys.sharded_embedding_lookup`` on (2, 4);
* ``gnn``: ``gnn.forward``, ``loss_fn`` and one ``make_train_step`` step
  on (2, 4) ("data", "model"), nodes over "data", edges over every axis;
* ``recsys/<arch>``: one ``make_train_step`` step of the four SMOKE archs
  on (2, 4), and two-tower's ``make_retrieval_step`` (k 10) over the
  candidates split over every axis;
* ``lm/<arch>``: ``forward_train``, ``lm_loss``, the gradients, one
  ``make_train_step`` step, ``prefill`` and 3 ``decode`` steps: gemma-7b on
  (2, 4), deepseek-v3 on (2, 2, 2) ("pod", "data", "model"), llama4 on
  (4, 2);
* ``loader``: ``ShardedLoader(shardings=)`` on (2, 4); ``ckpt``:
  ``restore_tree(shardings=)`` of the JAX-saved checkpoint in CKPT_DIR.

The process group is set up from a ``file://`` store in OUT_DIR.  This
file imports no JAX.
"""
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import init_device_mesh

WORLD = 8
#: (arch, mesh shape, axis names, batch, sequence)
LM_CASES = (("gemma-7b", (2, 4), ("data", "model"), 2, 512),
            ("deepseek-v3-671b", (2, 2, 2), ("pod", "data", "model"), 4, 256),
            ("llama4-maverick-400b-a17b", (4, 2), ("data", "model"), 4, 256))
RECSYS_ARCHS = ("deepfm", "xdeepfm", "bst", "two-tower-retrieval")
CACHE_PAD = 8
DECODE_STEPS = 3


def tree(z, prefix):
    from repro_torch.convert import _nested

    return _nested({k[len(prefix):]: v for k, v in z.items() if k.startswith(prefix)})


def put(res, prefix, t):
    from repro_torch.common.pytree import named_leaves

    for n, v in named_leaves(t):
        res[prefix + n] = v.detach().float().numpy() if v.is_floating_point() else v.numpy()


def lm_case(z, res, arch, shape, names, B, T):
    from repro_torch.configs.registry import get_arch
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.dist import sharding as sh
    from repro_torch.models import lm
    from repro_torch.optim.adam import adam_init

    cfg = get_arch(arch).SMOKE
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    pre = f"lm/{arch}/"
    params = lm_params_from_numpy(tree(z, pre + "params/"), cfg, device="cpu")
    specs = lm.lm_specs(cfg, params)
    local = sh.shard_tree(params, specs, mesh)
    toks = torch.as_tensor(z[pre + "tokens"]).long()
    labels = torch.as_tensor(z[pre + "labels"]).long()
    lay = lm.mesh_layout(mesh, B, T)
    ba = lay.batch_axes if lay.split_rows else None
    hspec = sh.P(ba, "model" if lay.cp else None, None)
    (tot, (loss, aux)), grads = lm.value_and_grad(local, toks, labels, cfg, mesh)
    hidden, aux2 = lm.forward_train(local, toks, cfg, mesh)
    res[pre + "hidden"] = sh.gather_block(hidden, hspec, mesh).numpy()
    res[pre + "loss"], res[pre + "aux"] = float(loss), float(aux)
    res[pre + "aux_forward"] = float(aux2)
    put(res, pre + "grads/", sh.gather_tree(grads, specs, mesh))
    step = lm.make_train_step(cfg, mesh)
    new, _, met = step(local, adam_init(local), {"tokens": toks, "labels": labels})
    put(res, pre + "step_params/", sh.gather_tree(new, specs, mesh))
    res[pre + "step_loss"], res[pre + "step_grad_norm"] = float(met["loss"]), float(
        met["grad_norm"])
    with torch.no_grad():
        logits, caches = lm.prefill(local, toks, cfg, T + CACHE_PAD, mesh)
        rspec = sh.P(ba, None)
        res[pre + "prefill_logits"] = sh.gather_block(logits, rspec, mesh).numpy()
        cspecs = lm.cache_specs(cfg, mesh, B, caches)
        put(res, pre + "caches/", sh.gather_tree(caches, cspecs, mesh))
        for s in range(DECODE_STEPS):
            tok = torch.as_tensor(z[pre + "decode_tokens"][s]).long()
            logits, caches = lm.decode(local, tok, caches, T + 1 + s, cfg, mesh)
            res[pre + f"decode_logits_{s}"] = sh.gather_block(logits, rspec, mesh).numpy()
        put(res, pre + "decode_caches/", sh.gather_tree(caches, cspecs, mesh))


def recsys_cases(z, res, mesh):
    from repro_torch.configs.registry import get_arch
    from repro_torch.convert import params_from_numpy
    from repro_torch.dist import sharding as sh
    from repro_torch.models import recsys
    from repro_torch.optim.adam import adam_init

    rows = sh.P(("data",))
    for arch in RECSYS_ARCHS:
        cfg = get_arch(arch).SMOKE
        pre = f"recsys/{arch}/"
        params = params_from_numpy(tree(z, pre + "params/"), device="cpu")
        specs = sh.spec_tree(params, sh.RECSYS_RULES)
        local = sh.shard_tree(params, specs, mesh)
        batch = {k: torch.as_tensor(v) for k, v in tree(z, pre + "batch/").items()}
        lb = {k: sh.local_block(v, sh.P(*rows, *([None] * (v.dim() - 1))), mesh)
              for k, v in batch.items()}
        lb = {k: (v.long() if not v.is_floating_point() else v) for k, v in lb.items()}
        new, opt, met = recsys.make_train_step(cfg, mesh)(local, adam_init(local), lb)
        put(res, pre + "step_params/", sh.gather_tree(new, specs, mesh))
        put(res, pre + "step_mu/", sh.gather_tree(opt.mu, specs, mesh))
        res[pre + "loss"], res[pre + "grad_norm"] = float(met["loss"]), float(met["grad_norm"])
        scores = recsys.make_serve_step(cfg, mesh)(local, {k: v for k, v in lb.items()
                                                           if k != "labels"})
        res[pre + "serve"] = sh.gather_block(scores, rows, mesh).numpy()
        if cfg.model == "two_tower":
            cand = torch.as_tensor(z[pre + "candidates"])
            every = sh.P(tuple(mesh.mesh_dim_names), None)
            top, ids = recsys.make_retrieval_step(cfg, mesh, k=10)(
                local, {"ids": torch.as_tensor(z[pre + "query"]).long()},
                sh.local_block(cand, every, mesh))
            res[pre + "retrieval_scores"], res[pre + "retrieval_ids"] = top.numpy(), ids.numpy()


def gnn_case(z, res, mesh):
    from repro_torch.convert import params_from_numpy
    from repro_torch.dist import sharding as sh
    from repro_torch.models import gnn
    from repro_torch.optim.adam import adam_init

    cfg = gnn.GNNConfig(n_layers=2, d_hidden=16, d_node_in=8, d_edge_in=4, d_out=2)
    params = params_from_numpy(tree(z, "gnn/params/"), device="cpu")
    nodes, edges = sh.P(("data",)), sh.P(("data", "model"))
    g = {k: torch.as_tensor(v) for k, v in tree(z, "gnn/batch/").items()}
    cut = {k: sh.local_block(v, edges if k in ("edge_feat", "senders", "receivers")
                             else nodes, mesh) for k, v in g.items()}
    cut["senders"], cut["receivers"] = cut["senders"].long(), cut["receivers"].long()
    with torch.no_grad():
        out = gnn.forward(params, cut["node_feat"], cut["edge_feat"], cut["senders"],
                          cut["receivers"], cfg, mesh)
    res["gnn/forward"] = sh.gather_block(out, nodes, mesh).numpy()
    res["gnn/loss"] = float(gnn.loss_fn(params, cut, cfg, mesh))
    new, opt, met = gnn.make_train_step(cfg, mesh)(params, adam_init(params), cut)
    put(res, "gnn/step_params/", new)
    put(res, "gnn/step_mu/", opt.mu)
    res["gnn/step_loss"], res["gnn/step_grad_norm"] = float(met["loss"]), float(
        met["grad_norm"])


def rank_main(rank, inputs, ckpt, out_dir, cases):
    from repro_torch.checkpoint.manager import restore_tree
    from repro_torch.common.pytree import tree_map
    from repro_torch.convert import params_from_numpy
    from repro_torch.data.loader import ShardedLoader
    from repro_torch.dist import sharding as sh
    from repro_torch.models import recsys

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/pg_store",
                            world_size=WORLD, rank=rank)
    try:
        z = dict(np.load(inputs))
        res = {}
        cases = cases.split(",")
        for case in LM_CASES:
            if case[0] in cases:
                lm_case(z, res, *case)
        mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
        res["coord"] = np.array(mesh.get_coordinate())
        if "models" not in cases:
            np.savez(f"{out_dir}/rank_{rank}.npz", **res)
            return
        table, ids = torch.as_tensor(z["lookup/table"]), torch.as_tensor(z["lookup/ids"])
        got = recsys.sharded_embedding_lookup(sh.local_block(table, sh.P("model", None), mesh),
                                              sh.local_block(ids, sh.P(("data",), None), mesh),
                                              mesh)
        res["lookup"] = sh.gather_block(got, sh.P(("data",), None, None), mesh).numpy()
        gnn_case(z, res, mesh)
        recsys_cases(z, res, mesh)
        # the loader and the checkpoint
        specs = {"ids": sh.P(("data",), None), "labels": sh.P(("data",)), "w": sh.P()}
        host = [{"ids": z["loader/ids"][i], "labels": z["loader/labels"][i], "w": z["loader/w"]}
                for i in range(z["loader/ids"].shape[0])]
        for i, b in enumerate(ShardedLoader(host, specs, mesh=mesh, device="cpu")):
            for k, v in b.items():
                res[f"loader/{i}/{k}"] = v.numpy()
        params = params_from_numpy(tree(z, "ckpt/params/"), device="cpu")
        cspecs = sh.spec_tree(params, sh.RECSYS_RULES)
        target = tree_map(lambda s, x: torch.zeros_like(sh.local_block(x, s, mesh)),
                          cspecs, params)
        restored, step = restore_tree(ckpt, target, shardings=cspecs, mesh=mesh)
        res["ckpt/step"] = step
        put(res, "ckpt/blocks/", restored)
        np.savez(f"{out_dir}/rank_{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(rank_main, args=tuple(sys.argv[1:5]), nprocs=WORLD, join=True)

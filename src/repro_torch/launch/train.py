"""Training launcher (twin of ``repro/launch/train.py``):

  PYTHONPATH=src python -m repro_torch.launch.train --arch <id> [--steps N] [--full]
  PYTHONPATH=src python -m repro_torch.launch.train --arch deepfm --steps 20 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch lemur [--backend NAME]

LM, GNN and recsys archs run their SMOKE config (``--full``: the full one)
on synthetic data through the fault-tolerant ``TrainLoop``: it restores the
newest checkpoint under ``--checkpoint-dir`` first, so a second run resumes
at the saved step.  Batches reach the device through ``ShardedLoader``.
``--arch lemur`` runs the paper's pipeline instead: ψ pre-training, the OLS
fit, the index (``--backend``: any ``repro_torch.anns.registry`` name) and a
recall report.

It runs on the card (``--device cuda``, the default) and raises without one
unless ``--device cpu`` is passed.  The JAX twin's docstring names
``--mesh`` and ``--full`` forms that its code does not take; the mesh steps
are the models' ``make_train_step(cfg, mesh)``, which the dry-run cells
(``launch/cells.py``) run.  ``main`` returns what it printed as numbers,
for callers that run it in-process.
"""
from __future__ import annotations

import argparse
import itertools
import os
import tempfile

import numpy as np
import torch


def _lemur(args, mod, dev) -> dict:
    from repro_torch.core import maxsim, recall_at
    from repro_torch.data import synthetic
    from repro_torch.retriever import LemurRetriever, SearchParams

    cfg = mod.CONFIG if args.full else mod.SMOKE
    if args.backend:
        cfg = cfg.replace(anns=args.backend)
    corpus = synthetic.make_corpus(m=4000, d=cfg.d, avg_tokens=12, max_tokens=16, seed=0)
    r = LemurRetriever.build(corpus, cfg, generator=torch.Generator().manual_seed(0),
                             device=dev, verbose=True)
    q = torch.as_tensor(synthetic.queries_from_corpus_query(corpus, 64, 8, seed=7)).to(dev)
    qm = torch.ones(q.shape[:2], dtype=torch.bool, device=dev)
    _, truth = maxsim.true_topk(q, qm, r.index.doc_tokens, r.index.doc_mask, cfg.k)
    _, ids = r.search(q, qm, SearchParams())
    recall = float(recall_at(ids, truth).mean())
    print(f"[lemur] backend={r.backend} recall@{cfg.k} = {recall:.3f}")
    return {"backend": r.backend, "k": cfg.k, "recall": recall}


def _batches(args, mod, cfg):
    """-> (params, step, opt_state, host batches) for an LM, GNN or recsys arch."""
    from repro_torch.data import synthetic
    from repro_torch.optim import adam_init

    gen = torch.Generator().manual_seed(0)
    dev = args.dev
    if mod.FAMILY == "lm":
        from repro_torch.models import lm

        params = lm.init_lm(gen, cfg, device=dev)
        step = lm.make_train_step(cfg)
        batches = ({"tokens": t.astype(np.int64), "labels": l.astype(np.int64)}
                   for t, l in synthetic.lm_token_batches(cfg.vocab, args.batch, args.seq,
                                                          args.steps))
    elif mod.FAMILY == "gnn":
        from repro_torch.models import gnn

        g = synthetic.make_mesh_graph(500, d_feat=cfg.d_node_in, d_edge=cfg.d_edge_in,
                                      d_out=cfg.d_out)
        params = gnn.init_gnn(gen, cfg, device=dev)
        step = gnn.make_train_step(cfg)
        b = {"node_feat": g.node_feat, "edge_feat": g.edge_feat, "senders": g.senders,
             "receivers": g.receivers, "labels": g.labels}
        batches = (b for _ in range(args.steps))
    else:  # recsys
        from repro_torch.models import recsys

        params = recsys.init_recsys(gen, cfg, device=dev)
        step = recsys.make_train_step(cfg)

        def gen_batches():
            for i in range(args.steps):
                d = synthetic.make_clicks(64, max(cfg.n_fields, 1),
                                          np.array(cfg.vocab_sizes or [10]),
                                          seed=i, hist_len=cfg.seq_len, n_items=cfg.n_items)
                if cfg.model == "bst":
                    yield {"history": d["history"], "target_item": d["target_item"],
                           "labels": d["labels"]}
                elif cfg.model == "two_tower":
                    yield {"ids": d["ids"][:, :cfg.n_fields], "item": d["target_item"],
                           "labels": d["labels"]}
                else:
                    yield {"ids": d["ids"][:, :cfg.n_fields], "labels": d["labels"]}

        batches = gen_batches()
    return params, step, adam_init(params), batches


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--checkpoint-dir",
                   default=os.path.join(tempfile.gettempdir(), "repro_torch_train"))
    p.add_argument("--checkpoint-every", type=int, default=50)
    p.add_argument("--full", action="store_true",
                   help="use the FULL config instead of SMOKE")
    p.add_argument("--backend", default=None,
                   help="lemur only: first-stage anns backend "
                        "(repro_torch.anns.registry name)")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    from repro_torch.common.device import resolve_device
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.loader import ShardedLoader
    from repro_torch.train import TrainerConfig, TrainLoop

    args.dev = resolve_device(args.device)
    mod = get_arch(args.arch)
    if mod.FAMILY == "lemur":
        return _lemur(args, mod, args.dev)

    tc = TrainerConfig(total_steps=args.steps, checkpoint_every=args.checkpoint_every,
                       checkpoint_dir=args.checkpoint_dir, log_every=10)
    cfg = mod.CONFIG if args.full else mod.SMOKE
    params, step, opt, batches = _batches(args, mod, cfg)
    loop = TrainLoop(tc, step, params, opt)
    loop.try_restore()
    # the batches the loop will take, so the loader's producer runs to its end
    out = loop.run(ShardedLoader(itertools.islice(batches, max(0, args.steps - loop.step)),
                                 device=args.dev))
    loss = out["history"][-1]["loss"] if out["history"] else float("nan")
    print(f"[train] done: step {out['final_step']}, "
          f"loss {loss:.4f}, "
          f"retries={out['retries']} nan_skips={out['nan_skips']} "
          f"stragglers={out['stragglers']}")
    return {"final_step": out["final_step"], "loss": loss, "restores": out["restores"],
            "retries": out["retries"], "nan_skips": out["nan_skips"],
            "stragglers": out["stragglers"], "history": out["history"]}


if __name__ == "__main__":
    main()

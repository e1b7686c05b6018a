"""Run one training step of every registered architecture's reduced
config — the ``--arch`` selector demonstration (twin of
``examples/multi_arch_smoke.py``).

  PYTHONPATH=src python -m repro_torch.examples.multi_arch_smoke [--arch qwen2.5-32b]
  PYTHONPATH=src python -m repro_torch.examples.multi_arch_smoke --device cpu

It runs on the card and raises without one unless ``--device cpu`` is
passed.  ``main`` returns each arch's loss and gradient norm.
"""
import argparse

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.optim import adam_init


def run_one(arch: str, device="cuda") -> dict | None:
    from repro_torch.data import synthetic

    dev = resolve_device(device)
    mod = get_arch(arch)
    cfg = mod.SMOKE
    if mod.FAMILY == "lm":
        from repro_torch.models import lm

        params = lm.init_lm(torch.Generator().manual_seed(0), cfg, device=dev)
        toks = torch.randint(0, cfg.vocab, (2, 32), generator=torch.Generator().manual_seed(1))
        toks = toks.to(dev)
        p, o, m = lm.make_train_step(cfg)(params, adam_init(params),
                                          {"tokens": toks, "labels": toks})
    elif mod.FAMILY == "gnn":
        from repro_torch.models import gnn

        g = synthetic.make_mesh_graph(200, d_feat=cfg.d_node_in, d_edge=cfg.d_edge_in,
                                      d_out=cfg.d_out)
        params = gnn.init_gnn(torch.Generator().manual_seed(0), cfg, device=dev)
        b = {k: torch.as_tensor(getattr(g, k)).to(dev)
             for k in ("node_feat", "edge_feat", "senders", "receivers", "labels")}
        p, o, m = gnn.make_train_step(cfg)(params, adam_init(params), b)
    elif mod.FAMILY == "recsys":
        from repro_torch.models import recsys

        params = recsys.init_recsys(torch.Generator().manual_seed(0), cfg, device=dev)
        d = synthetic.make_clicks(32, max(cfg.n_fields, 1),
                                  np.array(cfg.vocab_sizes or [10]),
                                  hist_len=cfg.seq_len, n_items=cfg.n_items)
        if cfg.model == "bst":
            b = {"history": d["history"], "target_item": d["target_item"],
                 "labels": d["labels"]}
        elif cfg.model == "two_tower":
            b = {"ids": d["ids"][:, :cfg.n_fields], "item": d["target_item"],
                 "labels": d["labels"]}
        else:
            b = {"ids": d["ids"][:, :cfg.n_fields], "labels": d["labels"]}
        b = {k: torch.as_tensor(v).to(dev) for k, v in b.items()}
        p, o, m = recsys.make_train_step(cfg)(params, adam_init(params), b)
    else:
        print(f"  {arch}: (lemur — see quickstart.py)")
        return None
    print(f"  {arch:28s} loss={float(m['loss']):.4f} grad_norm={float(m['grad_norm']):.3f}")
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCHS))
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    targets = [args.arch] if args.arch else [a for a in ARCHS if a != "lemur"]
    print("one reduced-config train step per architecture:")
    return {a: run_one(a, dev) for a in targets}


if __name__ == "__main__":
    main()

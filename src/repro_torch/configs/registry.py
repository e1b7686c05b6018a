"""Architecture registry: ``--arch <id>`` -> config module (twin of
``repro/configs/registry.py``).

``build_cell`` instantiates a dry-run cell (``launch/cells.py``)."""
from __future__ import annotations

import importlib
from typing import Any

ARCHS: dict[str, str] = {
    # LM family
    "qwen2.5-32b": "repro_torch.configs.qwen2_5_32b",
    "granite-20b": "repro_torch.configs.granite_20b",
    "gemma-7b": "repro_torch.configs.gemma_7b",
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick_400b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    # GNN
    "meshgraphnet": "repro_torch.configs.meshgraphnet",
    # RecSys
    "deepfm": "repro_torch.configs.deepfm",
    "bst": "repro_torch.configs.bst",
    "two-tower-retrieval": "repro_torch.configs.two_tower",
    "xdeepfm": "repro_torch.configs.xdeepfm",
    # the paper's own
    "lemur": "repro_torch.configs.lemur_paper",
}


def list_archs() -> list[str]:
    return list(ARCHS)


def get_arch(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return importlib.import_module(ARCHS[arch])


def build_cell(arch: str, shape: str, mesh) -> Any:
    """Instantiate the dry-run Cell for one (arch x shape) pair on ``mesh``
    (a DeviceMesh, or {axis: size} for the specs and shapes alone)."""
    from repro_torch.launch import cells

    mod = get_arch(arch)
    if shape not in mod.SHAPES:
        raise KeyError(f"{arch} has no shape {shape!r}; known: {sorted(mod.SHAPES)}")
    spec = dict(mod.SHAPES[shape])
    kind = spec.pop("kind")
    family = mod.FAMILY

    if family == "lm":
        cfg = mod.CONFIG
        if kind == "train":
            return cells.lm_train_cell(
                arch, cfg, seq=spec["seq"], global_batch=spec["global_batch"],
                mesh=mesh, use_adam8=getattr(mod, "USE_ADAM8", False))
        if kind == "prefill":
            return cells.lm_prefill_cell(
                arch, cfg, seq=spec["seq"], global_batch=spec["global_batch"], mesh=mesh)
        if kind == "decode":
            return cells.lm_decode_cell(
                arch, cfg, seq=spec["seq"], global_batch=spec["global_batch"], mesh=mesh)
    elif family == "gnn":
        cfg = spec.pop("cfg", mod.CONFIG)
        if kind in ("full", "batched"):
            return cells.gnn_full_cell(
                arch, cfg, n_nodes=spec["n_nodes"], n_edges=spec["n_edges"],
                mesh=mesh, n_graphs=spec.get("n_graphs", 0))
        if kind == "sampled":
            return cells.gnn_sampled_cell(
                arch, cfg, n_nodes=spec["n_nodes"], n_edges=spec["n_edges"],
                batch_nodes=spec["batch_nodes"], d_feat=spec["d_feat"], mesh=mesh)
    elif family == "recsys":
        cfg = mod.CONFIG
        if kind in ("train", "serve"):
            return cells.recsys_cell(arch, cfg, batch=spec["batch"], mesh=mesh, kind=kind)
        if kind == "retrieval":
            return cells.recsys_retrieval_cell(
                arch, cfg, n_candidates=spec["n_candidates"], mesh=mesh)
    elif family == "lemur":
        cfg = mod.CONFIG
        if kind == "lemur_serve":
            return cells.lemur_serve_cell(
                arch, cfg, m=spec["m"], doc_tokens=spec["doc_tokens"],
                q_tokens=spec["q_tokens"], batch=spec["batch"], mesh=mesh)
        if kind == "lemur_index":
            return cells.lemur_index_cell(
                arch, cfg, m=spec["m"], doc_tokens=spec["doc_tokens"], mesh=mesh)
    raise ValueError(f"no builder for family={family} kind={kind}")


def all_cells() -> list[tuple[str, str]]:
    """The full (arch × shape) matrix (assigned 40 cells + the paper's own)."""
    out = []
    for arch in ARCHS:
        mod = get_arch(arch)
        for shape in mod.SHAPES:
            out.append((arch, shape))
    return out

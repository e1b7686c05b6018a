"""Architecture registry: ``--arch <id>`` -> config module (twin of
``repro/configs/registry.py``).

``build_cell`` instantiates a dry-run cell, which needs ``launch/cells.py``
and the sharding rules (ROADMAP Queue 1 item 10(d)): it checks the arch
and the shape as the JAX twin does, then raises."""
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
    """The dry-run Cell for one (arch × shape) pair: not ported yet."""
    mod = get_arch(arch)
    if shape not in mod.SHAPES:
        raise KeyError(f"{arch} has no shape {shape!r}; known: {sorted(mod.SHAPES)}")
    raise NotImplementedError(
        "build_cell needs launch/cells.py and the sharding rules (ROADMAP Queue 1 "
        "item 10(d))")


def all_cells() -> list[tuple[str, str]]:
    """The full (arch × shape) matrix (assigned 40 cells + the paper's own)."""
    out = []
    for arch in ARCHS:
        mod = get_arch(arch)
        for shape in mod.SHAPES:
            out.append((arch, shape))
    return out

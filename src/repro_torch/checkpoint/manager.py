"""Read side of the JAX package's checkpoint layout
(``repro/checkpoint/manager.py``), straight into numpy:

    <dir>/step_000120/
        manifest.json      # leaf names, shapes, dtypes, extra (config, ...)
        shard_00000.npz    # leaves, with "/" in leaf names stored as "__"
        _COMMITTED         # written last: a directory without it is ignored
"""
from __future__ import annotations

import json
import os
import pathlib
import re

import numpy as np


def latest_step(directory: str | os.PathLike) -> int | None:
    """The newest committed step under ``directory``, or None."""
    d = pathlib.Path(directory)
    if not d.exists():
        return None
    best = None
    for sub in d.iterdir():
        m = re.fullmatch(r"step_(\d+)", sub.name)
        if m and (sub / "_COMMITTED").exists():
            s = int(m.group(1))
            best = s if best is None else max(best, s)
    return best


def restore(directory: str | os.PathLike, step: int | None = None):
    """Read one committed step -> ``({leaf name: np.ndarray}, manifest)``.

    Leaf names are the JAX ``named_leaves`` paths (``psi/dense/kernel``).
    Shapes and dtypes are checked against the manifest; a ``bfloat16`` leaf
    raises (npz cannot hold it and the port serves fp32)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {directory}")
    d = pathlib.Path(directory) / f"step_{step:08d}"
    if not (d / "_COMMITTED").exists():
        raise FileNotFoundError(f"{d} is not a committed checkpoint")
    manifest = json.loads((d / "manifest.json").read_text())
    with np.load(d / "shard_00000.npz") as data:
        leaves = {k.replace("__", "/"): data[k] for k in data.files}
    for name, spec in manifest["leaves"].items():
        if spec["dtype"] == "bfloat16":
            raise ValueError(f"{name}: bfloat16 leaves are not supported")
        if name not in leaves:
            raise KeyError(f"checkpoint {d} missing leaf {name!r}")
        arr = leaves[name]
        if arr.dtype.kind == "V" or str(arr.dtype) == "bfloat16":
            raise ValueError(f"{name}: bfloat16 leaves are not supported")
        if list(arr.shape) != list(spec["shape"]) or str(arr.dtype) != spec["dtype"]:
            raise ValueError(f"{name}: stored {arr.dtype}{list(arr.shape)} != "
                             f"manifest {spec['dtype']}{spec['shape']}")
    return leaves, manifest

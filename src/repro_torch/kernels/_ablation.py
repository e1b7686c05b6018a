"""What the ablation scripts (``maxsim_ablation``, ``residual_ablation``,
``serve_ablation``) share: build a kernel source several ways, each
variant a copy of ``csrc/`` with a few lines edited, into
``build/ablation/``, and time a call on the card."""
from __future__ import annotations

import ctypes
import pathlib
import subprocess

import numpy as np
import torch

from repro_torch.kernels import build


def build_variants(variants: dict, csrc=None) -> dict:
    """{(source, name): {file: [(old, new), ...]}} -> {(source, name):
    loaded library of ``csrc/<source>.cu`` with the edits made}, every nvcc
    started together.  ``csrc``: another source directory (an earlier
    checkout's ``src/repro_torch/csrc``) in place of the package's.  An edit
    whose old text is not in its file raises."""
    csrc = build.CSRC if csrc is None else pathlib.Path(csrc)
    procs = {}
    for (source, name), edits in variants.items():
        out = build.BUILD_DIR.parent / "ablation" / f"{source}-{name}"
        out.mkdir(parents=True, exist_ok=True)
        for src in csrc.glob("*.cu*"):
            text = src.read_text()
            for old, new in edits.get(src.name, []):
                if old not in text:
                    raise RuntimeError(f"{source}/{name}: {old!r} not in {src.name}")
                text = text.replace(old, new)
            (out / src.name).write_text(text)
        so = out / f"lib{source}.so"
        procs[(source, name)] = (so, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(out / f"{source}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{key}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.lemur_error_string.argtypes = [ctypes.c_int]
        lib.lemur_error_string.restype = ctypes.c_char_p
        libs[key] = lib
    return libs


def time_ms(fn, n=10):
    """Median ms of ``n`` calls (CUDA events), after two warm-up calls."""
    for _ in range(2):
        fn()
    ts = []
    for _ in range(n):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        ts.append(e0.elapsed_time(e1))
    return float(np.median(ts))


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()

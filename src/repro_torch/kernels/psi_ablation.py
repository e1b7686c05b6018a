"""What the parts of the psi kernel cost, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.psi_ablation [--parent CSRC]

Builds ``csrc/fused_psi_pool.cu`` several ways into ``build/ablation/``
(every nvcc started together), each variant a copy of the sources with a
few lines edited, and times each (CUDA events, median of 10) at the served
pool's shape (256 queries x 32 tokens, d 128, d' 2,048, a mask of about 94 %
valid tokens) and at the build's unpooled shape (16,384 rows).  The
variants of this design (``VARIANTS``):

- ``as_built``;
- ``no_product``: the wgmmas left out (the W' ring, the A loads and the
  epilogue kept);
- ``w_resident``: the producer copies each (tile, chunk) of W' only the
  first time, as if the block's slice of W' stayed in shared memory (the
  later tiles read stale stages);
- ``no_stats``: the LayerNorm statistics' exchange through the cluster left
  out (mean 0, variance 1: no distributed shared memory, no cluster waits).

``--parent CSRC``: also the same parts of the earlier design, built from
another checkout's ``src/repro_torch/csrc`` (one block a query, W' read
from L2 for every 8 rows, fp32 FMA, a (8 x d') GELU tile): ``as_built``,
``no_product`` (the FMA loop left out, and with it W's loads),
``w_smem`` (W' read from the GELU tile in shared memory instead of L2) and
``no_stats`` (the two passes over the GELU tile left out).

Only ``as_built`` computes psi; the others measure and nothing else.
Prints one JSON object with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json

import torch

from repro_torch.core.model import Psi
from repro_torch.kernels import build, fused_psi
from repro_torch.kernels._ablation import build_variants, card, time_ms

VARIANTS = {
    "as_built": {},
    "no_product": {"psi.cuh": [
        ("wgmma_tf32(acc, A[ks & 1][1], dh, sd);", "(void)dh;"),
        ("wgmma_tf32(acc, A[ks & 1][0], dl, 1);", "(void)dl;"),
        ("wgmma_tf32(acc, A[ks & 1][0], dh, 1);", "(void)dh;")]},
    "w_resident": {"psi.cuh": [
        ("const bool copy = true;   // every tile's chunks", "const bool copy = it < KC;")]},
    "no_stats": {"psi.cuh": [
        ("constexpr bool kPsiStats = true;", "constexpr bool kPsiStats = false;")]},
}
PARENT_VARIANTS = {
    "as_built": {},
    "no_product": {"psi.cuh": [
        ("if constexpr (CS == 1) {\n      for (int k = 0; k < D; ++k) {",
         "if constexpr (CS == 1) {\n      for (int k = 0; k < 0; ++k) {")]},
    "w_smem": {"psi.cuh": [
        ("j < Dp ? __ldg(W + (size_t)k * Dp + j) : 0.f;",
         "j < Dp ? hs[(size_t)(k & 7) * Dp + j] : 0.f;")]},
    "no_stats": {"psi.cuh": [
        ("for (int j = lane; j < Dp; j += 32) s += h[j];",
         "for (int j = lane; j < 0; j += 32) s += h[j];"),
        ("for (int j = lane; j < Dp; j += 32) {\n        const float dv = h[j] - mu;",
         "for (int j = lane; j < 0; j += 32) {\n        const float dv = h[j] - mu;")]},
}
B, TQ, D, DP, N_BUILD = 256, 32, 128, 2048, 16384


def with_lib(lib, fn):
    """Call ``fn`` with the wrappers' psi library swapped for ``lib``."""
    def run():
        saved = build._loaded.get("fused_psi_pool")
        build._loaded["fused_psi_pool"] = lib
        try:
            return fn()
        finally:
            if saved is None:
                build._loaded.pop("fused_psi_pool", None)
            else:
                build._loaded["fused_psi_pool"] = saved
    return run


def parent_call(lib, x, mask, w, out, n, seg, pool):
    """The earlier design's C entry: fused_psi(x, mask, W, b, gamma, beta,
    out, n_rows, seg_len, D, Dp, pool, eps, stream)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.fused_psi
    fn.argtypes = [p] * 7 + [i] * 5 + [ctypes.c_float, p]
    args = (x.data_ptr(), None if mask is None else mask.data_ptr(),
            *(t.data_ptr() for t in w), out.data_ptr(), n, seg, D, DP, pool, 1e-5,
            build.stream_ptr(x))
    return lambda: build.check(lib, fn(*args), "fused_psi (parent)")


def run(parent=None) -> dict:
    """Build the variants and time them; returns {name: ms} with the card
    and the shapes.  ``parent``: an earlier checkout's csrc to ablate too."""
    dev = torch.device("cuda")
    libs = build_variants({("fused_psi_pool", name): edits for name, edits in VARIANTS.items()})
    old = {}
    if parent:
        old = build_variants({("fused_psi_pool", f"parent_{name}"): edits
                              for name, edits in PARENT_VARIANTS.items()}, parent)
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.nn.functional.normalize(torch.randn(B, TQ, D, generator=gen, device=dev), dim=-1)
    qm = torch.rand(B, TQ, generator=gen, device=dev) < 0.94
    x = torch.nn.functional.normalize(torch.randn(N_BUILD, D, generator=gen, device=dev), dim=-1)
    psi = Psi.init(D, DP, torch.Generator().manual_seed(0), device=dev)
    w = (psi.dense.kernel, psi.dense.bias, psi.ln.scale, psi.ln.bias)
    res = {}
    for (_, name), lib in libs.items():
        res[f"pool_{name}_ms"] = time_ms(with_lib(lib, lambda: fused_psi.fused_psi_pool(
            q, qm, *w)))
        res[f"unpooled_{name}_ms"] = time_ms(with_lib(lib, lambda: fused_psi.fused_psi(x, *w)))
    pooled = torch.empty(B, DP, device=dev)
    feats = torch.empty(N_BUILD, DP, device=dev)
    for (_, name), lib in old.items():
        res[f"pool_{name}_ms"] = time_ms(parent_call(lib, q, qm, w, pooled, B * TQ, TQ, 1))
        res[f"unpooled_{name}_ms"] = time_ms(parent_call(lib, x, None, w, feats, N_BUILD, 32,
                                                         0))
    return {"card": card(),
            "shapes": {"pool": f"B {B} x Tq {TQ}, d {D}, d' {DP}, mask ~94 %",
                       "unpooled": f"{N_BUILD} rows, d {D}, d' {DP}"}, **res}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None,
                    help="an earlier checkout's src/repro_torch/csrc to ablate too")
    print(json.dumps(run(ap.parse_args().parent)))


if __name__ == "__main__":
    main()

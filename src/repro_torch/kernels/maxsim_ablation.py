"""What a chunk step of the dense rerank's tensor-core body costs, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.maxsim_ablation

Builds ``csrc/rerank_gather.cu`` (``csrc/maxsim_tc.cuh``) four ways into
``build/ablation/`` and times each (CUDA events, median of 10) at the
sharded route's shape: 256 queries x 32 tokens, k' = 4,096 candidates a
query drawn at random, Td = 80 rows of d = 128 with Poisson(67.5) valid
lengths, SQ8 codes over a store of 2,000 docs (in L2) and of 800,000 (in
device memory), fp32 tokens over 2,000 and 100,000.  The variants:

- ``as_built``;
- ``no_products``: the wgmmas left out (every other instruction kept);
- ``no_row_max``: the slice epilogue's max over the warp's row lanes left
  out;
- ``flush_128``: the tensor cores' sums restarted every 128 columns, not
  64 (one drain a slice at d = 128).

Only ``as_built`` computes the rerank; the others measure and nothing else.
Prints one JSON object with the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json

import numpy as np
import torch

from repro_torch.anns.quantization import sq8_quant
from repro_torch.kernels import build
from repro_torch.kernels._ablation import build_variants, card, time_ms
from repro_torch.kernels.maxsim import tc_image_floats

VARIANTS = {
    "as_built": {},
    "no_products": {"maxsim_tc.cuh": [
        ("wgmma_tf32(acc, A[buf][kk][1], dh, sd);", "(void)dh;"),
        ("wgmma_tf32(acc, A[buf][kk][0], dl, 1);", "(void)dl;"),
        ("wgmma_tf32(acc, A[buf][kk][0], dh, 1);", "(void)dh;"),
        ("wgmma_tf32(acc, A[buf][kk][0], dl, sd);", "(void)dl;")]},
    "no_row_max": {"maxsim_tc.cuh": [
        ("mx_max_over_rows<Tl::kV>(v, lane, w);",
         "for (int i_ = 0; i_ < Tl::kR; ++i_) w[i_] = v[i_];")]},
    "flush_128": {"tc_common.cuh": [("constexpr int kTcFlush = 2;",
                                     "constexpr int kTcFlush = 4;")]},
}
B, TQ, KP, TD, D = 256, 32, 4096, 80, 128


def store(m, sq8, gen, rng):
    dev = torch.device("cuda")
    lens = torch.as_tensor(np.clip(rng.poisson(67.5, m), 4, TD), device=dev)
    mask = torch.arange(TD, device=dev)[None] < lens[:, None]
    toks = torch.empty(m, TD, D, dtype=torch.int8 if sq8 else torch.float32, device=dev)
    scales = torch.empty(m, TD, device=dev) if sq8 else None
    for s in range(0, m, 25000):
        t = torch.nn.functional.normalize(
            torch.randn(min(25000, m - s), TD, D, generator=gen, device=dev), dim=-1)
        if sq8:
            toks[s:s + len(t)], scales[s:s + len(t)] = sq8_quant(t)
        else:
            toks[s:s + len(t)] = t
    return toks, mask, scales


def main():
    dev = torch.device("cuda")
    libs = {name: lib for (_, name), lib in build_variants(
        {("rerank_gather", name): edits for name, edits in VARIANTS.items()}).items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    q = torch.nn.functional.normalize(torch.randn(B, TQ, D, generator=gen, device=dev), dim=-1)
    qm = torch.ones(B, TQ, dtype=torch.bool, device=dev)
    img = torch.empty(tc_image_floats(B, TQ, D, 32), device=dev)
    out = torch.empty(B, KP, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    p, i = ctypes.c_void_p, ctypes.c_int
    res = {}
    for sq8, m in ((True, 2000), (True, 800_000), (False, 2000), (False, 100_000)):
        toks, mask, scales = store(m, sq8, gen, rng)
        cand = torch.randint(0, m, (B, KP), generator=gen, device=dev, dtype=torch.int32)
        for name, lib in libs.items():
            if sq8:
                fn = lib.rerank_gather_sq8
                fn.argtypes = [p] * 8 + [i] * 7 + [p]
                ptrs = (scales.data_ptr(),)
            else:
                fn = lib.rerank_gather_fp32
                fn.argtypes = [p] * 7 + [i] * 7 + [p]
                ptrs = ()
            args = (q.data_ptr(), qm.data_ptr(), cand.data_ptr(), toks.data_ptr(),
                    mask.data_ptr(), *ptrs, out.data_ptr(), img.data_ptr(), B, TQ, D, KP, TD,
                    m, 32, stream)
            build.check(lib, fn(*args), name)
            res[f"{'sq8' if sq8 else 'fp32'}_m{m}_{name}_ms"] = time_ms(lambda: fn(*args))
        del toks, mask, scales
        torch.cuda.empty_cache()
    print(json.dumps({"card": card(), "shape": f"B {B} x k' {KP}, Tq {TQ}, Td {TD}, d {D}",
                      **res}))


if __name__ == "__main__":
    main()

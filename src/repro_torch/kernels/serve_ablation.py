"""What the parts of the default route's two kernels cost, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.serve_ablation

Builds ``csrc/ivf_probe_scan.cu`` (its body ``csrc/scan_grouped.cuh``) and
``csrc/rerank_paged.cu`` several ways into ``build/ablation/`` (all nvcc
processes started together), each variant a copy of the sources with a few
lines edited, and times each (CUDA events, median of 10) through the port's
own wrappers at the served shapes:

- ``ivf_probe_scan``: 256 pooled queries of d' 2,048 against 2,048 SQ8
  lists of cap 1,024, list lengths drawn from a gamma distribution of mean
  390 and filled from the front; each query probes 32 distinct lists drawn
  with weights proportional to their lengths (large lists have many
  readers, as on the served index);
- ``query_fused`` (the one-launch IVF first stage, which runs the scan's
  body) on the same lists and probes, 256 queries of 32 unit tokens of d
  128, psi from the seed, k' 1,024: the whole call, and its psi-pool, its
  grouping (``group_only``: the scan's work items return at once), its scan
  and its selection each alone;
- ``rerank_paged_scores``: the same 256 queries of 32 tokens x 1,024
  candidates drawn from 800,000 docs of Poisson(67.5) tokens in [4, 80],
  fp32 pages of 16 tokens of d 128.

Only ``as_built`` computes the kernel's function; the others measure and
nothing else.
Prints one JSON object with the card's name and power limit, the shapes
and the spread of the probes (rows read probe by probe, distinct rows,
readers a list).
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.anns.quantization import sq8_quant
from repro_torch.core.model import Psi
from repro_torch.kernels import build, fused_psi, gather_scan, query_fused
from repro_torch.kernels._ablation import build_variants, card, time_ms

# source -> variant -> {file: [(old, new), ...]}
VARIANTS = {
    "ivf_probe_scan": {
        "as_built": {},
        # consumer warps a block and queries a warp (G = their product)
        "qw1_w4": {"scan_grouped.cuh": [("constexpr int kScanQW = 2;",
                                          "constexpr int kScanQW = 1;")]},
        "qw1_w8": {"scan_grouped.cuh": [
            ("constexpr int kScanWarps = 4;", "constexpr int kScanWarps = 8;"),
            ("constexpr int kScanQW = 2;", "constexpr int kScanQW = 1;")]},
        "qw2_w8": {"scan_grouped.cuh": [
            ("constexpr int kScanWarps = 4;", "constexpr int kScanWarps = 8;"),
            ("constexpr int kScanMinBlocks = 2;", "constexpr int kScanMinBlocks = 1;")]},
        # rows a consumer warp scores at once: 1 and 4
        "rows_1": {"scan_grouped.cuh": [("constexpr int kScanRows = 2;",
                                          "constexpr int kScanRows = 1;")]},
        "rows_4": {"scan_grouped.cuh": [
            ("constexpr int kScanRows = 2;", "constexpr int kScanRows = 4;"),
            ("constexpr int kScanMinBlocks = 2;", "constexpr int kScanMinBlocks = 1;")]},
        # the slots a work item: 128 and 512
        "range_128": {"scan_grouped.cuh": [("constexpr int kScanRange = 256;",
                                             "constexpr int kScanRange = 128;")]},
        "range_512": {"scan_grouped.cuh": [("constexpr int kScanRange = 256;",
                                             "constexpr int kScanRange = 512;")]},
        # the ring's depth: 2 and 4 windows
        "stages_2": {"scan_grouped.cuh": [("constexpr int kScanStages = 3;",
                                            "constexpr int kScanStages = 2;")]},
        "stages_4": {"scan_grouped.cuh": [("constexpr int kScanStages = 3;",
                                            "constexpr int kScanStages = 4;")]},
        # every code widened by the conversion instruction (the parent's),
        # or one code in four (it issues on another pipe)
        "i2f_widening": {"scan_grouped.cuh": [
            ("for (int k = 0; k < kPer; ++k) x[k] = s8_to_float(w[k / 4], k % 4);",
             "for (int k = 0; k < kPer; ++k)"
             " x[k] = (float)(int8_t)(((w[k / 4] ^ 0x80808080u) >> (8 * (k % 4))) & 0xff);")]},
        "i2f_byte3": {"scan_grouped.cuh": [
            ("for (int k = 0; k < kPer; ++k) x[k] = s8_to_float(w[k / 4], k % 4);",
             "for (int k = 0; k < kPer; ++k) x[k] = k % 4 == 3"
             " ? (float)(int8_t)((w[k / 4] ^ 0x80808080u) >> 24) : s8_to_float(w[k / 4], k % 4);")]},
        # no dot: each staged row scores a value of its own (walk, copies,
        # q in registers and the row's reads kept)
        "no_dots": {"scan_grouped.cuh": [
            ("rows_dots_reg<T, kScanRows, kScanQW>(rows, qr, D, lane, sc);",
             "for (int h = 0; h < kScanRows; ++h) for (int u = 0; u < kScanQW; ++u)"
             " sc[h][u] = qr[u][0] + (float)rows[h][lane];")]},
        # the warp sums left out (each lane's partial scores the row)
        "no_warp_sum": {"scan_grouped.cuh": [
            ("for (int u = 0; u < QW; ++u) s[h][u] = warp_sum(acc[h][u]);",
             "for (int u = 0; u < QW; ++u) s[h][u] = acc[h][u];")]},
        # the rows not copied (the dots read what is in the stage)
        "no_copies": {"scan_grouped.cuh": [
            ("if (STAGED) mbar_expect_tx(&full[st], (uint32_t)(__popc(wm) * rowbytes));",
             "if (STAGED) mbar_arrive(&full[st]);"),
            ("      if (STAGED && mine)\n", "      if (STAGED && mine && rowbytes < 0)\n")]},
        # the grouping alone: every work item returns at once
        "group_only": {"scan_grouped.cuh": [
            ("  if ((int)blockIdx.x >= *nchunks) return;\n"
             "  const ScanChunk ck = chunks[blockIdx.x];\n",
             "  if ((int)blockIdx.x >= 0) return;\n"
             "  const ScanChunk ck = chunks[blockIdx.x];\n")]},
    },
    "rerank_paged": {
        "as_built": {},
        # the CUDA-core kernel at the served widths (the parent's design)
        "cuda_cores": {"rerank_paged.cu": [("  plan[0] = N;\n", "  plan[0] = 0;\n")]},
        # two slots a consumer warp, not three
        "slots_2": {"maxsim_tc.cuh": [("constexpr int kMxPgSlots = 3;",
                                       "constexpr int kMxPgSlots = 2;")]},
        # the wgmmas left out (every other instruction kept)
        "no_products": {"maxsim_tc.cuh": [
            ("wgmma_tf32(acc, A[buf][kk][1], dh, sd);", "(void)dh;"),
            ("wgmma_tf32(acc, A[buf][kk][0], dl, 1);", "(void)dl;"),
            ("wgmma_tf32(acc, A[buf][kk][0], dh, 1);", "(void)dh;")]},
        # the producers mark each slice's rows but copy nothing
        "no_pages": {"maxsim_tc.cuh": [
            ("              mbar_expect_tx(&sfull[sw], (uint32_t)(nv * rowbytes));\n"
             "              bulk_copy_g2s(",
             "              mbar_arrive(&sfull[sw]);\n              if (nv < 0) bulk_copy_g2s(")]},
        # 128 candidates a block, not 512 (more block prologues)
        "rounds_16": {"rerank_paged.cu": [("constexpr int kPgRoundsPerBlock = 64;",
                                           "constexpr int kPgRoundsPerBlock = 16;")]},
    },
}
B, TQ, D, DP, NLIST, CAP, P, KP = 256, 32, 128, 2048, 2048, 1024, 32, 1024
M_DOCS, MEAN_LIST = 800_000, 390.0


def lists(gen, rng, dev):
    """SQ8 lists at the served widths, filled from the front."""
    counts = np.minimum(rng.gamma(2.0, MEAN_LIST / 2.0, NLIST).astype(np.int64), CAP)
    slot = torch.arange(CAP, device=dev)[None]
    live = slot < torch.as_tensor(counts, device=dev)[:, None]
    ids = torch.where(live, torch.arange(NLIST * CAP, device=dev).reshape(NLIST, CAP),
                      -1).int()
    codes = torch.empty(NLIST, CAP, DP, dtype=torch.int8, device=dev)
    scales = torch.empty(NLIST, CAP, device=dev)
    for s in range(0, NLIST, 256):
        v = torch.randn(256, CAP, DP, generator=gen, device=dev) * live[s:s + 256, :, None]
        codes[s:s + 256], scales[s:s + 256] = sq8_quant(v)
    return counts, ids, codes, scales


def pool(gen, rng, dev):
    """An fp32 page pool of M_DOCS docs, pages in doc order."""
    nt = torch.as_tensor(np.clip(rng.poisson(67.5, M_DOCS), 4, 80), device=dev).int()
    npg = (nt + 15) // 16
    first = torch.cumsum(npg, 0) - npg
    pmax = int(npg.max())
    table = first[:, None] + torch.arange(pmax, device=dev)[None]
    table = torch.where(torch.arange(pmax, device=dev)[None] < npg[:, None], table, -1).int()
    tok = torch.empty(int(npg.sum()), 16, D, device=dev)
    for s in range(0, tok.shape[0], 1 << 20):
        e = min(s + (1 << 20), tok.shape[0])
        tok[s:e] = torch.nn.functional.normalize(
            torch.randn(e - s, 16, D, generator=gen, device=dev), dim=-1)
    return tok, table, nt


def with_lib(name, lib, fn):
    """Call ``fn`` with the wrappers' library ``name`` swapped for ``lib``."""
    def run():
        saved = build._loaded.get(name)
        build._loaded[name] = lib
        try:
            return fn()
        finally:
            if saved is None:
                build._loaded.pop(name, None)
            else:
                build._loaded[name] = saved
    return run


def main():
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()
    dev = torch.device("cuda")
    libs = build_variants({(source, name): edits for source, vs in VARIANTS.items()
                           for name, edits in vs.items()})
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    counts, ids, codes, scales = lists(gen, rng, dev)
    w = torch.as_tensor(counts + 1.0, device=dev)
    probe = torch.multinomial(w[None].expand(B, NLIST), P, generator=gen).int().contiguous()
    psi_q = torch.nn.functional.normalize(torch.randn(B, DP, generator=gen, device=dev), dim=-1)
    readers = torch.bincount(probe.long().flatten(), minlength=NLIST)
    cnt = torch.as_tensor(counts, device=dev)
    spread = {"rows_probe_by_probe": int(cnt[probe.long()].sum()),
              "distinct_live_rows": int(cnt[readers > 0].sum()),
              "readers_max": int(readers.max()),
              "readers_mean": float(readers[readers > 0].float().mean())}
    res = {}
    for (source, name), lib in libs.items():
        if source == "ivf_probe_scan":
            res[f"{source}_{name}_ms"] = time_ms(with_lib(source, lib, lambda: (
                gather_scan.ivf_probe_scan(psi_q, probe, ids, codes, scales))))
    # query_fused and its phases apart, on pooled queries: the psi-pool, the
    # grouping (the scan's items returning at once), the scan, the selection
    q = torch.nn.functional.normalize(torch.randn(B, TQ, D, generator=gen, device=dev), dim=-1)
    qm = torch.ones(B, TQ, dtype=torch.bool, device=dev)
    psi = Psi.init(D, DP, torch.Generator().manual_seed(0), device=dev)
    w = (psi.dense.kernel, psi.dense.bias, psi.ln.scale, psi.ln.bias)
    lat = fused_psi.fused_psi_pool(q, qm, *w)
    scan = ("ivf_probe_scan", "as_built")
    strip = gather_scan.ivf_probe_scan(lat, probe, ids, codes, scales).reshape(B, P * CAP)
    out = (torch.empty(B, KP, device=dev), torch.empty(B, KP, dtype=torch.int32, device=dev))
    res["query_fused"] = {
        "as_built_ms": time_ms(lambda: query_fused.query_fused(
            q, qm, *w, probe, ids, codes, scales, kp=KP)),
        "pool_ms": time_ms(lambda: fused_psi.fused_psi_pool(q, qm, *w)),
        "group_ms": time_ms(with_lib("ivf_probe_scan", libs[("ivf_probe_scan", "group_only")],
                                     lambda: gather_scan.ivf_probe_scan(
                                         lat, probe, ids, codes, scales))),
        "scan_ms": time_ms(with_lib("ivf_probe_scan", libs[scan], lambda: (
            gather_scan.ivf_probe_scan(lat, probe, ids, codes, scales)))),
        "select_ms": time_ms(lambda: query_fused._select(
            build.library("query_fused"), strip, None, P * CAP, None, P * CAP, 0, out, B, KP,
            stream=build.stream_ptr(strip)))}
    del ids, codes, scales, strip
    torch.cuda.empty_cache()
    tok, table, nt = pool(gen, rng, dev)
    cand = torch.randint(0, M_DOCS, (B, KP), generator=gen, device=dev, dtype=torch.int32)
    for (source, name), lib in libs.items():
        if source == "rerank_paged":
            res[f"{source}_{name}_ms"] = time_ms(with_lib(source, lib, lambda: (
                gather_scan.rerank_paged_scores(q, qm, cand, tok, table, nt))))
    print(json.dumps({
        "card": card(),
        "shapes": {"ivf_probe_scan": f"B {B}, nprobe {P} of {NLIST} SQ8 lists of cap {CAP}, "
                                     f"d' {DP}",
                   "rerank_paged_scores": f"B {B} x k' {KP}, Tq {TQ}, d {D}, 16-token "
                                          f"fp32 pages of {M_DOCS} docs"},
        "probes": spread, **res}))


if __name__ == "__main__":
    main()

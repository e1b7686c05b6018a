"""What the parts of the residual tier's kernels cost, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.residual_ablation

Builds ``csrc/query_fused.cu`` (``query_fused_res``),
``csrc/ivf_probe_res_scan.cu`` and ``csrc/rerank_paged_res.cu`` several
ways into ``build/ablation/`` (all nvcc processes started together), each
variant a copy of the sources with a few lines edited, and times each
(CUDA events, median of 10) through the port's own wrappers at the served
shapes:

- ``query_fused_res`` and ``ivf_probe_res_scan``: 256 queries x 32 tokens,
  d 128, 2,048 residual lists of cap 1,024, d' 2,048 at 4 bits, list
  lengths drawn from a gamma distribution of mean 390 and filled from the
  front, 32 distinct lists a query drawn with weights proportional to their
  lengths (large lists have many readers, as on the served index), k'
  1,024;
- ``rerank_paged_res_scores``: the same queries x 1,024 candidates drawn
  from 800,000 docs of Poisson(67.5) tokens in [4, 80], 16-token pages of
  64 B of codes and 16 centroid ids, a codec of 256 centroids.

The variants of each kernel are in ``VARIANTS`` (file: edits); only
``as_built`` computes the kernel's function, the others measure and
nothing else; ``ivf_probe_res_scan``'s variants time the grouped scan's
designs (``product_table``: design (ii)), its queries a work item, pipes,
rows at once, stages and slots a work item.  ``select`` times the one-launch
kernel's selection alone, over the same probes' strip.  Prints one JSON
object with the card's name and power limit and the probes' spread.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from repro_torch.core.model import Psi
from repro_torch.kernels import build, gather_scan, query_fused
from repro_torch.kernels._ablation import build_variants, card, time_ms

# source -> variant -> {file: [(old, new), ...]}
VARIANTS = {
    "query_fused": {
        "as_built": {},
        # the latent read and the selection: no list is walked
        "pool_only": {"query_fused.cu": [
            ("res_scan<BITS, WHOLE>(probe + (size_t)b * P, P, 1,",
             "res_scan<BITS, WHOLE>(probe + (size_t)b * P, 0, 1,")]},
        # the live rows gathered and written, no chunk scored
        "walk_only": {"residual.cuh": [
            ("res_score_rows<BITS, WHOLE>(codes, e_row, n, q, values, D, T, acc);",
             "(void)values;")]},
        # the table of q[k] values[k][l] not built
        "no_table": {"residual.cuh": [
            ("for (int kk = tid; kk < nk; kk += kResThreads) {\n      const int k = k0 + kk;",
             "for (int kk = tid; kk < 0; kk += kResThreads) {\n      const int k = k0 + kk;")]},
        # each code's lookup replaced by a shift of its word (loads, adds and
        # warp sums kept)
        "no_lookups": {"residual.cuh": [
            ("part[h] += T[RC::code(w[h][t], j) * kResTileStride + res_col(wi * cpw + j)];",
             "part[h] += __uint_as_float(w[h][t] >> j);")]},
        # 1, 4 and 8 blocks a query
        "blocks_1": {"query_fused.cu": [("constexpr int kQfrBlocks = 2;",
                                         "constexpr int kQfrBlocks = 1;")]},
        "blocks_4": {"query_fused.cu": [("constexpr int kQfrBlocks = 2;",
                                         "constexpr int kQfrBlocks = 4;")]},
        "blocks_8": {"query_fused.cu": [("constexpr int kQfrBlocks = 2;",
                                         "constexpr int kQfrBlocks = 8;")]},
    },
    "ivf_probe_res_scan": {
        "as_built": {},
        # design (ii): one table of q[k] values[k][l] for a chunk of one
        # query (the only chunk whose table of every dim fits beside the
        # ring), built an item by the consumer warps, each pair and code a
        # lookup and an add; one pipe
        "product_table": {"ivf_probe_res_scan.cu": [
            ("constexpr int kRsPipes = 2;", "constexpr int kRsPipes = 1;"),
            ("constexpr int kRsQ = 4;", "constexpr int kRsQ = 1;"),
            ("          const float qk = WIDE ? __ldg(qg[u] + k) : qr[u][i * cpw + j];\n"
             "          part[h][u] += __fmul_rn(qk, v);",
             "          part[h][u] += WIDE ? __fmul_rn(__ldg(qg[u] + k), v) : v;"),
            ("    if constexpr (!WIDE) {\n#pragma unroll\n      for (int i = 0; i < kWords; ++i)",
             "    if constexpr (false) {\n#pragma unroll\n      for (int i = 0; i < kWords; ++i)"),
            ("  if constexpr (!WIDE) {                               // the table, once a block",
             "  if constexpr (false) {"),
            ("    const int* cp = pairs + ck.first;\n    const float* cent",
             "    const int* cp = pairs + ck.first;\n"
             "    if constexpr (!WIDE) {\n"
             "      res_consumers_sync();\n"
             "      const float* q0 = q + (size_t)(cp[0] / P) * D;\n"
             "      for (int k = threadIdx.x; k < D; k += kRsWarps * 32) {\n"
             "        const float4* v4 = reinterpret_cast<const float4*>(values + (size_t)k * L);\n"
             "        const int col = k + (k >> 5);\n"
             "        const float qk = __ldg(q0 + k);\n"
             "        for (int l4 = 0; l4 < L / 4; ++l4) {\n"
             "          const float4 v = __ldg(v4 + l4);\n"
             "          sm.Vs[(4 * l4 + 0) * stride + col] = qk * v.x;\n"
             "          sm.Vs[(4 * l4 + 1) * stride + col] = qk * v.y;\n"
             "          sm.Vs[(4 * l4 + 2) * stride + col] = qk * v.z;\n"
             "          sm.Vs[(4 * l4 + 3) * stride + col] = qk * v.w;\n"
             "        }\n"
             "      }\n"
             "      res_consumers_sync();\n"
             "    }\n"
             "    const float* cent")]},
        # queries a work item (every consumer warp holds them all): 2
        "q_2": {"ivf_probe_res_scan.cu": [("constexpr int kRsQ = 4;", "constexpr int kRsQ = 2;")]},
        # pipes a block: 1 and 3 (4 and 12 consumer warps)
        "pipes_1": {"ivf_probe_res_scan.cu": [("constexpr int kRsPipes = 2;",
                                               "constexpr int kRsPipes = 1;")]},
        "pipes_3": {"ivf_probe_res_scan.cu": [
            ("constexpr int kRsPipes = 2;", "constexpr int kRsPipes = 3;"),
            ("constexpr int kRsStageBytes = 16 * 1024;",
             "constexpr int kRsStageBytes = 8 * 1024;")]},
        # rows a consumer warp scores at once: 1 and 4
        "rows_1": {"ivf_probe_res_scan.cu": [("constexpr int kRsRows = 2;",
                                              "constexpr int kRsRows = 1;")]},
        "rows_4": {"ivf_probe_res_scan.cu": [("constexpr int kRsRows = 2;",
                                              "constexpr int kRsRows = 4;")]},
        # the ring's depth: 3 and 4 windows of 8 rows, and 1 of 16
        "stages_3_win_8": {"ivf_probe_res_scan.cu": [
            ("constexpr int kRsStages = 2;", "constexpr int kRsStages = 3;"),
            ("constexpr int kRsStageBytes = 16 * 1024;",
             "constexpr int kRsStageBytes = 8 * 1024;")]},
        "stages_4_win_8": {"ivf_probe_res_scan.cu": [
            ("constexpr int kRsStages = 2;", "constexpr int kRsStages = 4;"),
            ("constexpr int kRsStageBytes = 16 * 1024;",
             "constexpr int kRsStageBytes = 8 * 1024;")]},
        "stages_1": {"ivf_probe_res_scan.cu": [("constexpr int kRsStages = 2;",
                                                "constexpr int kRsStages = 1;")]},
        # the slots a work item: 128 and 512
        "range_128": {"ivf_probe_res_scan.cu": [("constexpr int kRsRange = 256;",
                                                 "constexpr int kRsRange = 128;")]},
        "range_512": {"ivf_probe_res_scan.cu": [("constexpr int kRsRange = 256;",
                                                 "constexpr int kRsRange = 512;")]},
        # no scoring: each tile sums a value of its row (the walk, the
        # copies, the table, q and the producer's sums kept)
        "no_dots": {"ivf_probe_res_scan.cu": [
            ("          const float v = res_tile_dots<BITS, WHOLE, WIDE, kRsRows, G>(\n"
             "              rows, t, qr, qg, sm.Vs, stride, values, D, lane, idx);",
             "          idx = lane / (32 / kSums);"
             " const float v = qr[0][0] + (float)rows[idx / G % kRsRows][lane];")]},
        # one warp_sum a (row, query), not the reduce-scatter (the same bits)
        "warp_sums": {"ivf_probe_res_scan.cu": [
            ("  return warp_sum_scatter(x, lane, idx);",
             "  idx = lane / (32 / N);\n  float r = 0.f;\n"
             "  for (int e = 0; e < N; ++e) {\n"
             "    const float y = warp_sum(x[e]);\n    if (e == idx) r = y;\n  }\n  return r;")]},
        # the table not built (the lookups read what is in shared memory)
        "no_table": {"ivf_probe_res_scan.cu": [
            ("for (int k = threadIdx.x; k < D; k += kRsWarps * 32) {",
             "for (int k = threadIdx.x; k < 0; k += kRsWarps * 32) {")]},
        # the rows not copied (the scoring reads what is in the stage)
        "no_copies": {"scan_grouped.cuh": [
            ("if (STAGED) mbar_expect_tx(&full[st], (uint32_t)(__popc(wm) * rowbytes));",
             "if (STAGED) mbar_arrive(&full[st]);"),
            ("      if (STAGED && mine)\n", "      if (STAGED && mine && rowbytes < 0)\n")]},
    },
    "rerank_paged_res": {
        "as_built": {},
        # the CUDA-core kernel at the served widths (the parent's design)
        "cuda_cores": {"rerank_paged_res.cu": [("  plan[0] = N;\n", "  plan[0] = 0;\n")]},
        # the wgmmas left out (every other instruction kept)
        "no_products": {"maxsim_tc.cuh": [
            ("wgmma_tf32(acc, A[buf][kk][1], dh, sd);", "(void)dh;"),
            ("wgmma_tf32(acc, A[buf][kk][0], dl, 1);", "(void)dl;"),
            ("wgmma_tf32(acc, A[buf][kk][0], dh, 1);", "(void)dh;")]},
        # the producers copy each page but do not decode it
        "no_decode": {"maxsim_tc.cuh": [
            ("      for (int k4 = lane; k4 < a.D / 4; k4 += 32) {\n        const int k = 4 * k4;",
             "      for (int k4 = lane; k4 < 0; k4 += 32) {\n        const int k = 4 * k4;")]},
        # the producers neither copy nor decode (the page walk and slots kept)
        "no_pages": {"maxsim_tc.cuh": [
            ("      for (int k4 = lane; k4 < a.D / 4; k4 += 32) {\n        const int k = 4 * k4;",
             "      for (int k4 = lane; k4 < 0; k4 += 32) {\n        const int k = 4 * k4;"),
            ("    if (nv > 0) {                                // warp-uniform",
             "    if (nv > 1000) {")]},
        # 128 candidates a block, not 512 (more block prologues)
        "rounds_16": {"rerank_paged_res.cu": [("constexpr int kResRoundsPerBlock = 64;",
                                               "constexpr int kResRoundsPerBlock = 16;")]},
        # the producers' lookups replaced by the codes' bits (the rest kept)
        "decode_no_lookups": {"maxsim_tc.cuh": [
            ("            o.x = v0[((c4[i] >> (0 * BITS)) & (kLv - 1)) * a.vstride];",
             "            o.x = __uint_as_float(c4[i]);"),
            ("            o.y = v0[((c4[i] >> (1 * BITS)) & (kLv - 1)) * a.vstride + 1];",
             "            o.y = __uint_as_float(c4[i] >> 1);"),
            ("            o.z = v0[((c4[i] >> (2 * BITS)) & (kLv - 1)) * a.vstride + 2];",
             "            o.z = __uint_as_float(c4[i] >> 2);"),
            ("            o.w = v0[((c4[i] >> (3 * BITS)) & (kLv - 1)) * a.vstride + 3];",
             "            o.w = __uint_as_float(c4[i] >> 3);")]},
        # the epilogue without the rows' q . centroid
        "no_centroid_part": {"maxsim_tc.cuh": [
            ("if (ok[0]) x0 = tot[4 * j + c] + (c ? q0.y : q0.x);",
             "if (ok[0]) x0 = tot[4 * j + c];"),
            ("if (ok[1]) x1 = tot[4 * j + 2 + c] + (c ? q1.y : q1.x);",
             "if (ok[1]) x1 = tot[4 * j + 2 + c];")]},
        # the tensor cores' sums restarted every 128 columns, not 64 (one
        # drain a slice at d = 128)
        "flush_128": {"tc_common.cuh": [("constexpr int kTcFlush = 2;",
                                         "constexpr int kTcFlush = 4;")]},
    },
}
B, TQ, D, DP, NLIST, CAP, P, KP, BITS = 256, 32, 128, 2048, 2048, 1024, 32, 1024, 4
M_DOCS, NCENT, MEAN_LIST = 800_000, 256, 390.0


def lists(gen, rng, dev):
    """Residual lists at the served widths, filled from the front."""
    counts = np.minimum(rng.gamma(2.0, MEAN_LIST / 2.0, NLIST).astype(np.int64), CAP)
    slot = torch.arange(CAP, device=dev)[None]
    live = slot < torch.as_tensor(counts, device=dev)[:, None]
    ids = torch.where(live, torch.arange(NLIST * CAP, device=dev).reshape(NLIST, CAP),
                      -1).int()
    codes = torch.randint(0, 256, (NLIST, CAP, DP * BITS // 8), generator=gen, device=dev,
                          dtype=torch.uint8) * live[..., None].to(torch.uint8)
    cent = torch.randn(NLIST, DP, generator=gen, device=dev) * 0.05
    values = (torch.randn(DP, 1 << BITS, generator=gen, device=dev) * 0.02).sort(1).values
    return ids, codes, cent, values


def pages(gen, rng, dev):
    """A compressed page pool of M_DOCS docs, pages in doc order."""
    nt = torch.as_tensor(np.clip(rng.poisson(67.5, M_DOCS), 4, 80), device=dev).int()
    npg = (nt + 15) // 16
    first = torch.cumsum(npg, 0) - npg
    pmax = int(npg.max())
    table = first[:, None] + torch.arange(pmax, device=dev)[None]
    table = torch.where(torch.arange(pmax, device=dev)[None] < npg[:, None], table, -1).int()
    n_pages = int(npg.sum())
    cent_pages = torch.randint(0, NCENT, (n_pages, 16), generator=gen, device=dev,
                               dtype=torch.int32)
    code_pages = torch.randint(0, 256, (n_pages, 16, D * BITS // 8), generator=gen,
                               device=dev, dtype=torch.uint8)
    centroids = torch.nn.functional.normalize(torch.randn(NCENT, D, generator=gen, device=dev),
                                              dim=-1)
    values = (torch.randn(D, 1 << BITS, generator=gen, device=dev) * 0.05).sort(1).values
    return cent_pages, code_pages, table, nt, centroids, values


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
    dev = torch.device("cuda")
    libs = build_variants({(source, name): edits for source, variants in VARIANTS.items()
                           for name, edits in variants.items()})
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    q = torch.nn.functional.normalize(torch.randn(B, TQ, D, generator=gen, device=dev), dim=-1)
    qm = torch.ones(B, TQ, dtype=torch.bool, device=dev)
    psi = Psi.init(D, DP, torch.Generator().manual_seed(0), device=dev)
    w = (psi.dense.kernel, psi.dense.bias, psi.ln.scale, psi.ln.bias)
    lst = lists(gen, rng, dev)
    # 32 distinct lists a query, drawn with weights proportional to their
    # lengths (large lists have many readers, as on the served index)
    counts = (lst[0] >= 0).sum(1)
    probe = torch.multinomial((counts + 1.0)[None].expand(B, NLIST), P,
                              generator=gen).int().contiguous()
    rows = int((lst[0][probe.long()] >= 0).sum()) / B
    readers = torch.bincount(probe.long().flatten(), minlength=NLIST)
    spread = {"rows_probe_by_probe": int(counts[probe.long()].sum()),
              "distinct_live_rows": int(counts[readers > 0].sum()),
              "readers_max": int(readers.max()),
              "readers_mean": float(readers[readers > 0].float().mean())}
    psi_q = torch.nn.functional.normalize(torch.randn(B, DP, generator=gen, device=dev), dim=-1)
    res = {}
    for (source, name), lib in libs.items():
        if source == "query_fused":
            # on a pooled latent, as the route calls it
            fn = with_lib(source, lib, lambda: query_fused.query_fused_res(
                q, qm, *w, probe, *lst, kp=KP, latent=psi_q))
        elif source == "ivf_probe_res_scan":
            fn = with_lib(source, lib, lambda: gather_scan.ivf_probe_res_scan(psi_q, probe, *lst))
        else:
            continue
        res[f"{source}_{name}_ms"] = time_ms(fn)
    strip = gather_scan.ivf_probe_res_scan(psi_q, probe, *lst).reshape(B, P * CAP)
    out = (torch.empty(B, KP, device=dev), torch.empty(B, KP, dtype=torch.int32, device=dev))
    sel_lib = libs[("query_fused", "as_built")]
    res["select_ms"] = time_ms(lambda: query_fused._select(
        sel_lib, strip, None, P * CAP, None, P * CAP, 0, out, B, KP,
        stream=build.stream_ptr(strip)))
    del lst, strip
    torch.cuda.empty_cache()
    pg = pages(gen, rng, dev)
    cand = torch.randint(0, M_DOCS, (B, KP), generator=gen, device=dev, dtype=torch.int32)
    for (source, name), lib in libs.items():
        if source != "rerank_paged_res":
            continue
        fn = with_lib(source, lib, lambda: gather_scan.rerank_paged_res_scores(
            q, qm, cand, pg[0], pg[1], pg[2], pg[3], pg[4], pg[5]))
        res[f"{source}_{name}_ms"] = time_ms(fn)
    print(json.dumps({
        "card": card(),
        "shapes": {"query_fused_res": f"B {B} x Tq {TQ}, d {D}, nprobe {P} of {NLIST} lists "
                                      f"of cap {CAP}, d' {DP} at {BITS} bits, {rows:.0f} "
                                      f"live rows a query, k' {KP}",
                   "rerank_paged_res_scores": f"B {B} x k' {KP}, Tq {TQ}, d {D}, 16-token "
                                              f"pages, {BITS} bits, {NCENT} centroids"},
        "probes": spread, **res}))


if __name__ == "__main__":
    main()

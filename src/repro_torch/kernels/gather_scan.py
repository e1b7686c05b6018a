"""Gather-at-source serving kernels: the IVF probe scan, the paged MaxSim
rerank and the dense-store rerank of the sharded path, over fp32/SQ8 data
and over the residual codec's packed codes (twins of
``repro/kernels/gather_scan.py``).

Each wrapper takes the plain version in :mod:`repro_torch.kernels.ref` for
tensors on the CPU and launches its CUDA kernel (``csrc/ivf_probe_scan.cu``,
``csrc/rerank_paged.cu``, ``csrc/rerank_gather.cu``,
``csrc/ivf_probe_res_scan.cu``, ``csrc/rerank_paged_res.cu``) for tensors on
a CUDA device; there is no fall-back between the two.
``<wrapper>.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.maxsim import tc_image_floats

_p = ctypes.c_void_p
_i = ctypes.c_int


def ivf_probe_scan(q, probe, ids, vecs, scales=None):
    """Score the probed IVF cluster lists without gathering them.

    q: (B, d) fp32; probe: (B, nprobe) int32 cluster ids; ids: (nlist, cap)
    int32 (-1 padded); vecs: (nlist, cap, d) fp32, or int8 codes with
    scales: (nlist, cap) fp32 -> (B, nprobe, cap) fp32, pad slots -inf (a
    probe outside [0, nlist): its whole strip).  On the card the (b, p)
    pairs are grouped by list first (csrc/ivf_probe_scan.cu; plain twin
    ``ref.probe_groups``), so each live row is read once for a chunk of the
    queries that probe its list; each score has the bits of
    ``query_fused``'s scorer."""
    if q.device.type == "cpu":
        return ref.ivf_scan_ref(q, probe, ids, vecs, scales)
    B, d = q.shape
    nlist, cap = ids.shape
    P = probe.shape[1]
    dev = q.device
    build.expect(q, "q", torch.float32, (B, d), dev)
    build.expect(probe, "probe", torch.int32, (B, P), dev)
    build.expect(ids, "ids", torch.int32, (nlist, cap), dev)
    out = torch.empty((B, P, cap), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = build.library("ivf_probe_scan")
    lib.ivf_probe_scan_scratch.argtypes = [_i] * 3
    lib.ivf_probe_scan_scratch.restype = ctypes.c_longlong
    scratch = torch.empty((lib.ivf_probe_scan_scratch(B, P, nlist),), dtype=torch.int32,
                          device=dev)
    if scales is not None:
        build.expect(vecs, "vecs", torch.int8, (nlist, cap, d), dev)
        build.expect(scales, "scales", torch.float32, (nlist, cap), dev)
        fn = lib.ivf_probe_scan_sq8
        fn.argtypes = [_p] * 7 + [_i] * 5 + [_p]
        err = fn(q.data_ptr(), probe.data_ptr(), ids.data_ptr(), vecs.data_ptr(),
                 scales.data_ptr(), out.data_ptr(), scratch.data_ptr(), B, P, cap, d, nlist,
                 build.stream_ptr(q))
    else:
        build.expect(vecs, "vecs", torch.float32, (nlist, cap, d), dev)
        fn = lib.ivf_probe_scan_fp32
        fn.argtypes = [_p] * 6 + [_i] * 5 + [_p]
        err = fn(q.data_ptr(), probe.data_ptr(), ids.data_ptr(), vecs.data_ptr(),
                 out.data_ptr(), scratch.data_ptr(), B, P, cap, d, nlist, build.stream_ptr(q))
    build.check(lib, err, "ivf_probe_scan")
    ivf_probe_scan.launches += 1
    return out


ivf_probe_scan.launches = 0


def rerank_paged_scores(q, q_mask, cand_ids, tok_pages, page_table, n_tokens):
    """Exact MaxSim of each query against its own candidates, streaming each
    candidate's token pages from the pool.

    q: (B, Tq, d) fp32; q_mask: (B, Tq) bool; cand_ids: (B, k') int32 (-1
    padded: pads score Tq_valid * NEG and are masked by the caller);
    tok_pages: (P, 16, d) fp32; page_table: (C, pmax) int32; n_tokens: (C,)
    int32 -> (B, k') fp32 raw pair scores.  On the card, where a block's
    shared memory holds the layout (csrc/rerank_paged.cu: rerank_paged_plan;
    the served widths), the dots run on the tensor cores, the TF32 split of
    the dense rerank, within ``ref.TF32_SPLIT_RTOL`` of the fp64 dot
    (``ref.tf32_split_rerank_paged`` emulates it); other widths take the
    CUDA-core kernel.  ``rerank_paged_scores.last_path`` names the path the
    last launch took: ``"tensor cores"`` or ``"cuda cores"``."""
    if q.device.type == "cpu":
        return ref.rerank_scores_paged_ref(q, q_mask, cand_ids, tok_pages,
                                           page_table, n_tokens)
    B, Tq, d = q.shape
    kp = cand_ids.shape[1]
    n_pages, page, _ = tok_pages.shape
    C, pmax = page_table.shape
    dev = q.device
    if page != 16 or B * -(-kp // 32) >= 2 ** 31:
        raise ValueError(f"rerank kernel takes 16-token pages and B ceil(k' / 32) < 2^31 "
                         f"(got page={page}, B={B}, k'={kp})")
    build.expect(q, "q", torch.float32, (B, Tq, d), dev)
    build.expect(q_mask, "q_mask", torch.bool, (B, Tq), dev)
    build.expect(cand_ids, "cand_ids", torch.int32, (B, kp), dev)
    build.expect(tok_pages, "tok_pages", torch.float32, (n_pages, page, d), dev,
                 align=16 if d % 4 == 0 else 4)
    build.expect(page_table, "page_table", torch.int32, (C, pmax), dev)
    build.expect(n_tokens, "n_tokens", torch.int32, (C,), dev)
    out = torch.empty((B, kp), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = build.library("rerank_paged")
    plan = (ctypes.c_int * 2)()
    fn = lib.rerank_paged_plan
    fn.argtypes = [_i] * 5 + [_p, ctypes.POINTER(ctypes.c_int)]
    build.check(lib, fn(B, Tq, d, kp, pmax, tok_pages.data_ptr(), plan),
                "rerank_paged_scores (plan)")
    N, Bc = plan[0], plan[1]
    scratch = [None] * 3
    if N:
        scratch = [torch.empty((tc_image_floats(Bc, Tq, d, N),), dtype=torch.float32,
                               device=dev),
                   torch.empty((Bc, kp, pmax), dtype=torch.int32, device=dev),
                   torch.empty((Bc, kp), dtype=torch.int32, device=dev)]
    fn = lib.rerank_paged_scores
    fn.argtypes = [_p] * 10 + [_i] * 6 + [ctypes.c_longlong] + [_i] * 2 + [_p]
    err = fn(q.data_ptr(), q_mask.data_ptr(), cand_ids.data_ptr(),
             tok_pages.data_ptr(), page_table.data_ptr(), n_tokens.data_ptr(),
             out.data_ptr(), *(None if t is None else t.data_ptr() for t in scratch),
             B, Tq, d, kp, pmax, C, n_pages, N, Bc, build.stream_ptr(q))
    build.check(lib, err, "rerank_paged_scores")
    rerank_paged_scores.launches += 1
    rerank_paged_scores.last_path = "tensor cores" if N else "cuda cores"
    return out


rerank_paged_scores.launches = 0
rerank_paged_scores.last_path = None


def rerank_gather_width(Tq: int) -> int:
    """The query tile of the dense rerank's tensor-core product: 32, 64 or
    128 tokens, the smallest that holds Tq (or rounds of 128)."""
    return 32 if Tq <= 32 else 64 if Tq <= 64 else 128


def rerank_gather_scores(q, q_mask, cand_ids, doc_tokens, doc_mask, doc_scales=None):
    """Exact MaxSim of each query against its own candidates in a dense
    (m, Td, d) token store, each candidate's slab read at the source.

    q: (B, Tq, d) fp32; q_mask: (B, Tq) bool; cand_ids: (B, k') int32 (-1
    padded: pads score doc 0 and are masked by the caller); doc_tokens: (m,
    Td, d) fp32, or int8 codes with doc_scales (m, Td) fp32 folded into the
    score rows; doc_mask: (m, Td) bool, any pattern -> (B, k') fp32 raw pair
    scores.  On the card the dots are the tensor cores' TF32 split
    (csrc/tc_common.cuh): an fp32 product's up to fp32 rounding."""
    if q.device.type == "cpu":
        return ref.rerank_scores_ref(q, q_mask, cand_ids, doc_tokens, doc_mask, doc_scales)
    B, Tq, d = q.shape
    kp = cand_ids.shape[1]
    m, Td, _ = doc_tokens.shape
    dev = q.device
    sq8 = doc_scales is not None
    if m == 0 or max(B, m * Td) >= 2 ** 31:
        raise ValueError(f"rerank_gather_scores kernel takes 0 < m and B, m Td < 2^31 "
                         f"(got B={B}, m={m}, Td={Td})")
    build.expect(q, "q", torch.float32, (B, Tq, d), dev, align=4)
    build.expect(q_mask, "q_mask", torch.bool, (B, Tq), dev, align=1)
    build.expect(cand_ids, "cand_ids", torch.int32, (B, kp), dev, align=4)
    build.expect(doc_tokens, "doc_tokens", torch.int8 if sq8 else torch.float32, (m, Td, d),
                 dev, align=1 if sq8 else 4)
    build.expect(doc_mask, "doc_mask", torch.bool, (m, Td), dev, align=1)
    if sq8:
        build.expect(doc_scales, "doc_scales", torch.float32, (m, Td), dev, align=4)
    out = torch.empty((B, kp), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    if Tq == 0:                                  # no query token: every sum is empty
        return out.zero_()
    N = rerank_gather_width(Tq)
    img = torch.empty((tc_image_floats(B, Tq, d, N),), dtype=torch.float32, device=dev)
    lib = build.library("rerank_gather")
    common = (q.data_ptr(), q_mask.data_ptr(), cand_ids.data_ptr(), doc_tokens.data_ptr(),
              doc_mask.data_ptr())
    if sq8:
        fn = lib.rerank_gather_sq8
        fn.argtypes = [_p] * 8 + [_i] * 7 + [_p]
        err = fn(*common, doc_scales.data_ptr(), out.data_ptr(), img.data_ptr(), B, Tq, d, kp,
                 Td, m, N, build.stream_ptr(q))
    else:
        fn = lib.rerank_gather_fp32
        fn.argtypes = [_p] * 7 + [_i] * 7 + [_p]
        err = fn(*common, out.data_ptr(), img.data_ptr(), B, Tq, d, kp, Td, m, N,
                 build.stream_ptr(q))
    build.check(lib, err, "rerank_gather_scores")
    rerank_gather_scores.launches += 1
    return out


rerank_gather_scores.launches = 0


def residual_bits(values: torch.Tensor, d: int) -> int:
    """The code width of a (d, L) residual values table; raises unless L is
    4 or 16 (2 or 4 bits) and a packed row is whole bytes (d even at 4 bits,
    a multiple of 4 at 2, as quantization.pack_codes packs them)."""
    L = values.shape[1]
    if L not in (4, 16) or values.shape[0] != d:
        raise ValueError(f"residual values must be (d={d}, 4 or 16), got {tuple(values.shape)}")
    bits = L.bit_length() - 1
    if d * bits % 8:
        raise ValueError(f"the residual kernels take packed rows of whole bytes: "
                         f"d={d} at {bits} bits is {d * bits / 8:g} bytes")
    return bits


def ivf_probe_res_scan(q, probe, ids, codes, centroids, values):
    """Score the probed residual IVF lists, decoding each row at the source.

    q: (B, d) fp32; probe: (B, nprobe) int32; ids: (nlist, cap) int32 (-1
    padded); codes: (nlist, cap, d * bits / 8) uint8, each row coded against
    its own list's centroid; centroids: (nlist, d) fp32; values: (d, 2^bits)
    fp32 -> (B, nprobe, cap) fp32, pad slots -inf.  On the card the (b, p)
    pairs are grouped by list first, as ``ivf_probe_scan`` groups them
    (csrc/ivf_probe_res_scan.cu; plain twin ``ref.res_scan_split``): each
    live row is read once for a chunk of up to 4 of the queries that probe
    its list, each code looked up once for all of them; each score has the
    bits of ``query_fused_res``'s scorer.  The kernel reads the codes a
    4-byte word at a time where a row is whole words, else a byte at a
    time."""
    if q.device.type == "cpu":
        return ref.ivf_scan_res_ref(q, probe, ids, codes, centroids, values)
    B, d = q.shape
    nlist, cap = ids.shape
    P = probe.shape[1]
    dev = q.device
    bits = residual_bits(values, d)
    build.expect(q, "q", torch.float32, (B, d), dev, align=4)
    build.expect(probe, "probe", torch.int32, (B, P), dev, align=4)
    build.expect(ids, "ids", torch.int32, (nlist, cap), dev, align=4)
    build.expect(codes, "codes", torch.uint8, (nlist, cap, d * bits // 8), dev, align=1)
    build.expect(centroids, "centroids", torch.float32, (nlist, d), dev, align=4)
    build.expect(values, "values", torch.float32, (d, 1 << bits), dev)
    if nlist * cap >= 2 ** 31:
        raise ValueError(f"ivf_probe_res_scan kernel takes nlist * cap < 2^31 slots, "
                         f"got {nlist} x {cap}")
    out = torch.empty((B, P, cap), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = build.library("ivf_probe_res_scan")
    lib.ivf_probe_res_scan_scratch.argtypes = [_i] * 3
    lib.ivf_probe_res_scan_scratch.restype = ctypes.c_longlong
    scratch = torch.empty((lib.ivf_probe_res_scan_scratch(B, P, nlist),), dtype=torch.int32,
                          device=dev)
    fn = lib.ivf_probe_res_scan
    fn.argtypes = [_p] * 8 + [_i] * 6 + [_p]
    err = fn(q.data_ptr(), probe.data_ptr(), ids.data_ptr(), codes.data_ptr(),
             centroids.data_ptr(), values.data_ptr(), out.data_ptr(), scratch.data_ptr(), B, P,
             cap, d, nlist, bits, build.stream_ptr(q))
    build.check(lib, err, "ivf_probe_res_scan")
    ivf_probe_res_scan.launches += 1
    return out


ivf_probe_res_scan.launches = 0


def rerank_paged_res_scores(q, q_mask, cand_ids, cent_pages, code_pages, page_table,
                            n_tokens, centroids, values):
    """:func:`rerank_paged_scores` over compressed pages, decoded on the card.

    cent_pages: (P, 16) int32 centroid ids; code_pages: (P, 16, d * bits /
    8) uint8; centroids: (ncent, d), values: (d, 2^bits) fp32, the codec's
    tables; the rest as :func:`rerank_paged_scores` -> (B, k') fp32 raw pair
    scores.  On the card, where a block's shared memory holds the layout
    (csrc/rerank_paged_res.cu: rerank_paged_res_plan; the served widths),
    the dots run on the tensor cores: each token's residual part as the
    TF32 split of the dense rerank, plus a table of q_t . centroid, within
    ``ref.TF32_SPLIT_RTOL`` of the fp64 dot (``ref.tf32_split_rerank_res``
    emulates it); other widths take the CUDA-core kernel, which scores the
    host decoder's tokens.  ``rerank_paged_res_scores.last_path`` names the
    path the last launch took: ``"tensor cores"`` or ``"cuda cores"``."""
    if q.device.type == "cpu":
        return ref.rerank_scores_paged_res_ref(q, q_mask, cand_ids, cent_pages, code_pages,
                                               page_table, n_tokens, centroids, values)
    B, Tq, d = q.shape
    kp = cand_ids.shape[1]
    n_pages, page = cent_pages.shape
    C, pmax = page_table.shape
    ncent = centroids.shape[0]
    dev = q.device
    bits = residual_bits(values, d)
    if page != 16 or B * -(-kp // 32) >= 2 ** 31:
        raise ValueError(f"rerank kernel takes 16-token pages and B ceil(k' / 32) < 2^31 "
                         f"(got page={page}, B={B}, k'={kp})")
    build.expect(q, "q", torch.float32, (B, Tq, d), dev)
    build.expect(q_mask, "q_mask", torch.bool, (B, Tq), dev)
    build.expect(cand_ids, "cand_ids", torch.int32, (B, kp), dev)
    build.expect(cent_pages, "cent_pages", torch.int32, (n_pages, page), dev, align=4)
    build.expect(code_pages, "code_pages", torch.uint8, (n_pages, page, d * bits // 8), dev,
                 align=4)
    build.expect(page_table, "page_table", torch.int32, (C, pmax), dev)
    build.expect(n_tokens, "n_tokens", torch.int32, (C,), dev)
    build.expect(centroids, "centroids", torch.float32, (ncent, d), dev)
    build.expect(values, "values", torch.float32, (d, 1 << bits), dev, align=4)
    out = torch.empty((B, kp), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = build.library("rerank_paged_res")
    plan = (ctypes.c_int * 2)()
    fn = lib.rerank_paged_res_plan
    fn.argtypes = [_i] * 7 + [_p, _p, ctypes.POINTER(ctypes.c_int)]
    build.check(lib, fn(B, Tq, d, kp, pmax, ncent, bits, cent_pages.data_ptr(),
                        code_pages.data_ptr(), plan), "rerank_paged_res_scores (plan)")
    N, Bc = plan[0], plan[1]
    scratch = [None] * 4
    if N:
        scratch = [torch.empty((tc_image_floats(Bc, Tq, d, N),), dtype=torch.float32,
                               device=dev),
                   torch.empty((Bc, ncent, N + 2), dtype=torch.float32, device=dev),
                   torch.empty((Bc, kp, pmax), dtype=torch.int32, device=dev),
                   torch.empty((Bc, kp), dtype=torch.int32, device=dev)]
    fn = lib.rerank_paged_res_scores
    fn.argtypes = [_p] * 14 + [_i] * 6 + [ctypes.c_longlong] + [_i] * 4 + [_p]
    err = fn(q.data_ptr(), q_mask.data_ptr(), cand_ids.data_ptr(), cent_pages.data_ptr(),
             code_pages.data_ptr(), page_table.data_ptr(), n_tokens.data_ptr(),
             centroids.data_ptr(), values.data_ptr(), out.data_ptr(),
             *(None if t is None else t.data_ptr() for t in scratch), B, Tq, d, kp, pmax,
             C, n_pages, ncent, bits, N, Bc, build.stream_ptr(q))
    build.check(lib, err, "rerank_paged_res_scores")
    rerank_paged_res_scores.launches += 1
    rerank_paged_res_scores.last_path = "tensor cores" if N else "cuda cores"
    return out


rerank_paged_res_scores.launches = 0
rerank_paged_res_scores.last_path = None

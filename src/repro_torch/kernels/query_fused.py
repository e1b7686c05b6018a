"""One-launch first stages (twin of ``repro/kernels/query_fused.py``; CUDA
kernels in ``csrc/query_fused.cu``).

``query_fused``: IVF probe scan + top-k' of each pooled query, the probed
strip's scores through device memory, the scan grouped by list
(``ivf_probe_scan``'s body) and an exact selection (four CUDA launches a
call, any k'); ``query_fused_res`` the same over residual lists (two
launches a call).  Both take the pooled latent (``latent=``) that the
route's probe selection computed, so a search pools once; given tokens
alone (the JAX signature) they pool first with ``fused_psi_pool``.
``mips_topk``: dense latent scan + top-k', fp32 or SQ8 rows, the product on
the tensor cores (``csrc/tc_scan.cuh``) and the selection in device memory
(``csrc/select.cuh``), for any k' (see the function).  All order the top-k
by score descending, then flat position ascending, so the ids equal a
stable top-k over the flat strip.  CPU tensors take the plain versions in
:mod:`repro_torch.kernels.ref`; CUDA tensors launch the kernels or raise.
``<wrapper>.launches`` counts calls that launched.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.fused_psi import fused_psi_pool
from repro_torch.kernels.gather_scan import residual_bits
from repro_torch.kernels.maxsim import tc_image_floats as _image_floats

_p = ctypes.c_void_p
_i = ctypes.c_int
_ll = ctypes.c_longlong


def _check_kp(kp: int, what: str) -> None:
    if kp < 1:
        raise ValueError(f"{what} kernel takes kp >= 1, got kp={kp}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _strip(B: int, P: int, cap: int, kp: int, dev):
    """Device memory of the one-launch IVF kernels: the (B, P cap) strip of
    probed scores and the selection's (B, kp) keys."""
    return (torch.empty((B, P * cap), dtype=torch.float32, device=dev),
            torch.empty((B, kp), dtype=torch.int64, device=dev))


def _latent(latent, q_tokens, q_mask, kernel, bias, ln_scale, ln_bias, eps):
    """The pooled queries (B, d') the one-launch kernels score: ``latent``
    as given (the route's probe selection computed it), else the psi-pool
    kernel's."""
    if latent is None:
        return fused_psi_pool(q_tokens, q_mask, kernel, bias, ln_scale, ln_bias, eps)
    build.expect(latent, "latent", torch.float32, (q_tokens.shape[0], kernel.shape[1]),
                 q_tokens.device, align=4)
    return latent


def query_fused(q_tokens, q_mask, kernel, bias, ln_scale, ln_bias, probe, ids,
                vecs, scales=None, *, kp: int, eps: float = 1e-5,
                chunk: int | None = None, latent=None):
    """Pooled psi(X), the probed lists' scores and their top-kp.

    q_tokens: (B, Tq, d) fp32; q_mask: (B, Tq) bool or None; kernel, bias,
    ln_scale, ln_bias: psi's weights (d, d') / (d',); probe: (B, nprobe)
    int32 cluster ids; ids: (nlist, cap) int32, -1 padded; vecs: (nlist,
    cap, d') fp32, or int8 codes with scales (nlist, cap); latent: (B, d')
    the pooled queries, or None to pool here -> (scores (B, kp) fp32, ids
    (B, kp) int32), short rows padded with (-inf, -1).  The kernel takes any
    kp >= 1; ``chunk`` bounds the plain version's gather (query rows at a
    time) and the kernel ignores it.  On the card the call scans the pooled
    queries with ``ivf_probe_scan``'s body and selects
    (``ref.query_fused_grouped`` is its plain twin), so it equals
    ``fused_psi_pool`` + ``ivf_probe_scan`` + a stable top-kp bit for bit."""
    if q_tokens.device.type == "cpu":
        return ref.query_fused_ref(q_tokens, q_mask, kernel, bias, ln_scale, ln_bias,
                                   probe, ids, vecs, scales, kp=kp, chunk=chunk,
                                   latent=latent)
    B = q_tokens.shape[0]
    nlist, cap = ids.shape
    P = probe.shape[1]
    dp = kernel.shape[1]
    dev = q_tokens.device
    _check_kp(kp, "query_fused")
    if P * cap >= 2 ** 31:
        raise ValueError(f"query_fused kernel takes nprobe * cap < 2^31, got {P * cap}")
    build.expect(probe, "probe", torch.int32, (B, P), dev, align=4)
    build.expect(ids, "ids", torch.int32, (nlist, cap), dev, align=4)
    if scales is not None:
        build.expect(vecs, "vecs", torch.int8, (nlist, cap, dp), dev, align=1)
        build.expect(scales, "scales", torch.float32, (nlist, cap), dev, align=4)
    else:
        build.expect(vecs, "vecs", torch.float32, (nlist, cap, dp), dev, align=4)
    out_s = torch.empty((B, kp), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, kp), dtype=torch.int32, device=dev)
    if B == 0:
        return out_s, out_i
    latent = _latent(latent, q_tokens, q_mask, kernel, bias, ln_scale, ln_bias, eps)
    lib = build.library("query_fused")
    strips, scratch = _strip(B, P, cap, kp, dev)
    # the scan's grouping of the (b, p) pairs by list
    lib.ivf_probe_scan_scratch.argtypes = [_i] * 3
    lib.ivf_probe_scan_scratch.restype = _ll
    groups = torch.empty((lib.ivf_probe_scan_scratch(B, P, nlist),), dtype=torch.int32,
                         device=dev)
    tail = (out_s.data_ptr(), out_i.data_ptr(), strips.data_ptr(), scratch.data_ptr(),
            groups.data_ptr(), B, dp, P, cap, nlist, kp, build.stream_ptr(q_tokens))
    lists = (latent.data_ptr(), probe.data_ptr(), ids.data_ptr(), vecs.data_ptr())
    if scales is not None:
        fn = lib.query_fused_sq8
        fn.argtypes = [_p] * 10 + [_i] * 6 + [_p]
        err = fn(*lists, scales.data_ptr(), *tail)
    else:
        fn = lib.query_fused_fp32
        fn.argtypes = [_p] * 9 + [_i] * 6 + [_p]
        err = fn(*lists, *tail)
    build.check(lib, err, "query_fused")
    query_fused.launches += 1
    return out_s, out_i


query_fused.launches = 0


def query_fused_res(q_tokens, q_mask, kernel, bias, ln_scale, ln_bias, probe, ids,
                    codes, centroids, values, *, kp: int, eps: float = 1e-5,
                    chunk: int | None = None, latent=None):
    """:func:`query_fused` over residual lists: codes (nlist, cap, d' * bits
    / 8) uint8 against each list's own centroid, centroids (nlist, d') and
    values (d', 2^bits) fp32 (rows of whole bytes, as pack_codes packs
    them).  The rows score as ``ivf_probe_res_scan`` scores them (the same
    row code), so the ids equal the psi-pool and that scan followed by the
    stable flat top-kp."""
    if q_tokens.device.type == "cpu":
        return ref.query_fused_res_ref(q_tokens, q_mask, kernel, bias, ln_scale, ln_bias,
                                       probe, ids, codes, centroids, values, kp=kp,
                                       chunk=chunk, latent=latent)
    B = q_tokens.shape[0]
    nlist, cap = ids.shape
    P = probe.shape[1]
    dp = kernel.shape[1]
    dev = q_tokens.device
    bits = residual_bits(values, dp)
    _check_kp(kp, "query_fused_res")
    if P * cap >= 2 ** 31:
        raise ValueError(f"query_fused_res kernel takes nprobe * cap < 2^31, got {P * cap}")
    build.expect(probe, "probe", torch.int32, (B, P), dev, align=4)
    build.expect(ids, "ids", torch.int32, (nlist, cap), dev, align=4)
    build.expect(codes, "codes", torch.uint8, (nlist, cap, dp * bits // 8), dev, align=1)
    build.expect(centroids, "centroids", torch.float32, (nlist, dp), dev, align=4)
    build.expect(values, "values", torch.float32, (dp, 1 << bits), dev)
    if nlist * cap >= 2 ** 31:
        raise ValueError(f"query_fused_res kernel takes nlist * cap < 2^31 slots, "
                         f"got {nlist} x {cap}")
    out_s = torch.empty((B, kp), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, kp), dtype=torch.int32, device=dev)
    if B == 0:
        return out_s, out_i
    latent = _latent(latent, q_tokens, q_mask, kernel, bias, ln_scale, ln_bias, eps)
    lib = build.library("query_fused")
    strips, scratch = _strip(B, P, cap, kp, dev)
    fn = lib.query_fused_res
    fn.argtypes = [_p] * 10 + [_i] * 7 + [_p]
    err = fn(latent.data_ptr(), probe.data_ptr(), ids.data_ptr(), codes.data_ptr(),
             centroids.data_ptr(), values.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
             strips.data_ptr(), scratch.data_ptr(), B, dp, P, cap, nlist, kp, bits,
             build.stream_ptr(q_tokens))
    build.check(lib, err, "query_fused_res")
    query_fused_res.launches += 1
    return out_s, out_i


query_fused_res.launches = 0


#: the dense scan's filtered pass samples every SAMPLE_STRIDE-th row for
#: its bound and keeps up to FILTER_SLACK x SAMPLE_STRIDE x kp candidates a
#: query; below FILTER_MIN_ROWS x kp rows the product stores every score
SAMPLE_STRIDE = 32
FILTER_SLACK = 4
FILTER_MIN_ROWS = 4 * SAMPLE_STRIDE
#: the tensor-core product's query tile (csrc/tc_scan.cuh)
TC_Q = 128
#: bytes of (query, row) scores the stored path holds at a time
STORE_BYTES = 2 ** 30


def tc_image_floats(B: int, D: int) -> int:
    """Floats of q's split image (csrc/tc_scan.cuh: tc_q_image)."""
    return _image_floats(1, B, D, TC_Q)


def _select(lib, s, p, ld, cnt, n, cap, out, B, kp, *, bound=None, overflow=None, stream):
    """topk_select over B queries' candidates into ``out`` (scores, ids) or,
    with ``bound``, each query's kp-th score."""
    scratch = None
    if bound is None:
        scratch = torch.empty((B, kp), dtype=torch.int64, device=s.device)
    fn = lib.topk_select
    fn.argtypes = [_p, _p, _ll, _p, _i, _i] + [_p] * 5 + [_i, _i, _p]
    err = fn(s.data_ptr(), _ptr(p), ld, _ptr(cnt), n, cap, _ptr(scratch),
             None if out is None else out[0].data_ptr(),
             None if out is None else out[1].data_ptr(), _ptr(bound), _ptr(overflow), B, kp,
             stream)
    build.check(lib, err, "mips_topk (selection)")


def _scan_store(lib, img_ptr, W, W_scales, valid, out, B, m, rs, stream):
    """The tensor-core product's store mode: out[b, r] = q[b] . W[r rs]."""
    fn = lib.mips_scan_store
    fn.argtypes = [_p] * 5 + [_ll] + [_i] * 5 + [_p]
    err = fn(img_ptr, W.data_ptr(), _ptr(W_scales), _ptr(valid), out.data_ptr(),
             out.shape[1], B, m, W.shape[1], rs, int(W_scales is not None), stream)
    build.check(lib, err, "mips_topk (product)")


def _mips_stored(lib, img, q, W, W_scales, valid, kp):
    """Every (query, row) score stored, TC_Q queries or more at a time
    (STORE_BYTES), and each query's top-kp selected from them."""
    B, D = q.shape
    m = W.shape[0]
    stream = build.stream_ptr(q)
    out = (torch.empty((B, kp), dtype=torch.float32, device=q.device),
           torch.empty((B, kp), dtype=torch.int32, device=q.device))
    Bc = max(TC_Q, STORE_BYTES // (4 * max(m, 1)) // TC_Q * TC_Q)
    sc = torch.empty((min(Bc, B), m), dtype=torch.float32, device=q.device)
    tile_bytes = tc_image_floats(TC_Q, D) * 4               # the image of one query tile
    for b0 in range(0, B, Bc):
        nb = min(Bc, B - b0)
        _scan_store(lib, img.data_ptr() + b0 // TC_Q * tile_bytes, W, W_scales, valid, sc,
                    nb, m, 1, stream)
        _select(lib, sc, None, m, None, m, 0, (out[0][b0:b0 + nb], out[1][b0:b0 + nb]), nb,
                kp, stream=stream)
    return out


def tc_scores(q, W, W_scales=None, valid=None, *, stride: int = 1):
    """The scores mips_topk's passes compute on the card, stored: (B,
    ceil(m / stride)) for rows 0, stride, 2 stride, ... of W (CUDA tensors
    only; no launch is counted).  The checks of the product use it: against
    an fp64 product, and the sample's scores against the full pass's."""
    B, dp = q.shape
    m = W.shape[0]
    build.expect(q, "q", torch.float32, (B, dp), q.device, align=4)
    ms = -(-m // stride)
    lib = build.library("query_fused")
    stream = build.stream_ptr(q)
    img = torch.empty((tc_image_floats(B, dp),), dtype=torch.float32, device=q.device)
    fn = lib.tc_q_image
    fn.argtypes = [_p, _p, _i, _i, _p]
    build.check(lib, fn(q.data_ptr(), img.data_ptr(), B, dp, stream), "tc_scores (q image)")
    out = torch.empty((B, ms), dtype=torch.float32, device=q.device)
    _scan_store(lib, img.data_ptr(), W, W_scales, valid, out, B, ms, stride, stream)
    return out


def mips_topk(q, W, W_scales=None, valid=None, *, kp: int, chunk: int | None = None):
    """Dense latent scan and its top-kp, without a (B, m) score matrix on
    large inputs.

    q: (B, d') fp32; W: (m, d') fp32, or int8 codes with W_scales (m,) fp32;
    valid: (m,) bool or None, invalid rows scored NEG with their positions
    kept -> (scores (B, kp) fp32, row positions (B, kp) int32), short rows
    padded with (-inf, -1).  The kernels take any kp >= 1; ``chunk`` bounds
    the plain version's score matrix (query rows at a time).

    On the card, q is split into its TF32 pieces once (csrc/tc_scan.cuh).
    Below FILTER_MIN_ROWS x kp rows the tensor-core product stores every
    score and csrc/select.cuh selects each query's top-kp.  Past it, the
    product over every SAMPLE_STRIDE-th row gives each query a bound its
    kp-th score cannot be below (the sample's kp-th, scored to the bit as
    the full pass scores those rows), the filtered pass scores every row
    and keeps those at or above the bound, and the selection takes their kp
    best.  A query with more candidates than its buffer sends the call to
    the stored path over all rows (``mips_topk.rescans`` counts them): one
    host read a call says which."""
    if q.device.type == "cpu":
        return ref.mips_topk_ref(q, W, W_scales, valid, kp=kp, chunk=chunk)
    B, dp = q.shape
    m = W.shape[0]
    dev = q.device
    _check_kp(kp, "mips_topk")
    if m >= 2 ** 31 - 1:
        raise ValueError(f"mips_topk kernel takes m < 2^31 - 1, got {m}")
    build.expect(q, "q", torch.float32, (B, dp), dev, align=4)
    sq8 = W_scales is not None
    build.expect(W, "W", torch.int8 if sq8 else torch.float32, (m, dp), dev, align=1)
    if sq8:
        build.expect(W_scales, "W_scales", torch.float32, (m,), dev, align=4)
    if valid is not None:
        build.expect(valid, "valid", torch.bool, (m,), dev, align=1)
    if B == 0:
        return (torch.empty((0, kp), dtype=torch.float32, device=dev),
                torch.empty((0, kp), dtype=torch.int32, device=dev))
    lib = build.library("query_fused")
    stream = build.stream_ptr(q)
    img = torch.empty((tc_image_floats(B, dp),), dtype=torch.float32, device=dev)
    fn = lib.tc_q_image
    fn.argtypes = [_p, _p, _i, _i, _p]
    build.check(lib, fn(q.data_ptr(), img.data_ptr(), B, dp, stream), "mips_topk (q image)")
    if m < FILTER_MIN_ROWS * kp:
        out = _mips_stored(lib, img, q, W, W_scales, valid, kp)
    else:
        ms = -(-m // SAMPLE_STRIDE)
        sample = torch.empty((B, ms), dtype=torch.float32, device=dev)
        _scan_store(lib, img.data_ptr(), W, W_scales, valid, sample, B, ms, SAMPLE_STRIDE,
                    stream)
        bound = torch.empty((B,), dtype=torch.float32, device=dev)
        _select(lib, sample, None, ms, None, ms, 0, None, B, kp, bound=bound, stream=stream)
        cap = min(m, FILTER_SLACK * SAMPLE_STRIDE * kp)
        cnt = torch.empty((B,), dtype=torch.int32, device=dev)
        buf_s = torch.empty((B, cap), dtype=torch.float32, device=dev)
        buf_p = torch.empty((B, cap), dtype=torch.int32, device=dev)
        fn = lib.mips_scan_filter
        fn.argtypes = [_p] * 8 + [_i] * 5 + [_p]
        err = fn(img.data_ptr(), W.data_ptr(), _ptr(W_scales), _ptr(valid), bound.data_ptr(),
                 cnt.data_ptr(), buf_s.data_ptr(), buf_p.data_ptr(), cap, B, m, dp, int(sq8),
                 stream)
        build.check(lib, err, "mips_topk (filter)")
        overflow = torch.zeros((1,), dtype=torch.int32, device=dev)
        out = (torch.empty((B, kp), dtype=torch.float32, device=dev),
               torch.empty((B, kp), dtype=torch.int32, device=dev))
        _select(lib, buf_s, buf_p, cap, cnt, 0, cap, out, B, kp, overflow=overflow,
                stream=stream)
        if int(overflow.item()):
            del buf_s, buf_p
            out = _mips_stored(lib, img, q, W, W_scales, valid, kp)
            mips_topk.rescans += 1
    mips_topk.launches += 1
    return out


mips_topk.launches = 0
mips_topk.rescans = 0

"""One-launch first stages (twin of ``repro/kernels/query_fused.py``; CUDA
kernels in ``csrc/query_fused.cu``).

``query_fused``: psi-pool + IVF probe scan + top-k' of each query, one CUDA
launch a call; ``query_fused_res`` the same over residual lists.  ``mips_topk``: dense latent scan + top-k', fp32 or SQ8 rows:
an exact pass (row splits, each a carried top-k', then their merge: two
launches) on small inputs, and on large ones that pass over a sample of the
rows, then a filtered pass and a selection (four launches and two memsets;
see the function).  Both order
the top-k by score descending, then flat position ascending, so the ids
equal a stable top-k over the flat strip.  CPU tensors take the plain
versions in :mod:`repro_torch.kernels.ref`; CUDA tensors launch the kernel
or raise.  ``<wrapper>.launches`` counts calls that launched.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.gather_scan import residual_bits

_p = ctypes.c_void_p
_i = ctypes.c_int
#: the largest k' the one-launch IVF kernels keep in shared memory
MAX_KP = 2048
#: the dense scan's: its exact pass keeps 8 queries' lists of k' (score,
#: position) pairs a block up to MAX_KP (128 KB at 2048) and 4 queries' above
#: (128 KB at 4096, the sharded path's default k' on one shard)
MAX_KP_DENSE = 4096
MAX_D_PRIME = 4096   # the psi-pool's register tile, as in fused_psi


def _check_kp(kp: int, what: str, limit: int = MAX_KP) -> None:
    if not 1 <= kp <= limit:
        raise ValueError(f"{what} kernel keeps 1 <= kp <= {limit} in shared "
                         f"memory, got kp={kp}")


def query_fused(q_tokens, q_mask, kernel, bias, ln_scale, ln_bias, probe, ids,
                vecs, scales=None, *, kp: int, eps: float = 1e-5,
                chunk: int | None = None):
    """Pooled psi(X), the probed lists' scores and their top-kp, in one launch.

    q_tokens: (B, Tq, d) fp32; q_mask: (B, Tq) bool or None; kernel, bias,
    ln_scale, ln_bias: psi's weights (d, d') / (d',); probe: (B, nprobe)
    int32 cluster ids; ids: (nlist, cap) int32, -1 padded; vecs: (nlist,
    cap, d') fp32, or int8 codes with scales (nlist, cap) -> (scores (B, kp)
    fp32, ids (B, kp) int32), short rows padded with (-inf, -1).  The kernel
    takes kp <= MAX_KP and d' <= MAX_D_PRIME; ``chunk`` bounds the plain
    version's gather (query rows at a time) and the kernel ignores it."""
    if q_tokens.device.type == "cpu":
        return ref.query_fused_ref(q_tokens, q_mask, kernel, bias, ln_scale, ln_bias,
                                   probe, ids, vecs, scales, kp=kp, chunk=chunk)
    B, Tq, d = q_tokens.shape
    nlist, cap = ids.shape
    P = probe.shape[1]
    dp = kernel.shape[1]
    dev = q_tokens.device
    _check_kp(kp, "query_fused")
    if dp > MAX_D_PRIME:
        raise ValueError(f"query_fused kernel takes d' <= {MAX_D_PRIME}, got {dp}")
    if P * cap >= 2 ** 31:
        raise ValueError(f"query_fused kernel takes nprobe * cap < 2^31, got {P * cap}")
    build.expect(q_tokens, "q_tokens", torch.float32, (B, Tq, d), dev, align=4)
    if q_mask is not None:
        build.expect(q_mask, "q_mask", torch.bool, (B, Tq), dev, align=1)
    build.expect(kernel, "kernel", torch.float32, (d, dp), dev, align=4)
    for name, t in (("bias", bias), ("ln_scale", ln_scale), ("ln_bias", ln_bias)):
        build.expect(t, name, torch.float32, (dp,), dev, align=4)
    build.expect(probe, "probe", torch.int32, (B, P), dev, align=4)
    build.expect(ids, "ids", torch.int32, (nlist, cap), dev, align=4)
    out_s = torch.empty((B, kp), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, kp), dtype=torch.int32, device=dev)
    if B == 0:
        return out_s, out_i
    lib = build.library("query_fused")
    common = (q_tokens.data_ptr(), None if q_mask is None else q_mask.data_ptr(),
              kernel.data_ptr(), bias.data_ptr(), ln_scale.data_ptr(),
              ln_bias.data_ptr(), probe.data_ptr(), ids.data_ptr(), vecs.data_ptr())
    shape = (B, Tq, d, dp, P, cap, nlist, kp)
    if scales is not None:
        build.expect(vecs, "vecs", torch.int8, (nlist, cap, dp), dev, align=1)
        build.expect(scales, "scales", torch.float32, (nlist, cap), dev, align=4)
        fn = lib.query_fused_sq8
        fn.argtypes = [_p] * 12 + [_i] * 8 + [ctypes.c_float, _p]
        err = fn(*common, scales.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), *shape,
                 float(eps), build.stream_ptr(q_tokens))
    else:
        build.expect(vecs, "vecs", torch.float32, (nlist, cap, dp), dev, align=4)
        fn = lib.query_fused_fp32
        fn.argtypes = [_p] * 11 + [_i] * 8 + [ctypes.c_float, _p]
        err = fn(*common, out_s.data_ptr(), out_i.data_ptr(), *shape, float(eps),
                 build.stream_ptr(q_tokens))
    build.check(lib, err, "query_fused")
    query_fused.launches += 1
    return out_s, out_i


query_fused.launches = 0


def query_fused_res(q_tokens, q_mask, kernel, bias, ln_scale, ln_bias, probe, ids,
                    codes, centroids, values, *, kp: int, eps: float = 1e-5,
                    chunk: int | None = None):
    """:func:`query_fused` over residual lists: codes (nlist, cap, d' * bits
    / 8) uint8 against each list's own centroid, centroids (nlist, d') and
    values (d', 2^bits) fp32, d' * bits / 8 a multiple of 4.  The rows score
    as ``ivf_probe_res_scan`` scores them (the same row code), so the ids
    equal that scan's followed by the stable flat top-kp."""
    if q_tokens.device.type == "cpu":
        return ref.query_fused_res_ref(q_tokens, q_mask, kernel, bias, ln_scale, ln_bias,
                                       probe, ids, codes, centroids, values, kp=kp,
                                       chunk=chunk)
    B, Tq, d = q_tokens.shape
    nlist, cap = ids.shape
    P = probe.shape[1]
    dp = kernel.shape[1]
    dev = q_tokens.device
    bits = residual_bits(values, dp, words=True)
    _check_kp(kp, "query_fused_res")
    if dp > MAX_D_PRIME:
        raise ValueError(f"query_fused_res kernel takes d' <= {MAX_D_PRIME}, got {dp}")
    if P * cap >= 2 ** 31:
        raise ValueError(f"query_fused_res kernel takes nprobe * cap < 2^31, got {P * cap}")
    build.expect(q_tokens, "q_tokens", torch.float32, (B, Tq, d), dev, align=4)
    if q_mask is not None:
        build.expect(q_mask, "q_mask", torch.bool, (B, Tq), dev, align=1)
    build.expect(kernel, "kernel", torch.float32, (d, dp), dev, align=4)
    for name, t in (("bias", bias), ("ln_scale", ln_scale), ("ln_bias", ln_bias)):
        build.expect(t, name, torch.float32, (dp,), dev, align=4)
    build.expect(probe, "probe", torch.int32, (B, P), dev, align=4)
    build.expect(ids, "ids", torch.int32, (nlist, cap), dev, align=4)
    build.expect(codes, "codes", torch.uint8, (nlist, cap, dp * bits // 8), dev, align=4)
    build.expect(centroids, "centroids", torch.float32, (nlist, dp), dev, align=4)
    build.expect(values, "values", torch.float32, (dp, 1 << bits), dev)
    if cap * (dp * bits // 8) >= 2 ** 31:
        raise ValueError(f"query_fused_res kernel takes a list under 2^31 bytes, "
                         f"got cap {cap} x {dp * bits // 8}")
    out_s = torch.empty((B, kp), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, kp), dtype=torch.int32, device=dev)
    if B == 0:
        return out_s, out_i
    lib = build.library("query_fused")
    fn = lib.query_fused_res
    fn.argtypes = [_p] * 13 + [_i] * 9 + [ctypes.c_float, _p]
    err = fn(q_tokens.data_ptr(), None if q_mask is None else q_mask.data_ptr(),
             kernel.data_ptr(), bias.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
             probe.data_ptr(), ids.data_ptr(), codes.data_ptr(), centroids.data_ptr(),
             values.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), B, Tq, d, dp, P, cap,
             nlist, kp, bits, float(eps), build.stream_ptr(q_tokens))
    build.check(lib, err, "query_fused_res")
    query_fused_res.launches += 1
    return out_s, out_i


query_fused_res.launches = 0


#: the dense scan's filtered pass samples every SAMPLE_STRIDE-th row for
#: its bound and keeps up to FILTER_SLACK x SAMPLE_STRIDE x kp candidates a
#: query; below FILTER_MIN_ROWS x kp rows the exact pass alone runs
SAMPLE_STRIDE = 32
FILTER_SLACK = 4
FILTER_MIN_ROWS = 4 * SAMPLE_STRIDE


def _mips_exact(lib, q, W, W_scales, valid, kp):
    """The exact pass: row splits, each a carried top-kp, then their merge."""
    B, dp = q.shape
    m = W.shape[0]
    # row splits: one wave of blocks (8 queries x a split each, 4 above
    # MAX_KP, one block an SM for its shared memory), and no split without a
    # 512-row tile
    tiles = max(1, -(-m // 512))
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    nq = 8 if kp <= MAX_KP else 4
    S = max(1, min(tiles, sms // -(-B // nq)))
    part_s = torch.empty((B, S, kp), dtype=torch.float32, device=q.device)
    part_p = torch.empty((B, S, kp), dtype=torch.int32, device=q.device)
    out_s = torch.empty((B, kp), dtype=torch.float32, device=q.device)
    out_i = torch.empty((B, kp), dtype=torch.int32, device=q.device)
    fn = lib.mips_topk_exact
    fn.argtypes = [_p] * 8 + [_i] * 6 + [_p]
    err = fn(q.data_ptr(), W.data_ptr(), W_scales.data_ptr() if W_scales is not None else None,
             None if valid is None else valid.data_ptr(), part_s.data_ptr(),
             part_p.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), B, m, dp, kp, S,
             int(W_scales is not None), build.stream_ptr(q))
    build.check(lib, err, "mips_topk")
    return out_s, out_i


def mips_topk(q, W, W_scales=None, valid=None, *, kp: int, chunk: int | None = None):
    """Dense latent scan and its top-kp without the (B, m) score matrix.

    q: (B, d') fp32; W: (m, d') fp32, or int8 codes with W_scales (m,) fp32;
    valid: (m,) bool or None, invalid rows scored NEG with their positions
    kept -> (scores (B, kp) fp32, row positions (B, kp) int32), short rows
    padded with (-inf, -1).  The kernel takes kp <= MAX_KP_DENSE; ``chunk`` bounds
    the plain version's score matrix (query rows at a time).

    On the card, past FILTER_MIN_ROWS x kp rows: the exact pass over every
    SAMPLE_STRIDE-th row gives each query a bound its kp-th score cannot be
    below, the filtered pass scores every row in large tiles and keeps
    those at or above the bound, and the kp best of those are the result.
    A query with more candidates than its buffer holds sends the call to
    the exact pass over all rows (``mips_topk.rescans`` counts them): one
    host read a call says which."""
    if q.device.type == "cpu":
        return ref.mips_topk_ref(q, W, W_scales, valid, kp=kp, chunk=chunk)
    B, dp = q.shape
    m = W.shape[0]
    dev = q.device
    _check_kp(kp, "mips_topk", MAX_KP_DENSE)
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
    if m < FILTER_MIN_ROWS * kp or -(-m // 128) > 65535:
        out = _mips_exact(lib, q, W, W_scales, valid, kp)
    else:
        sample = slice(None, None, SAMPLE_STRIDE)
        bound = _mips_exact(lib, q, W[sample].contiguous(),
                            None if W_scales is None else W_scales[sample].contiguous(),
                            None if valid is None else valid[sample].contiguous(), kp)[0]
        bound = bound[:, kp - 1].contiguous()
        cap = min(m, FILTER_SLACK * SAMPLE_STRIDE * kp)
        cnt = torch.empty((B,), dtype=torch.int32, device=dev)
        buf_s = torch.empty((B, cap), dtype=torch.float32, device=dev)
        buf_p = torch.empty((B, cap), dtype=torch.int32, device=dev)
        overflow = torch.empty((1,), dtype=torch.int32, device=dev)
        out = (torch.empty((B, kp), dtype=torch.float32, device=dev),
               torch.empty((B, kp), dtype=torch.int32, device=dev))
        fn = lib.mips_topk_filtered
        fn.argtypes = [_p] * 8 + [_i] + [_p] * 3 + [_i] * 5 + [_p]
        err = fn(q.data_ptr(), W.data_ptr(), W_scales.data_ptr() if sq8 else None,
                 None if valid is None else valid.data_ptr(), bound.data_ptr(),
                 cnt.data_ptr(), buf_s.data_ptr(), buf_p.data_ptr(), cap,
                 out[0].data_ptr(), out[1].data_ptr(), overflow.data_ptr(), B, m, dp, kp,
                 int(sq8), build.stream_ptr(q))
        build.check(lib, err, "mips_topk")
        if int(overflow.item()):
            out = _mips_exact(lib, q, W, W_scales, valid, kp)
            mips_topk.rescans += 1
    mips_topk.launches += 1
    return out


mips_topk.launches = 0
mips_topk.rescans = 0

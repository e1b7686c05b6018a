"""Plain PyTorch twins of the JAX oracles in ``repro/kernels/ref.py``.

They are the correctness contract of the CUDA kernels: the wrappers run them
for CPU tensors, the CPU tests hold them against the JAX oracles, and
``chip_smoke.py`` holds each kernel against them on the card.  The gathers
here materialise what the kernels stream; at the serving shapes the scan's
gather alone is (B, nprobe, cap, d') fp32 — tens of GB — so the scans, the
reranks, the pool, the one-launch first stages, the dense scan and the
batched SQ8 scan take ``chunk``: that many query rows at a time.  The dense
rerank over an (m, Td, d) store takes ``chunk`` candidates a query at a
time, and the token MaxSim twins, which materialise (n, m, T) scores,
``chunk`` docs.  The residual twins decode what they gather with
``quantization.residual_decode`` (one fp32 add an element, the kernels'
decode) and then score as the fp32 twins do.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.anns.base import pad_topk, stable_topk
from repro_torch.anns.quantization import ResidualCodec, residual_decode, unpack_codes

NEG = -1e30


def _chunks(n: int, chunk: int | None):
    step = max(1, chunk or n)
    return [(s, min(s + step, n)) for s in range(0, n, step)]


def token_maxsim_ref(x, doc_tokens, doc_mask, *, chunk: int | None = None):
    """g(x)_l = max over doc l's valid tokens c of <c, x>; NEG for a doc
    with no valid token.  x: (n, d); doc_tokens: (m, T, d); doc_mask: (m, T)
    bool -> (n, m) fp32."""
    out = []
    for s, e in _chunks(doc_tokens.shape[0], chunk):
        sc = torch.einsum("nd,mtd->nmt", x, doc_tokens[s:e].to(x.dtype))
        sc = torch.where(doc_mask[None, s:e].bool(), sc, NEG)
        out.append(sc.amax(-1))
    return torch.cat(out, 1) if out else x.new_empty((x.shape[0], 0))


def maxsim_scores_ref(q, q_mask, doc_tokens, doc_mask, *, chunk: int | None = None):
    """MaxSim(X, C_j) of every query against every doc: the per-token maxima
    summed over the valid query tokens.  q: (B, Tq, d) -> (B, m) fp32."""
    out = []
    for s, e in _chunks(doc_tokens.shape[0], chunk):
        sc = torch.einsum("bqd,mtd->bmqt", q, doc_tokens[s:e].to(q.dtype))
        sc = torch.where(doc_mask[None, s:e, None, :].bool(), sc, NEG)
        best = torch.where(q_mask[:, None, :].bool(), sc.amax(-1), 0.0)
        out.append(best.sum(-1))
    return torch.cat(out, 1) if out else q.new_empty((q.shape[0], 0))


def fused_psi_ref(x, kernel, bias, ln_scale, ln_bias, eps: float = 1e-5):
    """LN(GELU_tanh(x @ kernel + bias)), LayerNorm in fp32.  x: (n, d) -> (n, d')."""
    h = F.gelu(x @ kernel + bias, approximate="tanh").float()
    mu = h.mean(-1, keepdim=True)
    var = (h - mu).square().mean(-1, keepdim=True)
    y = (h - mu) * torch.rsqrt(var + eps) * ln_scale.float() + ln_bias.float()
    return y.to(x.dtype)


def psi_pool_ref(q_tokens, q_mask, kernel, bias, ln_scale, ln_bias,
                 eps: float = 1e-5, *, chunk: int | None = None):
    """Pooled query latent sum_t mask_t * psi(x_t) (eq. 5); the mask applies
    AFTER psi, so a masked token adds 0 although psi(0) != 0.
    q_tokens: (B, Tq, d) -> (B, d')."""
    out = []
    for s, e in _chunks(q_tokens.shape[0], chunk):
        y = fused_psi_ref(q_tokens[s:e], kernel, bias, ln_scale, ln_bias, eps)
        if q_mask is not None:
            y = y * q_mask[s:e, :, None].to(y.dtype)
        out.append(y.sum(-2))
    return torch.cat(out, 0)


def ivf_scan_ref(q, probe, ids, vecs, scales=None, *, chunk: int | None = None):
    """Gather-then-score IVF probe scan.  q: (B, d); probe: (B, nprobe);
    ids: (nlist, cap); vecs: (nlist, cap, d) fp32, or int8 with scales
    (nlist, cap) -> (B, nprobe, cap) fp32, pad slots -inf.  The SQ8 branch is
    the fp32 dot with the widened codes times the row scale, as in JAX."""
    probe = probe.long()
    out = []
    for s, e in _chunks(q.shape[0], chunk):
        pr = probe[s:e]
        gids = ids[pr]                                   # (b, P, cap)
        gv = vecs[pr]                                    # (b, P, cap, d)
        b, P, cap, d = gv.shape
        if scales is not None:
            sc = torch.einsum("bd,bnd->bn", q[s:e],
                              gv.reshape(b, P * cap, d).float())
            sc = sc.reshape(b, P, cap) * scales[pr].float()
        else:
            sc = torch.einsum("bd,bpcd->bpc", q[s:e], gv.to(q.dtype))
        out.append(torch.where(gids >= 0, sc, float("-inf")))
    return torch.cat(out, 0)


def probe_groups(probe, nlist: int, chunk: int = 8):
    """The IVF scan's grouping of (b, p) pairs by list (csrc/ivf_probe_scan.cu:
    scan_group_kernel), plainly: a count, a prefix sum and a scatter.  probe:
    (B, nprobe) -> (offsets (nlist + 2,) int64, pairs (B * nprobe,) int64 of
    flat b * nprobe + p, list by list, ascending within a list; probes
    outside [0, nlist) form group nlist; chunks (n, 3) int64 of (list, first
    pair, pairs), each list's group cut into runs of at most ``chunk``: the
    kernel's work items' queries).  The kernel orders a list's pairs as its
    atomics fall; the groups are the same."""
    flat = probe.reshape(-1).long()
    lst = torch.where((flat >= 0) & (flat < nlist), flat, nlist)
    counts = torch.bincount(lst, minlength=nlist + 1)
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    pairs = torch.sort(lst, stable=True).indices
    chunks = [(l, int(offsets[l]) + k, min(chunk, int(counts[l]) - k))
              for l in range(nlist + 1) for k in range(0, int(counts[l]), chunk)]
    return offsets, pairs, torch.tensor(chunks, dtype=torch.int64).reshape(-1, 3)


def ivf_scan_grouped(q, probe, ids, vecs, scales=None, *, chunk: int = 8):
    """:func:`ivf_scan_ref` through :func:`probe_groups`: each chunk of a
    list's pairs scores the list's rows together (the kernel's work items),
    out-of-range probes a strip of -inf.  Same shapes and values."""
    B, P = probe.shape
    nlist, cap = ids.shape
    _, pairs, chunks = probe_groups(probe, nlist, chunk)
    out = q.new_full((B * P, cap), float("-inf"))
    for l, first, n in chunks.tolist():
        if l == nlist:
            continue
        pr = pairs[first:first + n]
        one = torch.full((n, 1), l, dtype=probe.dtype, device=probe.device)
        out[pr] = ivf_scan_ref(q[pr // P], one, ids, vecs, scales)[:, 0]
    return out.reshape(B, P, cap)


def query_fused_grouped(q_tokens, q_mask, kernel, bias, ln_scale, ln_bias, probe, ids,
                        vecs, scales=None, *, kp: int, chunk: int = 8):
    """The one-launch first stage as the card runs it (the psi-pool, then
    csrc/query_fused.cu on its latent): the scan through
    :func:`ivf_scan_grouped` (the (b, p) pairs grouped by list, ``chunk`` a
    work item), the stable flat top-kp; ids
    (nlist, cap), pads -inf, out-of-range probes a strip of -inf.  Returns
    (scores (B, kp), ids (B, kp)) padded with (-inf, -1), as
    :func:`query_fused_ref`."""
    psi_q = psi_pool_ref(q_tokens, q_mask, kernel, bias, ln_scale, ln_bias)
    sc = ivf_scan_grouped(psi_q, probe, ids, vecs, scales, chunk=chunk)
    nlist = ids.shape[0]
    inr = (probe >= 0) & (probe < nlist)
    flat_i = torch.where(inr[..., None], ids[probe.long().clamp(0, nlist - 1)], -1)
    flat_s = sc.reshape(sc.shape[0], -1)
    top, pos = stable_topk(flat_s, min(kp, flat_s.shape[1]))
    return pad_topk(top, torch.gather(flat_i.reshape(sc.shape[0], -1), 1, pos), kp)


def ivf_scan_res_ref(q, probe, ids, codes, centroids, values, *,
                     chunk: int | None = None):
    """Decode-then-score IVF probe scan over packed residual lists, each row
    coded against its own list's centroid.  q: (B, d); probe: (B, nprobe);
    ids: (nlist, cap); codes: (nlist, cap, d * bits / 8) uint8; centroids:
    (nlist, d); values: (d, L) -> (B, nprobe, cap) fp32, pad slots -inf."""
    codec = ResidualCodec(centroids, None, values)
    probe = probe.long()
    out = []
    for s, e in _chunks(q.shape[0], chunk):
        pr = probe[s:e]
        gids = ids[pr]                                   # (b, P, cap)
        v = residual_decode(codec, pr[..., None].expand(gids.shape), codes[pr])
        sc = torch.einsum("bd,bpcd->bpc", q[s:e].float(), v)
        out.append(torch.where(gids >= 0, sc, float("-inf")))
    return torch.cat(out, 0)


def rerank_scores_ref(q, q_mask, cand_ids, doc_tokens, doc_mask, doc_scales=None, *,
                      chunk: int | None = None):
    """Exact MaxSim of each query against its own candidates in a dense
    store: gather the (B, k', Td, d) candidate slab and contract it.  SQ8
    tokens (int8 codes with doc_scales (m, Td)) score the fp32 dot with the
    widened codes times the token's scale.  Masked tokens score NEG, masked
    query tokens add 0; ``-1`` candidates score doc 0 and are masked by the
    caller.  q: (B, Tq, d); cand_ids: (B, k') -> (B, k') fp32.  ``chunk``
    bounds the slab: that many candidates a query at a time."""
    B, kp = cand_ids.shape
    safe_all = cand_ids.clamp_min(0).long()
    out = []
    for s, e in _chunks(kp, chunk):
        safe = safe_all[:, s:e]
        cd = doc_tokens[safe]                            # (B, c, Td, d)
        sc = torch.einsum("bqd,bmtd->bmqt", q, cd.to(q.dtype))
        if doc_scales is not None:
            sc = sc * doc_scales[safe].float()[:, :, None, :]
        sc = torch.where(doc_mask[safe].bool()[:, :, None, :], sc, NEG)
        best = torch.where(q_mask[:, None, :].bool(), sc.amax(-1), 0.0)   # (B, c, Tq)
        out.append(best.sum(-1))
    return torch.cat(out, 1) if out else q.new_empty((B, 0))


def rerank_scores_paged_ref(q, q_mask, cand_ids, tok_pages, page_table,
                            n_tokens, *, chunk: int | None = None):
    """Exact MaxSim of each query against its own candidates, read from the
    page pool (clamped page ids, positions >= n_tokens at NEG, query-masked
    sum).  ``-1`` candidates score Tq_valid * NEG; the caller masks them.
    q: (B, Tq, d); cand_ids: (B, k') -> (B, k') fp32."""
    return _rerank_pages(q, q_mask, cand_ids, page_table, n_tokens,
                         lambda table: tok_pages[table], chunk)


def rerank_scores_paged_res_ref(q, q_mask, cand_ids, cent_pages, code_pages,
                                page_table, n_tokens, centroids, values, *,
                                chunk: int | None = None):
    """:func:`rerank_scores_paged_ref` over compressed pages: cent_pages (P,
    page) int32 centroid ids, code_pages (P, page, db) uint8 and the codec
    tables centroids (ncent, d) / values (d, L); the candidates' pages are
    decoded as they are gathered (the JAX oracle decodes the whole pool
    first: the same values)."""
    codec = ResidualCodec(centroids, None, values)
    return _rerank_pages(q, q_mask, cand_ids, page_table, n_tokens,
                         lambda table: residual_decode(codec, cent_pages[table],
                                                       code_pages[table]), chunk)


def _rerank_pages(q, q_mask, cand_ids, page_table, n_tokens, read_pages, chunk):
    """The paged rerank twins' body; ``read_pages(table)`` -> the tokens of
    the (b, k', pmax) clamped page ids, (b, k', pmax, page, d) fp32."""
    out = []
    for s, e in _chunks(q.shape[0], chunk):
        cand = cand_ids[s:e].long()
        safe = cand.clamp_min(0)
        table = page_table[safe].long()                  # (b, k', pmax)
        nt = torch.where(cand >= 0, n_tokens[safe], 0)
        toks = read_pages(table.clamp_min(0))            # (b, k', pmax, page, d)
        b, kp, pmax, page, d = toks.shape
        toks = toks.reshape(b, kp, pmax * page, d)
        cm = torch.arange(pmax * page, device=cand.device) < nt[..., None]
        sc = torch.einsum("bqd,bmtd->bmqt", q[s:e], toks.to(q.dtype))
        sc = torch.where(cm[:, :, None, :], sc, NEG)
        best = sc.amax(-1)                               # (b, k', Tq)
        best = torch.where(q_mask[s:e, None, :], best, 0.0)
        out.append(best.sum(-1))
    return torch.cat(out, 0)


def mips_sq8_ref(q, codes, scales):
    """fp32 queries x int8 rows with per-row scales: the fp32 dot with the
    widened codes, then the scale.  q: (B, d); codes: (m, d) int8; scales:
    (m,) -> (B, m) fp32."""
    return (q @ codes.float().T) * scales.float()[None, :]


def mips_sq8_batched_ref(q, codes, scales, *, chunk: int | None = None):
    """Per-query SQ8 scan: every query scores its own rows.  q: (B, d);
    codes: (B, n, d) int8; scales: (B, n) -> (B, n) fp32.  ``chunk`` queries
    at a time bound the widened (chunk, n, d) copy of the codes."""
    out = []
    for s, e in _chunks(q.shape[0], chunk):
        sc = torch.einsum("bd,bnd->bn", q[s:e], codes[s:e].float())
        out.append(sc * scales[s:e].float())
    return torch.cat(out, 0) if out else q.new_empty((0, codes.shape[1]))


def _pooled(latent, q_tokens, q_mask, kernel, bias, ln_scale, ln_bias, s, e):
    """Rows [s, e) of the pooled queries: ``latent``'s when given, else
    :func:`psi_pool_ref` of those queries."""
    if latent is not None:
        return latent[s:e]
    return psi_pool_ref(q_tokens[s:e], None if q_mask is None else q_mask[s:e],
                        kernel, bias, ln_scale, ln_bias)


def query_fused_ref(q_tokens, q_mask, kernel, bias, ln_scale, ln_bias, probe,
                    ids, vecs, scales=None, *, kp: int, chunk: int | None = None,
                    latent=None):
    """The one-launch first stage as the composition it fuses: psi-pool,
    gather-then-score probe scan, stable flat top-kp over the (B, nprobe *
    cap) strip (earlier flat positions win ties).  Returns (scores (B, kp),
    ids (B, kp)) padded with (-inf, -1).  ``chunk``: query rows at a time
    of the pool and of the (chunk, nprobe, cap, d') gather; ``latent``:
    the pooled queries (B, d'), in place of the pool."""
    out_s, out_i = [], []
    for s, e in _chunks(q_tokens.shape[0], chunk):
        psi_q = _pooled(latent, q_tokens, q_mask, kernel, bias, ln_scale, ln_bias, s, e)
        sc = ivf_scan_ref(psi_q, probe[s:e], ids, vecs, scales)
        top, got = _flat_topk(sc, ids, probe[s:e], kp)
        out_s.append(top)
        out_i.append(got)
    return torch.cat(out_s, 0), torch.cat(out_i, 0)


def query_fused_res_ref(q_tokens, q_mask, kernel, bias, ln_scale, ln_bias, probe,
                        ids, codes, centroids, values, *, kp: int,
                        chunk: int | None = None, latent=None):
    """:func:`query_fused_ref` over residual lists (codes (nlist, cap, db)
    uint8 against each list's own centroid, values (d', L)): psi-pool (or
    ``latent``), the decode-then-score probe scan, stable flat top-kp (score
    desc, position asc), padded with (-inf, -1)."""
    out_s, out_i = [], []
    for s, e in _chunks(q_tokens.shape[0], chunk):
        psi_q = _pooled(latent, q_tokens, q_mask, kernel, bias, ln_scale, ln_bias, s, e)
        sc = ivf_scan_res_ref(psi_q, probe[s:e], ids, codes, centroids, values)
        top, got = _flat_topk(sc, ids, probe[s:e], kp)
        out_s.append(top)
        out_i.append(got)
    return torch.cat(out_s, 0), torch.cat(out_i, 0)


def _flat_topk(sc, ids, probe, kp):
    """Stable top-kp of a (b, nprobe, cap) score strip -> (scores, ids),
    padded with (-inf, -1)."""
    flat_s = sc.reshape(sc.shape[0], -1)
    flat_i = ids[probe.long()].reshape(sc.shape[0], -1)
    top, pos = stable_topk(flat_s, min(kp, flat_s.shape[1]))
    return pad_topk(top, torch.gather(flat_i, 1, pos), kp)


def mips_topk_ref(q, W, W_scales=None, valid=None, *, kp: int,
                  chunk: int | None = None):
    """Dense latent scan and top-kp: the full (B, m) score matrix, optional
    per-row scales, invalid rows at NEG with their positions kept, then a
    stable top-kp (lower position first on ties).  q: (B, d'); W: (m, d')
    fp32 or int8 -> (scores, int32 positions) (B, kp), short rows padded
    with (-inf, -1).  ``chunk``: query rows at a time of the score matrix."""
    out_s, out_i = [], []
    for s, e in _chunks(q.shape[0], chunk):
        sc = q[s:e] @ W.T.to(q.dtype)
        if W_scales is not None:
            sc = sc * W_scales[None, :].to(sc.dtype)
        if valid is not None:
            sc = torch.where(valid[None, :], sc, NEG)
        top, pos = stable_topk(sc, min(kp, sc.shape[1]))
        top, pos = pad_topk(top, pos.to(torch.int32), kp)
        out_s.append(top)
        out_i.append(pos)
    return torch.cat(out_s, 0), torch.cat(out_i, 0)


# -- the tensor-core product's arithmetic (csrc/tc_scan.cuh) ------------------

#: the card checks of the tensor-core product against an fp64 product: max
#: abs error <= TF32_SPLIT_RTOL x max(1, max |exact score|).  The CPU test
#: (tests/test_torch_query_fused.py::test_tf32_split_error) shows the split
#: with fp32 sums under it at d' = 2048 on the served query distribution.
TF32_SPLIT_RTOL = 1e-5


def tf32_rna(x):
    """cvt.rna.tf32.f32: fp32 ``x`` rounded to TF32 (10 explicit mantissa
    bits), to nearest with ties away from zero, kept as fp32 (the low 13
    bits zero)."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    sign = b & -2 ** 31
    mag = ((b & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    return (sign | mag).view(torch.float32)


def tf32_split_scores(q, W, W_scales=None, *, chunk: int | None = None):
    """The tensor-core product's scores as its split computes them: q = qh +
    ql and fp32 rows W = Wh + Wl (x = tf32_rna(x) + tf32_rna(x -
    tf32_rna(x))), Wl.qh + Wh.ql + Wh.qh (3xTF32); int8 rows are exact in
    TF32, W.ql + W.qh (q split only); then times the row scale.  Every piece
    product is exact.  ``chunk`` None: summed in fp64 and rounded once (the
    split's own error); ``chunk`` = 64: as the kernels sum, each chunk of
    that many columns in fp64 rounded to fp32, the chunks added in order in
    fp32.  q: (B, d); W: (m, d) -> (B, m) fp32."""
    qh = tf32_rna(q)
    ql = tf32_rna(q - qh)
    if W.dtype == torch.int8:
        pieces = [(ql, W.double()), (qh, W.double())]
    else:
        Wh = tf32_rna(W)
        pieces = [(qh, tf32_rna(W - Wh).double()), (ql, Wh.double()), (qh, Wh.double())]
    d = q.shape[1]
    step = chunk or d
    sc = None
    for k0 in range(0, d, step):
        part = sum(a[:, k0:k0 + step].double() @ b[:, k0:k0 + step].T for a, b in pieces)
        part = part.to(torch.float32)
        sc = part if sc is None else sc + part
    if sc is None:
        sc = q.new_zeros((q.shape[0], W.shape[0]))
    if W_scales is not None:
        sc = sc * W_scales[None, :].float()
    return sc


#: the psi kernel (csrc/fused_psi_pool.cu) against an fp64 psi: max abs
#: error <= PSI_SPLIT_RTOL x max(1, max |exact|), unpooled rows and pooled
#: queries alike.  tests/test_torch_psi.py shows tf32_split_psi under it
#: (the product's split, then GELU and LayerNorm in fp32, the pool's fp32
#: sums) at d' 256 to 4,096, d 16 to 128, Tq 1 to 80.
PSI_SPLIT_RTOL = 2e-6


def tf32_split_psi(x, kernel, bias, ln_scale, ln_bias, eps: float = 1e-5, *,
                   q_mask=None, chunk: int | None = 64):
    """The psi kernel's arithmetic on the card (csrc/psi.cuh), emulated: x W'
    as :func:`tf32_split_scores` sums it (x's rows and W''s columns split
    into TF32 pieces, ``chunk``-column sums added in fp32, 64 as the kernel
    sums), then bias, GELU and LayerNorm in fp32 as :func:`fused_psi_ref`
    (the kernel's GELU is x / (1 + exp(-2u)), its variance combines 256-column
    blocks' squared deviations by Chan's update, and it sums the pool in
    another order: fp32 rounding).  x: (n, d) -> (n, d'); x: (B, Tq, d) with ``q_mask`` (B, Tq)
    bool or None -> the pool sum_t mask_t psi(x_t), (B, d')."""
    pool = x.dim() == 3
    xs = x.reshape(-1, x.shape[-1])
    h = tf32_split_scores(xs, kernel.T.contiguous(), chunk=chunk) + bias
    h = F.gelu(h, approximate="tanh")
    mu = h.mean(-1, keepdim=True)
    var = (h - mu).square().mean(-1, keepdim=True)
    y = (h - mu) * torch.rsqrt(var + eps) * ln_scale + ln_bias
    if not pool:
        return y
    y = y.reshape(*x.shape[:2], -1)
    if q_mask is not None:
        y = y * q_mask[:, :, None].to(y.dtype)
    return y.sum(1)


def tf32_split_maxsim(x, doc_tokens, doc_mask, doc_scales=None, *, chunk: int | None = 64):
    """The token MaxSim body's arithmetic on the card (csrc/maxsim_tc.cuh),
    emulated: every dot of x's rows with the docs' token rows as
    :func:`tf32_split_scores` sums it (the split pieces; ``chunk``-column
    sums added in fp32, 64 as the kernel sums), times the token's scale
    (int8 codes with ``doc_scales`` (m, T)), masked tokens at NEG, then the
    max over each doc's tokens.  x: (n, d); doc_tokens: (m, T, d) fp32 or
    int8 -> (n, m) fp32."""
    m, T, d = doc_tokens.shape
    sc = tf32_split_scores(x, doc_tokens.reshape(m * T, d),
                           None if doc_scales is None else doc_scales.reshape(m * T),
                           chunk=chunk).reshape(x.shape[0], m, T)
    return torch.where(doc_mask[None].bool(), sc, NEG).amax(-1)


def tf32_split_rerank(q, q_mask, cand_ids, doc_tokens, doc_mask, doc_scales=None, *,
                      chunk: int | None = 64):
    """The dense rerank's arithmetic on the card, emulated: per query,
    :func:`tf32_split_maxsim` of its tokens against its own candidates'
    slabs (-1 clamped to doc 0), summed over its valid tokens.  q: (B, Tq,
    d); cand_ids: (B, k') -> (B, k') fp32."""
    out = []
    for b in range(q.shape[0]):
        c = cand_ids[b].clamp_min(0).long()
        g = tf32_split_maxsim(q[b], doc_tokens[c], doc_mask[c],
                              None if doc_scales is None else doc_scales[c], chunk=chunk)
        out.append(torch.where(q_mask[b][:, None].bool(), g, 0.0).sum(0))
    return torch.stack(out) if out else q.new_empty((0, cand_ids.shape[1]))


def tf32_split_rerank_paged(q, q_mask, cand_ids, tok_pages, page_table, n_tokens, *,
                            chunk: int | None = 64):
    """The paged fp32 rerank's tensor-core arithmetic on the card
    (csrc/rerank_paged.cu), emulated: :func:`tf32_split_rerank` over each
    doc's pages gathered into a dense (C, pmax x page, d) store (page ids
    clamped to the pool, positions >= n_tokens masked); a -1 candidate (or
    one past the slots) has no token and scores Tq_valid x NEG.  q: (B, Tq,
    d); cand_ids: (B, k') -> (B, k') fp32."""
    C, pmax = page_table.shape
    n_pages, page, d = tok_pages.shape
    toks = tok_pages[page_table.long().clamp(0, n_pages - 1)].reshape(C, pmax * page, d)
    toks = torch.cat([toks, toks.new_zeros((1, pmax * page, d))])
    pos = torch.arange(pmax * page, device=q.device)
    mask = torch.cat([pos[None] < n_tokens.long()[:, None],
                      torch.zeros((1, pmax * page), dtype=torch.bool, device=q.device)])
    cand = torch.where((cand_ids >= 0) & (cand_ids < C), cand_ids.long(), C)
    return tf32_split_rerank(q, q_mask, cand, toks, mask, chunk=chunk)


# -- the residual tier's arithmetic on the card (csrc/residual.cuh,
#    csrc/rerank_paged_res.cu) ------------------------------------------------

#: the residual scans' scorer walks d' in tiles of this many dims
RES_TILE_DIMS = 512


def _residual_part(values, packed):
    """values[k][code_k] of packed rows (..., db) -> (..., d) fp32."""
    idx = unpack_codes(packed, values.shape[1].bit_length() - 1)
    return values.float()[torch.arange(values.shape[0], device=packed.device), idx]


def res_scan_split(q, probe, ids, codes, centroids, values):
    """The residual scans' arithmetic on the card (residual.cuh: res_scan,
    shared by ivf_probe_res_scan and query_fused_res), emulated: a row of
    list c scores q . c (fp64, rounded to fp32: the kernel's one-warp fmaf
    dot differs by rounding) plus, tile of RES_TILE_DIMS dims by tile, the
    sum of the table entries fp32(q[k] * values[k][code_k]) (fp64 within
    the tile, rounded to fp32; the tiles added in fp32 in order), never the
    decoded row.  Pad slots -inf.  q: (B, d); probe: (B, nprobe) -> (B,
    nprobe, cap) fp32."""
    B, d = q.shape
    probe = probe.long()
    out = []
    for b in range(B):
        pr = probe[b]
        v = _residual_part(values, codes[pr])                  # (P, cap, d)
        t = (q[b].float() * v).double()                        # the table's entries
        acc = None
        for k0 in range(0, d, RES_TILE_DIMS):
            part = t[..., k0:k0 + RES_TILE_DIMS].sum(-1).float()
            acc = part if acc is None else acc + part
        qc = (centroids[pr].double() @ q[b].double()).float()  # (P,)
        sc = acc + qc[:, None]
        out.append(torch.where(ids[pr] >= 0, sc, float("-inf")))
    return torch.stack(out) if out else q.new_empty((0, probe.shape[1], ids.shape[1]))


def tf32_split_rerank_res(q, q_mask, cand_ids, cent_pages, code_pages, page_table, n_tokens,
                          centroids, values, *, chunk: int | None = 64):
    """The paged residual rerank's tensor-core arithmetic on the card
    (csrc/rerank_paged_res.cu), emulated: a token's dot with query token t
    is the table entry q_t . centroid (fp64 rounded to fp32; the kernel's
    fmaf chain differs by rounding) plus the residual part values[k][code_k]
    as :func:`tf32_split_scores` sums it (``chunk``-column sums added in
    fp32, 64 as the kernel sums), the two added in fp32; positions >=
    n_tokens at NEG (the walk stops at ceil(n_tokens / page) pages, page
    ids clamped to the pool, centroid ids to the table), the max over the
    candidate's positions, the sum over the query's valid tokens.  A -1
    candidate (or one past the slots) has no token and scores Tq_valid x
    NEG.  q: (B, Tq, d); cand_ids: (B, k') -> (B, k') fp32."""
    B, Tq, d = q.shape
    kp = cand_ids.shape[1]
    C, pmax = page_table.shape
    n_pages, page = cent_pages.shape
    out = []
    for b in range(B):
        cand = cand_ids[b].long()
        real = (cand >= 0) & (cand < C)
        safe = torch.where(real, cand, 0)
        nt = torch.where(real, n_tokens[safe].long(), 0)                    # (k',)
        table = page_table[safe].long().clamp(0, n_pages - 1)               # (k', pmax)
        v = _residual_part(values, code_pages[table])                       # (k', pmax, page, d)
        cid = cent_pages[table].long().clamp(0, centroids.shape[0] - 1)     # (k', pmax, page)
        part = tf32_split_scores(q[b], v.reshape(-1, d), chunk=chunk)       # (Tq, k' pmax page)
        qc = (q[b].double() @ centroids.double().T).float()                 # (Tq, ncent)
        sc = (part + qc[:, cid.reshape(-1)]).reshape(Tq, kp, pmax * page)
        pos = torch.arange(pmax * page, device=q.device)
        sc = torch.where((pos[None, :] < nt[:, None])[None], sc, NEG)
        best = sc.amax(-1)                                                  # (Tq, k')
        out.append(torch.where(q_mask[b][:, None].bool(), best, 0.0).sum(0))
    return torch.stack(out) if out else q.new_empty((0, kp))

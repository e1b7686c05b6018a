"""IVF index over the latent corpus (twin of ``repro/anns/ivf.py``).

Build: k-means coarse quantizer over the mean-centred latent rows; vectors
are packed into power-of-two capacity padded cluster lists, fp32, SQ8, or packed 2/4-bit
residuals against each list's own centroid (``residual_bits``; the codec of
:mod:`repro_torch.anns.quantization`, its tables the quantiles of the
valid rows' residuals).
Search (:func:`search_ivf`): one (B, nlist) centroid product, the top
``nprobe`` clusters, a scan of the probed lists and a flat top-k'.  The scan
is the gather-at-source probe-scan kernel
(:func:`repro_torch.kernels.gather_scan.ivf_probe_scan`, or
``ivf_probe_res_scan`` decoding residual lists at the source), or with
``use_fused_gather=False`` the legacy route: the probed lists gathered into
(B, nprobe, cap, d') and scored by the ``mips_sq8`` kernel's batched entry
(SQ8), a plain einsum (fp32), or decoded and scored plainly (residual: the
JAX package's decode-then-score route).  :func:`search_ivf_one_launch`
takes the query tokens and runs pool, scan and top-k' in the
``query_fused`` (or ``query_fused_res``) kernel.
Growth (:func:`extend_ivf`): new rows go to the frozen centroids and are
appended to their lists on the device, O(new rows); the lists equal the
JAX package's full re-pack bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.anns import kmeans as _kmeans
from repro_torch.anns.base import pad_topk, stable_topk
from repro_torch.anns.kmeans import kmeans
from repro_torch.anns.quantization import (
    ResidualCodec,
    pack_codes,
    residual_decode,
    residual_encode,
    residual_quantiles,
    sq8_quant,
    unpack_codes,
)
from repro_torch.core.pages import next_pow2
from repro_torch.kernels import ops, ref
from repro_torch.kernels.gather_scan import ivf_probe_res_scan, ivf_probe_scan

_PACK_ROWS = 65536   # rows quantized / copied at a time while packing
_RQ_COLS = 64        # residual columns sorted at a time for the quantile tables
_LEGACY_RES_ROWS = 8  # queries decoded at a time on the legacy residual scan
_RECODE_LISTS = 64    # residual lists whose re-encode table is built at a time


class IVFIndex(NamedTuple):
    centroids: torch.Tensor        # (nlist, d)
    ids: torch.Tensor              # (nlist, cap) int32, -1 padded
    vecs: torch.Tensor             # (nlist, cap, d) fp32, int8 codes when sq8, or
                                   # (nlist, cap, d*bits/8) uint8 packed residuals
    scales: torch.Tensor | None    # (nlist, cap) fp32 when sq8 else None
    counts: torch.Tensor           # (nlist,) int32
    mean: torch.Tensor | None = None  # (d,) corpus mean the lists are centred by
    rq_cuts: torch.Tensor | None = None    # (d, L-1) residual bucket boundaries
    rq_values: torch.Tensor | None = None  # (d, L) residual reconstruction values

    @property
    def nlist(self) -> int:
        return self.centroids.shape[0]

    @property
    def capacity(self) -> int:
        return self.ids.shape[1]

    @property
    def residual(self) -> bool:
        return self.rq_values is not None


def default_nlist(m: int) -> int:
    """4*sqrt(m) rounded down to a power of two, floor 16 (JAX rule)."""
    raw = 4 * int(np.sqrt(max(m, 1)))
    return max(16, 1 << (raw.bit_length() - 1))


def build_ivf(vectors: torch.Tensor, nlist: int = 0, *, sq8: bool = False,
              residual_bits: int = 0, kmeans_iters: int = 10,
              train_sample: int = 131072, center: bool = True,
              generator: torch.Generator | None = None,
              centroids: torch.Tensor | None = None) -> IVFIndex:
    """Build on ``vectors``' device.  ``center`` subtracts the corpus mean
    before clustering and packing (MIPS ranking is invariant to it: q.mean
    is constant per query).  ``centroids`` supplies a trained coarse
    quantizer and skips k-means; otherwise k-means runs on up to
    ``train_sample`` rows drawn with ``generator``.  ``residual_bits`` (2 or
    4) stores each row as packed residuals against its own list's centroid,
    and ``sq8`` is then ignored, as in the JAX package."""
    m, d = vectors.shape
    mean = None
    if center:
        mean = vectors.mean(0)
        vectors = vectors - mean[None, :]
    nlist = nlist or default_nlist(m)
    if centroids is None:
        sample = vectors
        if m > train_sample:
            idx = torch.randperm(m, generator=generator)[:train_sample]
            sample = vectors[idx.to(vectors.device)]
        centroids, _ = kmeans(sample, nlist, iters=kmeans_iters,
                              generator=generator)
        del sample
    assign = assign_clusters(vectors, centroids)
    if residual_bits:
        cuts, values = _train_rq(vectors, assign, centroids, int(residual_bits))
        codec = ResidualCodec(centroids, cuts, values)
        ids, vecs, _, counts = _pack_lists(vectors, assign, nlist, sq8=False,
                                           codec=codec)
        return IVFIndex(centroids, ids, vecs, None, counts, mean,
                        rq_cuts=cuts, rq_values=values)
    ids, vecs, scales, counts = _pack_lists(vectors, assign, nlist, sq8=sq8)
    return IVFIndex(centroids, ids, vecs, scales, counts, mean)


def assign_clusters(vectors: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest centroid of each row, ``argmax(v.c - |c|^2 / 2)`` in fp32
    (the package turns TF32 off), the first index on ties -> (n,) int64."""
    return _kmeans.assign(vectors, centroids)


def _pack_lists(vectors: torch.Tensor, assign: torch.Tensor, nlist: int, *,
                sq8: bool, cap_floor: int = 1, codec: ResidualCodec | None = None):
    """Pack vectors into fixed-capacity padded cluster lists, slots in
    ascending vector order within each list (the JAX loop's order, placed
    in one vectorized scatter).  SQ8 is per row and pad rows are zero, so
    the rows are quantized before packing: the codes and scales equal the
    JAX package's pack-then-quantize, pad slots included.  With ``codec``
    (the lists' centroids and residual tables) each row is coded against
    its own list's centroid and pad slots keep zero codes, as the JAX
    ``_residual_pack`` leaves them."""
    m, d = vectors.shape
    dev = vectors.device
    assign = assign.long()
    counts = torch.bincount(assign, minlength=nlist)
    cap = max(next_pow2(max(1, int(counts.max()) if m else 1)), int(cap_floor))
    order = torch.argsort(assign, stable=True)
    lists = assign[order]
    pos = torch.arange(m, device=dev) - (torch.cumsum(counts, 0) - counts)[lists]
    ids = torch.full((nlist, cap), -1, dtype=torch.int32, device=dev)
    ids[lists, pos] = order.to(torch.int32)
    scales = None
    if codec is not None:
        vecs = torch.zeros((nlist, cap, codec.packed_width), dtype=torch.uint8, device=dev)
    elif sq8:
        vecs = torch.zeros((nlist, cap, d), dtype=torch.int8, device=dev)
        pad_scale = sq8_quant(torch.zeros((1, 1), device=dev))[1]
        scales = pad_scale.expand(nlist, cap).contiguous()
    else:
        vecs = torch.zeros((nlist, cap, d), dtype=vectors.dtype, device=dev)
    for s in range(0, m, _PACK_ROWS):
        rows = order[s:s + _PACK_ROWS]
        li, pi = lists[s:s + _PACK_ROWS], pos[s:s + _PACK_ROWS]
        if codec is not None:
            vecs[li, pi] = residual_encode(codec, vectors[rows], li)[1]
        elif sq8:
            codes, sc = sq8_quant(vectors[rows])
            vecs[li, pi] = codes
            scales[li, pi] = sc
        else:
            vecs[li, pi] = vectors[rows]
    return ids, vecs, scales, counts.to(torch.int32)


def _train_rq(vectors: torch.Tensor, assign: torch.Tensor, centroids: torch.Tensor,
              bits: int):
    """The residual tables of the lists: quantiles of every row's residual
    against its own list's centroid (the JAX ``_train_rq`` over the packed
    lists' valid rows: the same residuals, whose order a quantile ignores),
    ``_RQ_COLS`` columns at a time -> (cuts (d, L-1), values (d, L))."""
    d = vectors.shape[1]
    L = 1 << bits
    cuts = torch.empty((d, L - 1), dtype=torch.float32, device=vectors.device)
    values = torch.empty((d, L), dtype=torch.float32, device=vectors.device)
    for c in range(0, d, _RQ_COLS):
        r = vectors[:, c:c + _RQ_COLS] - centroids[:, c:c + _RQ_COLS][assign]
        cuts[c:c + _RQ_COLS], values[c:c + _RQ_COLS] = residual_quantiles(r, bits)
    return cuts, values


def _residual_pack(centroids, cuts, values, ids, vecs_fp):
    """fp32 padded lists (nlist, cap, d) -> packed residual codes (nlist,
    cap, d * bits / 8) uint8 against each list's own centroid, pad slots
    zero (the JAX ``_residual_pack``)."""
    codec = ResidualCodec(centroids, cuts, values)
    nlist, cap = ids.shape
    cent = torch.arange(nlist, device=ids.device)[:, None].expand(nlist, cap).reshape(-1)
    packed = residual_encode(codec, vecs_fp.reshape(nlist * cap, -1), cent)[1]
    return torch.where((ids >= 0)[..., None], packed.reshape(nlist, cap, -1), 0)


def _residual_unpack(index: IVFIndex) -> torch.Tensor:
    """Decode the packed lists back to (nlist, cap, d) fp32 (centred), pad
    slots zero."""
    codec = ResidualCodec(index.centroids, index.rq_cuts, index.rq_values)
    nlist, cap = index.ids.shape
    cent = torch.arange(nlist, device=index.ids.device)[:, None].expand(nlist, cap)
    return residual_decode(codec, cent, index.vecs) * (index.ids >= 0)[..., None]


def extend_ivf(index: IVFIndex, new_vectors: torch.Tensor, *,
               shared: set | None = None) -> IVFIndex:
    """Add rows to the frozen coarse quantizer: the new rows (centred by the
    index's mean) take the ids after the stored ones and are appended to
    their lists in id order, at ``counts[c]``; a list that overflows pads
    every list to the next power of two (never below the old capacity; pad
    slots as ``_pack_lists`` leaves them).  The JAX ``extend_ivf`` re-packs
    every list from the dequantized rows; the new ids are larger than every
    stored id, and a stored SQ8 row re-quantizes to its own bits (its scale
    is max / 127 and its largest code 127), so appending gives the same
    lists.  A stored residual code re-encodes to itself unless its bucket's
    value sits on a cut (tied quantiles): :func:`_recode` applies JAX's
    decode-encode round trip to the lists where it does not.  Writes in
    place, except into the fields named in ``shared`` (another view holds
    them): those are copied first, once, and leave the set."""
    newv = torch.as_tensor(new_vectors).to(device=index.ids.device, dtype=torch.float32)
    n = newv.shape[0]
    if n == 0:
        return index
    if index.mean is not None:
        newv = newv - index.mean[None, :]
    nlist, dev = index.nlist, index.ids.device
    a = assign_clusters(newv, index.centroids)
    order = torch.argsort(a, stable=True)
    lists = a[order]
    added = torch.bincount(a, minlength=nlist)
    counts = index.counts.long()
    pos = counts[lists] + torch.arange(n, device=dev) - (torch.cumsum(added, 0) - added)[lists]
    new_counts = counts + added
    m_old = int(counts.sum())
    cap = index.capacity
    need = int(new_counts.max())
    own = {}
    if need > cap:
        newcap = next_pow2(need)

        def wider(t, fill):
            out = torch.full((nlist, newcap) + tuple(t.shape[2:]), fill, dtype=t.dtype,
                             device=dev)
            out[:, :cap] = t
            return out

        own = dict(ids=wider(index.ids, -1), vecs=wider(index.vecs, 0))
        if index.scales is not None:
            own["scales"] = wider(index.scales, float(sq8_quant(torch.zeros((1, 1)))[1]))
    for k in ("ids", "vecs", "scales", "counts"):
        t = getattr(index, k)
        if k not in own and t is not None and shared and k in shared:
            own[k] = t.clone()
    if shared:
        shared.difference_update(own)
    index = index._replace(**own)
    if index.residual:
        _recode(index)
    index.ids[lists, pos] = (m_old + order).to(torch.int32)
    rows = newv[order]
    if index.residual:
        codec = ResidualCodec(index.centroids, index.rq_cuts, index.rq_values)
        index.vecs[lists, pos] = residual_encode(codec, rows, lists)[1]
    elif index.scales is not None:
        index.vecs[lists, pos], index.scales[lists, pos] = sq8_quant(rows)
    else:
        index.vecs[lists, pos] = rows.to(index.vecs.dtype)
    index.counts.copy_(new_counts)
    return index


def _recode(index: IVFIndex) -> None:
    """Re-encode the stored residual codes in place as JAX's re-pack does:
    code l of dim j in list c becomes ``sum(((c_j + v_jl) - c_j) > cuts_j)``
    (a decode, then an encode against the own list's centroid).  That is l
    itself unless v_jl sits on a cut, which tied quantiles allow; only the
    lists where some (j, l) moves are unpacked, ``_RECODE_LISTS`` at a
    time, and their pad slots stay zero."""
    d, L = index.rq_values.shape
    bits = (L - 1).bit_length()
    vals, cuts = index.rq_values.float(), index.rq_cuts.float()
    levels = torch.arange(L, device=vals.device)
    for s in range(0, index.nlist, _RECODE_LISTS):
        c = index.centroids[s:s + _RECODE_LISTS].float()[:, :, None]     # (r, d, 1)
        back = (c + vals[None]) - c                                        # (r, d, L)
        table = (back[..., None] > cuts[None, :, None, :]).sum(-1)        # (r, d, L)
        moved = torch.nonzero((table != levels).any(2).any(1)).flatten()
        if not moved.numel():
            continue
        li = s + moved
        codes = unpack_codes(index.vecs[li], bits)                         # (a, cap, d)
        a, cap = codes.shape[:2]
        new = torch.gather(table[moved][:, None].expand(a, cap, d, L), 3,
                           codes[..., None]).squeeze(-1)
        keep = (index.ids[li] >= 0)[..., None]
        index.vecs[li] = torch.where(keep, pack_codes(new, bits), index.vecs[li])


def search_ivf(index: IVFIndex, q: torch.Tensor, nprobe: int, k: int,
               use_fused_gather: bool = True):
    """q: (B, d) pooled latents -> (scores (B, k), ids (B, k)), padded with
    (-inf, -1).  The uncentred query scores the centroids of the centred
    lists, as in the JAX package: MIPS ranking is invariant to the shift.
    ``use_fused_gather=False`` takes the legacy gathered scan (module
    docstring); both score pad slots -inf and give the same ids.  On
    residual lists the legacy route is the plain decode-then-score on any
    device, ``_LEGACY_RES_ROWS`` queries at a time."""
    B = q.shape[0]
    cs = q @ index.centroids.T                               # (B, nlist)
    probe = stable_topk(cs, nprobe)[1].to(torch.int32)       # (B, nprobe)
    flat_i = index.ids[probe.long()].reshape(B, -1)          # (B, nprobe * cap)
    if index.residual:
        args = (q, probe, index.ids, index.vecs, index.centroids, index.rq_values)
        s = (ivf_probe_res_scan(*args) if use_fused_gather
             else ref.ivf_scan_res_ref(*args, chunk=_LEGACY_RES_ROWS))
    elif use_fused_gather:
        s = ivf_probe_scan(q, probe, index.ids, index.vecs, index.scales)
    else:
        vecs = index.vecs[probe.long()]                      # (B, nprobe, cap, d)
        d = vecs.shape[-1]
        if index.scales is not None:
            sc = index.scales[probe.long()].reshape(B, -1)
            s = ops.mips_sq8_batched(q, vecs.reshape(B, -1, d), sc)
        else:
            s = torch.einsum("bd,bpcd->bpc", q, vecs.to(q.dtype))
        del vecs
        s = torch.where(flat_i.reshape(s.shape) >= 0, s, float("-inf"))
    flat_s = s.reshape(B, -1)
    top, pos = stable_topk(flat_s, min(k, flat_s.shape[1]))
    return pad_topk(top, torch.gather(flat_i, 1, pos), k)


def search_ivf_one_launch(index: IVFIndex, psi, q_tokens: torch.Tensor, q_mask,
                          nprobe: int, k: int):
    """The one-launch first stage: raw query tokens in, top-k candidates
    out, scan + top-k' in one ``query_fused`` (residual lists:
    ``query_fused_res``) call on the pooled latent of the probe-select
    prelude (``ops.fused_query``, ``ops.fused_query_res``: each query pooled
    once).  The same arithmetic as
    ``pool_queries`` + :func:`search_ivf`, so on the card the same ids.
    q_tokens: (B, Tq, d) -> (scores (B, k), ids (B, k)), padded with (-inf, -1)."""
    kp = min(k, nprobe * index.capacity)
    if index.residual:
        top, ids = ops.fused_query_res(q_tokens, q_mask, psi, index.centroids,
                                       index.ids, index.vecs, index.rq_values,
                                       nprobe=nprobe, kp=kp)
    else:
        top, ids = ops.fused_query(q_tokens, q_mask, psi, index.centroids, index.ids,
                                   index.vecs, index.scales, nprobe=nprobe, kp=kp)
    return pad_topk(top, ids, k)

"""The plain reference: LEMUR's search semantics in plain PyTorch, fp32 with
TF32 off, worked out again from the run's inputs (``corpus.py``).  It
imports nothing of the program and takes nothing the program made: it
derives its own IVF (k-means, lists, SQ8 codes or residual codes), its own
token codec and codes on the compressed tier, its own first stage and its
own exact MaxSim.

Frozen copies (the semantics the configuration states; sources noted):
k-means (``repro_torch/anns/kmeans.py``: assignment ``argmax(x.c - |c|^2/2)``
in blocks of 65,536 rows, sums in row order), SQ8 (``anns/quantization.
sq8_quant``), the residual quantile tables (``quantile_linear`` with
``jnp.quantile``'s rule, ``residual_quantiles``), the codec's training and
encoding (``train_residual_codec``, ``residual_encode`` in blocks of 16,384
rows), the IVF build (``anns/ivf.build_ivf``: centred rows, a 131,072-row
k-means sample, power-of-two padded lists in row order), the first stage
(``facade.first_stage``: psi-pool, top-nprobe centroids, scan, stable
top-k', tombstone mask) and MaxSim (``kernels/ref.py``).  A product goes
through a :class:`Precision`: ``fp32`` is the reference, ``tf32`` rounds
both operands to TF32 first and is the control that has to fail.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from bench.corpus import matmul_fp32, mix, psi_plain

NEG = -1e30
ENCODE_ROWS = 16384     # rows a block of the codec's encoding (the program's blocks)
ASSIGN_ROWS = 65536     # rows a block of k-means' assignment
QUANTILE_COLS = 64      # columns sorted at a time for the quantile tables
SCAN_QUERIES = 4        # queries scanned at a time
PAIR_BLOCK = 4096       # (query, doc) pairs a MaxSim block


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (10 mantissa bits, ties to even),
    still stored as fp32."""
    i = x.float().contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


class Precision:
    """How the reference multiplies: ``fp32`` (TF32 off) or ``tf32`` (both
    operands rounded to TF32, fp32 accumulation: the tensor cores' TF32)."""

    def __init__(self, name: str):
        if name not in ("fp32", "tf32"):
            raise ValueError(f"precision {name!r}")
        self.name = name

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "tf32":
            a, b = round_tf32(a), round_tf32(b)
        return a @ b


FP32 = Precision("fp32")


def stable_topk(s: torch.Tensor, k: int):
    """Top-k along the last axis, ties to the lower index."""
    v, i = torch.sort(s, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << int(n - 1).bit_length()


def default_nlist(m: int) -> int:
    """4 sqrt(m) rounded down to a power of two, at least 16 (the paper's rule)."""
    raw = 4 * int(m ** 0.5)
    return max(16, 1 << (raw.bit_length() - 1))


# -- k-means -----------------------------------------------------------------

def assign(x, cent, p: Precision = FP32, block: int = ASSIGN_ROWS):
    half = 0.5 * cent.square().sum(1)
    out = torch.empty((x.shape[0],), dtype=torch.long, device=x.device)
    for s in range(0, x.shape[0], block):
        out[s:s + block] = torch.argmax(p.mm(x[s:s + block], cent.T) - half, dim=1)
    return out


def segment_sums(x, a, k):
    order = torch.argsort(a, stable=True)
    lengths = torch.bincount(a, minlength=k)
    return torch.segment_reduce(x[order], "sum", lengths=lengths, unsafe=True, initial=0.0)


def kmeans(x, k, iters, generator, p: Precision = FP32):
    n = x.shape[0]
    cent = x[torch.randperm(n, generator=generator)[:k].to(x.device)]
    for _ in range(iters):
        a = assign(x, cent, p)
        counts = torch.bincount(a, minlength=k).to(x.dtype)
        new = segment_sums(x, a, k) / counts.clamp_min(1.0)[:, None]
        cent = torch.where(counts[:, None] > 0, new, cent)
    return cent, assign(x, cent, p)


# -- quantizers ----------------------------------------------------------------

def sq8_quant(x):
    scale = x.abs().amax(-1).clamp_min(1e-12) / torch.full((), 127.0, device=x.device)
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale.float()


def _fma_f32(a, b, c):
    """fp32 ``a * b + c`` rounded once (a fused multiply-add), via fp64."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    r = s.float()
    r64 = r.double()
    other = torch.nextafter(r, torch.where(s > r64, torch.inf, -torch.inf).float())
    half = (s != r64) & ((s - r64) == (other.double() - s)) & (err != 0)
    toward = torch.where(err > 0, torch.maximum(r, other), torch.minimum(r, other))
    return torch.where(half, toward, r)


def quantile_linear(x, qs):
    """``numpy.quantile(x, qs, axis=0)`` (linear), the program's rounding."""
    n, d = x.shape
    qs = qs.to(device=x.device, dtype=torch.float32)
    pos = qs * (torch.tensor(float(n), device=x.device) - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lw = 1 - hw
    low = low.clamp(0, n - 1).long()
    high = high.clamp(0, n - 1).long()
    out = torch.empty((qs.shape[0], d), dtype=torch.float32, device=x.device)
    for c in range(0, d, QUANTILE_COLS):
        xs = torch.sort(x[:, c:c + QUANTILE_COLS].float(), dim=0, stable=True).values
        lo, hi = xs[low], xs[high]
        out[:, c:c + QUANTILE_COLS] = _fma_f32(lo, lw[:, None].expand_as(lo), hi * hw[:, None])
    return out


def residual_quantiles(r, bits):
    """Cuts at (l+1)/L and values at (l+0.5)/L of each dimension's residuals."""
    L = 1 << bits
    qs = torch.cat([torch.arange(1, L, dtype=torch.float32) / L,
                    (torch.arange(L, dtype=torch.float32) + 0.5) / L])
    out = quantile_linear(r, qs)
    return out[:L - 1].T.contiguous(), out[L - 1:].T.contiguous()


class Codec(NamedTuple):
    centroids: torch.Tensor   # (ncent, d)
    cuts: torch.Tensor        # (d, L-1)
    values: torch.Tensor      # (d, L)


def train_codec(generator, x, bits, ncent, iters, sample, p: Precision = FP32) -> Codec:
    """ColBERTv2's residual codec: k-means centroids of (a sample of) the
    tokens and per-dimension residual quantile tables."""
    xs = x.float()
    if xs.shape[0] > sample:
        xs = xs[torch.randperm(xs.shape[0], generator=generator)[:sample].to(xs.device)]
    ncent = int(min(ncent, xs.shape[0]))
    cent, a = kmeans(xs, ncent, iters, generator, p)
    cuts, values = residual_quantiles(xs - cent[a], bits)
    return Codec(cent, cuts, values)


def codec_roundtrip(codec: Codec, x, p: Precision = FP32, cent_ids=None):
    """Each row coded (nearest centroid, or ``cent_ids``; a bucket a
    dimension) and decoded: ``centroid + values[dim, bucket]``, one fp32 add
    an element, in blocks of ``ENCODE_ROWS`` rows."""
    x = x.float()
    out = torch.empty_like(x)
    d = x.shape[1]
    dims = torch.arange(d, device=x.device)
    half = 0.5 * codec.centroids.square().sum(1)
    for s in range(0, x.shape[0], ENCODE_ROWS):
        xb = x[s:s + ENCODE_ROWS]
        if cent_ids is None:
            c = torch.argmax(p.mm(xb, codec.centroids.T) - half, dim=-1)
        else:
            c = cent_ids[s:s + ENCODE_ROWS]
        cent = codec.centroids[c]
        idx = ((xb - cent)[..., None] > codec.cuts).sum(-1)
        out[s:s + ENCODE_ROWS] = cent + codec.values[dims, idx]
    return out


# -- the IVF ------------------------------------------------------------------

class IVF(NamedTuple):
    centroids: torch.Tensor   # (nlist, d')
    ids: torch.Tensor         # (nlist, cap) int64, -1 padded, rows in id order
    counts: torch.Tensor      # (nlist,) int64
    rows: torch.Tensor        # (m, d') the scored form of each row: int8 codes or decoded fp32
    scales: torch.Tensor | None   # (m,) SQ8 scales


def build_ivf(W, ivf_cfg: dict, generator, p: Precision = FP32) -> IVF:
    """The IVF over the latent rows ``W`` (m, d'), centred by their mean."""
    m = W.shape[0]
    v = W - W.mean(0)[None, :]
    nlist = int(ivf_cfg["nlist"]) or default_nlist(m)
    sample = v
    if m > int(ivf_cfg["train_sample"]):
        sample = v[torch.randperm(m, generator=generator)[:int(ivf_cfg["train_sample"])]
                   .to(v.device)]
    cent, _ = kmeans(sample, nlist, int(ivf_cfg["kmeans_iters"]), generator, p)
    del sample
    a = assign(v, cent, p)
    counts = torch.bincount(a, minlength=nlist)
    cap = next_pow2(max(1, int(counts.max())))
    order = torch.argsort(a, stable=True)
    lists = a[order]
    pos = torch.arange(m, device=v.device) - (torch.cumsum(counts, 0) - counts)[lists]
    ids = torch.full((nlist, cap), -1, dtype=torch.long, device=v.device)
    ids[lists, pos] = order
    bits = int(ivf_cfg["residual_bits"])
    if bits:
        cuts = torch.empty((v.shape[1], (1 << bits) - 1), device=v.device)
        values = torch.empty((v.shape[1], 1 << bits), device=v.device)
        for c in range(0, v.shape[1], QUANTILE_COLS):
            r = v[:, c:c + QUANTILE_COLS] - cent[:, c:c + QUANTILE_COLS][a]
            cuts[c:c + QUANTILE_COLS], values[c:c + QUANTILE_COLS] = residual_quantiles(r, bits)
        rows = codec_roundtrip(Codec(cent, cuts, values), v, p, cent_ids=a)
        return IVF(cent, ids, counts, rows, None)
    if not ivf_cfg["sq8"]:
        return IVF(cent, ids, counts, v, None)
    codes = torch.empty(v.shape, dtype=torch.int8, device=v.device)
    scales = torch.empty((m,), device=v.device)
    for s in range(0, m, ASSIGN_ROWS):
        codes[s:s + ASSIGN_ROWS], scales[s:s + ASSIGN_ROWS] = sq8_quant(v[s:s + ASSIGN_ROWS])
    return IVF(cent, ids, counts, codes, scales)


def psi_pool(q, qm, psi, p: Precision = FP32):
    """The pooled query latent: sum over the valid tokens of psi(token)."""
    y = psi_plain(q, *psi, mm=p.mm)
    return (y * qm[..., None].float()).sum(-2)


def probes(ivf: IVF, pq, nprobe: int, p: Precision = FP32):
    """The top-nprobe lists of each pooled query, (B, nprobe) int64."""
    return stable_topk(p.mm(pq, ivf.centroids.T), nprobe)[1]


def first_stage(ivf: IVF, pq, nprobe: int, k_prime: int, alive, p: Precision = FP32):
    """Top-k' candidates of each query over the rows of its probed lists
    (the uncentred query against the centred rows; the strip in probe-major
    slot order, ties to the earlier slot), tombstoned ids to -1 ->
    (candidates (B, k') int64, probes (B, nprobe))."""
    pr = probes(ivf, pq, nprobe, p)
    B = pq.shape[0]
    out = torch.full((B, k_prime), -1, dtype=torch.long, device=pq.device)
    for s in range(0, B, SCAN_QUERIES):
        strip = ivf.ids[pr[s:s + SCAN_QUERIES]].reshape(min(SCAN_QUERIES, B - s), -1)
        valid = strip >= 0
        rows = ivf.rows[strip.clamp_min(0)].float()                       # (b, n, d')
        sc = p.mm(rows, pq[s:s + SCAN_QUERIES, :, None])[..., 0]
        if ivf.scales is not None:
            sc = sc * ivf.scales[strip.clamp_min(0)]
        sc = torch.where(valid, sc, float("-inf"))
        top, pos = stable_topk(sc, min(k_prime, sc.shape[1]))
        cand = torch.where(torch.isfinite(top), torch.gather(strip, 1, pos), -1)
        out[s:s + SCAN_QUERIES, :cand.shape[1]] = cand
    ok = (out >= 0) & alive[out.clamp_min(0)]
    return torch.where(ok, out, -1), pr


# -- MaxSim ---------------------------------------------------------------------

def maxsim(q, qm, dtok, dcnt, p: Precision = FP32):
    """Exact MaxSim of query ``q[i]`` (Tq, d) against doc ``dtok[i]`` (T, d)
    with ``dcnt[i]`` valid tokens: the per-query-token maxima, summed over
    the valid query tokens -> (n,)."""
    sim = p.mm(q, dtok.transpose(1, 2))                                   # (n, Tq, T)
    pos = torch.arange(dtok.shape[1], device=q.device)
    sim = torch.where((pos[None, :] < dcnt[:, None])[:, None, :], sim, NEG)
    return torch.where(qm, sim.amax(-1), 0.0).sum(-1)


class Reference:
    """The reference of one run: the IVF and, on the compressed tier, the
    token codec, derived from the corpus in :meth:`build`; then the first
    stage and exact MaxSim of any (query, doc) pairs."""

    def __init__(self, corpus, cfg: dict, precision: str = "fp32"):
        self.corpus, self.cfg = corpus, cfg
        self.p = Precision(precision)
        self.codec: Codec | None = None
        self.ivf: IVF | None = None

    def build(self, fill_pool: bool = False) -> "Reference":
        """Derive the IVF (and the token codec) from the corpus;
        ``fill_pool`` fills the corpus' query pool on the way (where no
        program set-up has)."""
        c, cfg, p = self.corpus, self.cfg, self.p
        with matmul_fp32():
            W = torch.empty((c.m, c.dp), device=c.dev)
            for i in range(c.n_chunks):
                tok, mask, w = c.chunk(i)
                W[i * c.chunk_docs:(i + 1) * c.chunk_docs] = w
                if fill_pool:
                    c.fill_pool(i, tok)
                if i == 0 and cfg["residual"]["enabled"]:
                    rc = cfg["residual"]
                    sample = c.codec_sample(tok, mask, int(rc["train_sample"]))
                    gen = torch.Generator().manual_seed(mix(c.seed, "codec"))
                    self.codec = train_codec(gen, sample, int(rc["bits"]), int(rc["ncent"]),
                                             int(rc["kmeans_iters"]), int(rc["train_sample"]), p)
                del tok, mask, w
            gen = torch.Generator().manual_seed(mix(c.seed, "ivf"))
            self.ivf = build_ivf(W, cfg["ivf"], gen, p)
        return self

    def search_first_stage(self, q, qm, nprobe: int, k_prime: int):
        with matmul_fp32():
            pq = psi_pool(q, qm, self.corpus.psi, self.p)
            return first_stage(self.ivf, pq, nprobe, k_prime, self.corpus.alive, self.p)

    def doc_tokens(self, i: int):
        """Chunk ``i``'s docs as the tier serves them -> (tokens, counts):
        the fp32 tokens, or their codec round trip on the compressed tier
        (every valid token of the chunk coded in the program's order and
        blocks)."""
        c = self.corpus
        tok, mask, _ = c.chunk(i)
        if self.codec is not None:
            dec = torch.zeros_like(tok)
            dec[mask] = codec_roundtrip(self.codec, tok[mask], self.p)
            tok = dec
        return tok, c.counts[i * c.chunk_docs:(i + 1) * c.chunk_docs]

    def pair_scores(self, q, qm, rows, docs):
        """Exact MaxSim of the pairs (query ``q[rows[j]]``, doc ``docs[j]``),
        docs read chunk by chunk -> (n,) fp32; a ``-1`` doc scores NEG."""
        c = self.corpus
        out = torch.full(docs.shape, NEG, device=q.device)
        order = torch.argsort(docs)
        docs_s, rows_s = docs[order], rows[order]
        bounds = torch.searchsorted(docs_s, torch.arange(
            0, c.m + 1, c.chunk_docs, device=q.device)).tolist()
        with matmul_fp32():
            for i in range(c.n_chunks):
                lo, hi = bounds[i], bounds[i + 1]
                if hi <= lo:
                    continue
                tok, cnt = self.doc_tokens(i)
                base = i * c.chunk_docs
                for s in range(lo, hi, PAIR_BLOCK):
                    e = min(s + PAIR_BLOCK, hi)
                    local = docs_s[s:e] - base
                    r = rows_s[s:e]
                    out[order[s:e]] = maxsim(q[r], qm[r], tok[local], cnt[local], self.p)
                del tok, cnt
        return out

    def serve(self, q, qm, cand, k: int):
        """The rerank's answer over ``cand`` (B, k'): the top-k by this
        reference's MaxSim, ties to the earlier candidate, rows short of k
        padded with (NEG, -1) -> (scores, ids)."""
        B = cand.shape[0]
        ok = cand >= 0
        rows = torch.arange(B, device=q.device)[:, None].expand_as(cand)
        sc = torch.full(cand.shape, NEG, device=q.device)
        sc[ok] = self.pair_scores(q, qm, rows[ok], cand[ok])
        top, idx = stable_topk(sc, min(k, cand.shape[1]))
        ids = torch.where(top > NEG / 2, torch.gather(cand, 1, idx), -1)
        if top.shape[1] < k:
            top = torch.cat([top, top.new_full((B, k - top.shape[1]), NEG)], 1)
            ids = torch.cat([ids, ids.new_full((B, k - ids.shape[1]), -1)], 1)
        return top, ids

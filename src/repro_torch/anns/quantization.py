"""Corpus compression codecs (twin of ``repro/anns/quantization.py``).

* **SQ8**: per-row symmetric int8 with the scale clamped at
  ``max(|x|, 1e-12)``, so an all-zero row (a pad slot, a fully masked doc's
  latent) quantizes to zero codes with a tiny positive scale instead of
  dividing by zero.
* **Residual codec** (ColBERTv2-style): a vector is stored as the id of its
  nearest k-means centroid plus a 2- or 4-bit code per dimension of the
  residual.  The bucket boundaries (``cuts``) and reconstruction values
  (``values``) of each dimension are residual quantiles, computed by
  :func:`quantile_linear` with ``jnp.quantile``'s rule bit for bit.

Packed layout (the contract the kernels' decoder, ``csrc/residual.cuh``,
reads): ``per = 8 // bits`` codes a byte, dimension ``i * per + j`` at bit
``bits * j`` of byte ``i`` (little-endian within the byte).  Decoding adds
one table value to one centroid element, one fp32 add an element, so every
decoder gives the same bits.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.anns.kmeans import kmeans

_ENCODE_ROWS = 16384   # rows encoded or decoded at a time (bounds the (n, d, L) compare)
_QUANTILE_COLS = 64    # columns sorted at a time by quantile_linear


def sq8_quant(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (..., d) fp32 -> (int8 codes, fp32 per-row scales (...,)).
    ``torch.round`` rounds half to even, as ``jnp.round`` does, so the codes
    are bit-identical to the JAX package's.  The divisor 127 is a tensor on
    ``x``'s device: a Python scalar divisor becomes a product with its
    reciprocal on a CUDA device, a scale an ulp off the true quotient."""
    scale = x.abs().amax(-1).clamp_min(1e-12) / torch.full((), 127.0, device=x.device)
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale.float()


def sq8_dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale[..., None]


def sq8_dot(q_query: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """fp query (B, d) x int8 corpus (m, d) with per-row scales -> (B, m)."""
    return (q_query @ codes.to(q_query.dtype).T) * scale[None, :]


class ResidualCodec(NamedTuple):
    """Trained residual-codec tables.

    centroids: (ncent, d) fp32 coarse code book
    cuts:      (d, L-1) fp32 per-dim bucket boundaries, L = 2**bits (only
               encoding reads them)
    values:    (d, L)   fp32 per-dim reconstruction value of each bucket
    """
    centroids: torch.Tensor
    cuts: torch.Tensor | None
    values: torch.Tensor

    @property
    def ncent(self) -> int:
        return self.centroids.shape[0]

    @property
    def d(self) -> int:
        return self.centroids.shape[1]

    @property
    def nlevels(self) -> int:
        return self.values.shape[1]

    @property
    def bits(self) -> int:
        return int(self.values.shape[1]).bit_length() - 1

    @property
    def packed_width(self) -> int:
        """Bytes a packed vector: d * bits / 8."""
        return self.d * self.bits // 8

    def to(self, device) -> "ResidualCodec":
        return ResidualCodec(*(None if t is None else t.to(device) for t in self))


def codes_per_byte(bits: int) -> int:
    if bits not in (2, 4):
        raise ValueError(f"residual codec supports 2 or 4 bits, got {bits}")
    return 8 // bits


def _shifts(bits: int, device) -> torch.Tensor:
    return torch.arange(codes_per_byte(bits), device=device, dtype=torch.int32) * bits


def pack_codes(idx: torch.Tensor, bits: int) -> torch.Tensor:
    """Bucket indices (..., d) -> packed (..., d * bits // 8) uint8, dim
    ``i * per + j`` at bit ``bits * j`` of byte ``i``."""
    per = codes_per_byte(bits)
    d = idx.shape[-1]
    if d % per:
        raise ValueError(f"d={d} not divisible by {per} codes/byte ({bits}-bit)")
    grp = idx.to(torch.int32).reshape(*idx.shape[:-1], d // per, per)
    # the fields do not overlap, so their sum is their bitwise or
    return (grp << _shifts(bits, idx.device)).sum(-1).to(torch.uint8)


def unpack_codes(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """Packed (..., db) uint8 -> bucket indices (..., db * 8 // bits) int64."""
    per = codes_per_byte(bits)
    b = packed.to(torch.int32)[..., None] >> _shifts(bits, packed.device)
    return (b & ((1 << bits) - 1)).reshape(*packed.shape[:-1],
                                          packed.shape[-1] * per).long()


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fp32 ``a * b + c`` rounded once, as a fused multiply-add: the product
    is exact in fp64, the fp64 sum's error comes from TwoSum, and the one
    case where rounding the fp64 sum to fp32 rounds twice (the sum lying
    exactly halfway between two fp32 neighbours) is rounded toward the
    exact value."""
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


def quantile_linear(x: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """``jnp.quantile(x, qs, axis=0)`` (method "linear") bit for bit:
    x (n, d), qs (nq,) fp32 -> (nq, d) fp32.

    Each column is sorted; ``q * (n - 1)`` is formed in fp32, ``low`` and
    ``high`` are its floor and ceiling, and with ``w = q * (n - 1) - low``
    the result is ``x[low] * (1 - w) + x[high] * w`` as XLA's CPU backend
    computes it: the second product rounded, then a fused multiply-add of
    the first (``torch.quantile`` interpolates with lerp, which rounds
    otherwise, and refuses more than 2**24 elements).  A column holding a
    NaN gives NaN.  ``_QUANTILE_COLS`` columns are sorted at a time, which
    bounds the scratch at n x _QUANTILE_COLS elements."""
    n, d = x.shape
    qs = qs.to(device=x.device, dtype=torch.float32)
    pos = qs * (torch.tensor(float(n), device=x.device) - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lw = 1 - hw
    low = low.clamp(0, n - 1).long()
    high = high.clamp(0, n - 1).long()
    out = torch.empty((qs.shape[0], d), dtype=torch.float32, device=x.device)
    for c in range(0, d, _QUANTILE_COLS):
        xs = torch.sort(x[:, c:c + _QUANTILE_COLS].float(), dim=0, stable=True).values
        lo, hi = xs[low], xs[high]
        r = _fma_f32(lo, lw[:, None].expand_as(lo), hi * hw[:, None])
        nan = torch.isnan(xs).any(0)
        out[:, c:c + _QUANTILE_COLS] = torch.where(nan, float("nan"), r)
    return out


def residual_quantiles(r: torch.Tensor, bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-dim bucket boundaries at (l+1)/L and reconstruction values at the
    bucket midpoints (l+0.5)/L of residuals r (n, d) -> (cuts (d, L-1),
    values (d, L)), so the buckets hold equal residual mass (ColBERTv2
    §2.2)."""
    L = 1 << bits
    qs = torch.cat([torch.arange(1, L, dtype=torch.float32) / L,
                    (torch.arange(L, dtype=torch.float32) + 0.5) / L])
    out = quantile_linear(r, qs)
    return out[:L - 1].T.contiguous(), out[L - 1:].T.contiguous()


def train_residual_codec(generator: torch.Generator | None, x: torch.Tensor, *,
                         bits: int = 4, ncent: int = 0, iters: int = 8,
                         sample: int = 65536) -> ResidualCodec:
    """Fit the codec on (a sample of) token vectors x: (n, d), on x's device:
    ``sample`` rows drawn without replacement by ``generator`` (CPU), k-means
    centroids (``ncent``, 256 when 0, at most the sample) and the residual
    quantile tables of :func:`residual_quantiles`."""
    codes_per_byte(bits)
    x = x.float()
    n, d = x.shape
    if d % codes_per_byte(bits):
        raise ValueError(f"d={d} not packable at {bits} bits")
    xs = x
    if n > sample:
        xs = x[torch.randperm(n, generator=generator)[:sample].to(x.device)]
    ncent = int(min(ncent if ncent > 0 else 256, xs.shape[0]))
    centroids, assign = kmeans(xs, ncent, iters=iters, generator=generator)
    cuts, values = residual_quantiles(xs - centroids[assign], bits)
    return ResidualCodec(centroids=centroids, cuts=cuts, values=values)


def residual_assign(codec: ResidualCodec, x: torch.Tensor) -> torch.Tensor:
    """Nearest centroid of each vector, ``argmax(x @ C.T - |C|^2 / 2)``, the
    first index on ties: x (n, d) -> (n,) int32."""
    half = 0.5 * codec.centroids.square().sum(1)
    return torch.argmax(x @ codec.centroids.T - half, dim=-1).to(torch.int32)


def residual_encode(codec: ResidualCodec, x: torch.Tensor,
                    cent_ids: torch.Tensor | None = None):
    """x (n, d) -> (cent_ids (n,) int32, packed (n, d * bits // 8) uint8),
    ``_ENCODE_ROWS`` rows at a time.  ``cent_ids`` codes the residuals
    against given centroids (the IVF codes each vector against its own
    list's centroid).  Bucket ``idx = sum(r > cuts)`` over the L-1 cuts."""
    x = x.float()
    n = x.shape[0]
    cid = torch.empty((n,), dtype=torch.int32, device=x.device)
    packed = torch.empty((n, codec.packed_width), dtype=torch.uint8, device=x.device)
    for s in range(0, n, _ENCODE_ROWS):
        xb = x[s:s + _ENCODE_ROWS]
        c = (residual_assign(codec, xb) if cent_ids is None
             else cent_ids[s:s + _ENCODE_ROWS].to(torch.int32))
        r = xb - codec.centroids[c.long()]
        idx = (r[..., None] > codec.cuts).sum(-1)
        cid[s:s + _ENCODE_ROWS] = c
        packed[s:s + _ENCODE_ROWS] = pack_codes(idx, codec.bits)
    return cid, packed


def residual_decode(codec: ResidualCodec, cent_ids: torch.Tensor,
                    packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`residual_encode`: cent_ids (...,), packed (..., db)
    -> fp32 (..., d), ``centroids[cent] + values.T[idx]`` element by
    element (one fp32 add each, as every decoder of the codec computes)."""
    d, L = codec.values.shape
    lead = cent_ids.shape
    cent = cent_ids.reshape(-1)
    codes = packed.reshape(-1, packed.shape[-1])
    out = torch.empty((cent.shape[0], d), dtype=torch.float32, device=packed.device)
    flat_vals = codec.values.float().reshape(-1)                 # [k * L + level]
    base = torch.arange(d, device=packed.device) * L
    for s in range(0, cent.shape[0], _ENCODE_ROWS):
        idx = unpack_codes(codes[s:s + _ENCODE_ROWS], codec.bits)
        out[s:s + _ENCODE_ROWS] = (codec.centroids[cent[s:s + _ENCODE_ROWS].long()]
                                   + flat_vals[base + idx])
    return out.reshape(*lead, d)

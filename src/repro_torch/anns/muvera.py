"""MUVERA fixed-dimensional encodings (twin of ``repro/anns/muvera.py``;
Jayaram et al., 2024).

R independent SimHash partitions of R^d into 2^k_sim buckets; a document's
FDE block is the per-bucket centroid of its tokens (an empty bucket takes
the doc centroid, as in the JAX package), a query's the per-bucket sum; the
blocks are concatenated and projected by a random +-1/sqrt(final_dim)
matrix to ``final_dim``.

The JAX package draws the planes and projections from ``cfg.seed`` with
``jax.random`` at every call; those streams cannot be replayed here, so the
port draws its :class:`MuveraParts` once, from a ``torch.Generator`` seeded
with ``cfg.seed`` (:func:`partition_params`), and the backend state keeps
them.  A caller holding JAX's ``_partition_params`` passes them as ``parts``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.common.config import ConfigBase

_FDE_DOCS = 512   # docs encoded at a time (the JAX doc_fde's block)


@dataclasses.dataclass(frozen=True)
class MuveraConfig(ConfigBase):
    r_reps: int = 40
    k_sim: int = 6
    d_proj: int = 0          # 0 => identity (d_proj = d), per the paper
    final_dim: int = 10240
    seed: int = 7


class MuveraParts(NamedTuple):
    hyper: torch.Tensor               # (R, k_sim, d) SimHash planes
    proj: torch.Tensor | None         # (R, d, d_proj) +-1/sqrt(d_proj), None when d_proj = 0
    final: torch.Tensor               # (R * 2^k_sim * d_proj, final_dim) +-1/sqrt(final_dim)

    def to(self, device) -> "MuveraParts":
        return MuveraParts(*(None if t is None else t.to(device) for t in self))


def _signs(g: torch.Generator, shape, width: int) -> torch.Tensor:
    s = torch.randint(0, 2, shape, generator=g, dtype=torch.int8).float() * 2 - 1
    return s / torch.sqrt(torch.tensor(float(width)))


def partition_params(cfg: MuveraConfig, d: int, device="cpu") -> MuveraParts:
    """The planes and projections, drawn on the CPU from a generator seeded
    with ``cfg.seed`` and moved to ``device``."""
    g = torch.Generator().manual_seed(int(cfg.seed))
    hyper = torch.randn((cfg.r_reps, cfg.k_sim, d), generator=g)
    dp = cfg.d_proj or d
    proj = _signs(g, (cfg.r_reps, d, dp), dp) if cfg.d_proj else None
    final = _signs(g, (cfg.r_reps * 2 ** cfg.k_sim * dp, cfg.final_dim), cfg.final_dim)
    return MuveraParts(hyper, proj, final).to(device)


def bucket_ids(tokens: torch.Tensor, hyper: torch.Tensor) -> torch.Tensor:
    """tokens (..., T, d); hyper (R, k, d) -> (..., R, T) int64 in [0, 2^k):
    bit j of a token's bucket is ``token . hyper[r, j] > 0``."""
    R, k, d = hyper.shape
    bits = (tokens @ hyper.reshape(R * k, d).T > 0).reshape(*tokens.shape[:-1], R, k)
    ids = (bits.long() << torch.arange(k, device=tokens.device)).sum(-1)   # (..., T, R)
    return ids.movedim(-1, -2)


def _fde(tokens, mask, cfg: MuveraConfig, parts: MuveraParts, *, is_query: bool):
    """tokens (B, T, d), mask (B, T) -> (B, final_dim)."""
    B, T, d = tokens.shape
    nb = 2 ** cfg.k_sim
    hyper, proj, final = parts
    b = bucket_ids(tokens, hyper)                                   # (B, R, T)
    onehot = torch.nn.functional.one_hot(b, nb).to(tokens.dtype)    # (B, R, T, nb)
    onehot = onehot * mask[:, None, :, None].to(tokens.dtype)
    if proj is not None:
        t = torch.einsum("btd,rde->brte", tokens, proj)             # (B, R, T, dp)
        sums = torch.einsum("brtn,brte->brne", onehot, t)
    else:
        t = tokens[:, None]                                         # (B, 1, T, d)
        sums = torch.einsum("brtn,bte->brne", onehot, tokens)       # (B, R, nb, d)
    if is_query:
        block = sums
    else:
        cnt = onehot.sum(2)                                         # (B, R, nb)
        centroid = sums / cnt.clamp_min(1.0)[..., None]
        mf = mask.to(tokens.dtype)
        doc_cent = (t * mf[:, None, :, None]).sum(2) / mf.sum(1).clamp_min(1.0)[:, None, None]
        block = torch.where(cnt[..., None] > 0, centroid, doc_cent[:, :, None, :])
    return block.reshape(B, -1) @ final


def doc_fde(tokens, mask, cfg: MuveraConfig, parts: MuveraParts | None = None, *,
            block: int = _FDE_DOCS) -> torch.Tensor:
    """(m, T, d) docs -> (m, final_dim) FDEs, ``block`` docs at a time."""
    parts = parts if parts is not None else partition_params(cfg, tokens.shape[-1],
                                                             tokens.device)
    out = [_fde(tokens[lo:lo + block], mask[lo:lo + block], cfg, parts, is_query=False)
           for lo in range(0, tokens.shape[0], block)]
    return torch.cat(out) if out else tokens.new_zeros((0, cfg.final_dim))


def query_fde(tokens, mask, cfg: MuveraConfig, parts: MuveraParts | None = None):
    parts = parts if parts is not None else partition_params(cfg, tokens.shape[-1],
                                                             tokens.device)
    return _fde(tokens, mask, cfg, parts, is_query=True)

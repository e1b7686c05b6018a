"""Per-backend configuration namespaces and typed search parameters (twin of
``repro/anns/params.py``: same fields, same defaults, so a JAX checkpoint's
``cfg`` dict reads back unchanged).  The registry
(:mod:`repro_torch.anns.registry`) maps each backend name to its pair.
"""
from __future__ import annotations

import dataclasses

from repro_torch.common.config import ConfigBase


@dataclasses.dataclass(frozen=True)
class BackendConfig(ConfigBase):
    """Marker base for per-backend build-time config namespaces."""


@dataclasses.dataclass(frozen=True)
class BackendSearchParams(ConfigBase):
    """Marker base for per-backend query-time knobs."""


@dataclasses.dataclass(frozen=True)
class BruteforceBackendConfig(BackendConfig):
    """Exact latent MIPS has no build-time knobs."""


@dataclasses.dataclass(frozen=True)
class IVFBackendConfig(BackendConfig):
    nlist: int = 0           # 0 => 4*sqrt(m) rounded down to pow2 (paper's rule)
    nprobe: int = 32         # default query-time probe count
    sq8: bool = True         # scalar-quantize the latent corpus (Glass-style)
    residual_bits: int = 0   # 2/4 => residual-codec list storage; 0 => off
    use_fused_gather: bool = True  # gather-at-source probe scan
    use_one_launch: bool = False   # probe scan + top-k' in one call, on the pooled latent


@dataclasses.dataclass(frozen=True)
class ResidualConfig(ConfigBase):
    """The compressed token-corpus tier (``cfg.residual``)."""

    enabled: bool = False
    bits: int = 4
    ncent: int = 256
    token_budget: int = 0
    kmeans_iters: int = 8
    train_sample: int = 65536


@dataclasses.dataclass(frozen=True)
class MuveraBackendConfig(BackendConfig):
    r_reps: int = 20
    k_sim: int = 5
    final_dim: int = 1280


@dataclasses.dataclass(frozen=True)
class DessertBackendConfig(BackendConfig):
    tables: int = 32
    bits: int = 5


@dataclasses.dataclass(frozen=True)
class TokenPruningBackendConfig(BackendConfig):
    nlist: int = 0
    nprobe: int = 8


@dataclasses.dataclass(frozen=True)
class NoSearchParams(BackendSearchParams):
    """Backends whose only query-time knob is the shared k' budget."""


@dataclasses.dataclass(frozen=True)
class IVFSearchParams(BackendSearchParams):
    nprobe: int | None = None             # None => cfg.ivf.nprobe
    use_fused_gather: bool | None = None  # None => cfg.ivf.use_fused_gather
    use_one_launch: bool | None = None    # None => cfg.ivf.use_one_launch


@dataclasses.dataclass(frozen=True)
class TokenPruningSearchParams(BackendSearchParams):
    nprobe: int | None = None             # None => cfg.token_pruning.nprobe

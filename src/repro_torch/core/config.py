"""LEMUR configuration (twin of ``repro/core/config.py``; paper App. A
defaults): the same fields and defaults, one namespace per registered
first-stage backend (``cfg.ivf``, ``cfg.muvera``, ...).  The v0 flat-knob
aliases are not carried over: checkpoints store the namespaced form."""
from __future__ import annotations

import dataclasses

from repro_torch.anns.params import (
    BruteforceBackendConfig,
    DessertBackendConfig,
    IVFBackendConfig,
    MuveraBackendConfig,
    ResidualConfig,
    TokenPruningBackendConfig,
)
from repro_torch.common.config import ConfigBase


@dataclasses.dataclass(frozen=True)
class LemurConfig(ConfigBase):
    d: int = 128                 # token embedding dim (ColBERTv2: 128)
    d_prime: int = 2048          # latent dim d'
    m_pretrain: int = 8192
    n_train: int = 100_000
    n_ols: int = 16_384
    lr: float = 3e-3
    epochs: int = 100
    batch_size: int = 512
    grad_clip: float = 0.5
    ridge: float = 1e-4
    query_strategy: str = "corpus-query"
    k: int = 100                 # final top-k
    k_prime: int = 1024          # candidates to rerank
    anns: str = "ivf"            # first-stage backend name
    bruteforce: BruteforceBackendConfig = BruteforceBackendConfig()
    ivf: IVFBackendConfig = IVFBackendConfig()
    muvera: MuveraBackendConfig = MuveraBackendConfig()
    dessert: DessertBackendConfig = DessertBackendConfig()
    token_pruning: TokenPruningBackendConfig = TokenPruningBackendConfig()
    residual: ResidualConfig = ResidualConfig()
    rerank_block: int = 1024
    use_fused_gather: bool = True  # rerank through the page-fed kernel
    use_one_launch: bool = False   # exact-scan one-launch first stage
    score_dtype: str = "float32"

    def __post_init__(self):
        from repro_torch.anns import registry  # late: the backends import core modules

        known = set(registry.list_backends()) | {"exact"}
        if self.anns not in known:
            raise ValueError(f"anns={self.anns!r} is not a registered backend; "
                             f"known: {sorted(known)}")

    def backend_config(self, name: str | None = None):
        """The config namespace for ``name`` (default: the active backend)."""
        from repro_torch.anns import registry

        return getattr(self, registry.canonical(name or self.anns))

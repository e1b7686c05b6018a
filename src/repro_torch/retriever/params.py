"""Typed, hashable search parameters (twin of ``repro/retriever/params.py``).

``resolve`` fills every ``None`` from the build config exactly as the JAX
package does: ``backend`` from the active backend's config namespace,
through the registry; :func:`effective_nprobe` is the IVF backend's probe
rule (``anns/backends.py:103-104``: ``None`` -> ``min(32, nlist)``, clamped
to ``nlist``), applied where the index's ``nlist`` is known.
"""
from __future__ import annotations

import dataclasses

from repro_torch.anns.params import (
    BackendSearchParams,
    IVFSearchParams,
    NoSearchParams,
    TokenPruningSearchParams,
)


def effective_nprobe(nprobe: int | None, nlist: int) -> int:
    return min(int(nprobe or min(32, nlist)), nlist)


@dataclasses.dataclass(frozen=True)
class SearchParams:
    k: int | None = None                        # final top-k (None => cfg.k)
    k_prime: int | None = None                  # rerank budget (None => cfg.k_prime)
    use_ann: bool = True                        # False => exact latent scan
    backend: BackendSearchParams | None = None  # typed per-backend knobs
    use_fused_gather: bool | None = None        # None => cfg.use_fused_gather
    use_one_launch: bool | None = None          # None => cfg.use_one_launch
    use_residual: bool | None = None            # None => cfg.residual.enabled

    def resolve(self, cfg, backend_name: str) -> "SearchParams":
        """Fill every ``None`` from the build config; ``TypeError`` when
        ``backend`` is typed for another backend than the active one."""
        from repro_torch.anns import registry

        be = registry.get_backend(backend_name)
        if not self.use_ann:
            bp = None
        elif self.backend is None:
            bp = be.default_params(cfg.backend_config(backend_name))
        elif not isinstance(self.backend, be.params_cls):
            raise TypeError(
                f"SearchParams.backend is {type(self.backend).__name__}, but "
                f"backend {be.name!r} takes {be.params_cls.__name__}")
        else:
            defaults = be.default_params(cfg.backend_config(backend_name))
            fill = {f.name: getattr(defaults, f.name)
                    for f in dataclasses.fields(self.backend)
                    if getattr(self.backend, f.name) is None}
            bp = dataclasses.replace(self.backend, **fill) if fill else self.backend
        return dataclasses.replace(
            self,
            k=int(self.k if self.k is not None else cfg.k),
            k_prime=int(self.k_prime if self.k_prime is not None else cfg.k_prime),
            backend=bp,
            use_fused_gather=bool(cfg.use_fused_gather if self.use_fused_gather is None
                                  else self.use_fused_gather),
            use_one_launch=bool(cfg.use_one_launch if self.use_one_launch is None
                                else self.use_one_launch),
            use_residual=bool(cfg.residual.enabled if self.use_residual is None
                              else self.use_residual),
        )


__all__ = ["SearchParams", "BackendSearchParams", "IVFSearchParams", "NoSearchParams",
           "TokenPruningSearchParams", "effective_nprobe"]

"""String-keyed backend registry (twin of ``repro/anns/registry.py``).

``LemurConfig.anns`` selects a first-stage retriever by name; the facade
resolves it here and never imports a concrete backend.  Each backend
registers its :class:`~repro_torch.anns.base.Retriever` instance, its
build-time config namespace (``config_cls``, the type of the matching
``LemurConfig`` field) and its query-time params type (``params_cls``).
The built-in backends register when :mod:`repro_torch.anns.backends` is
imported, which every lookup here does first.  ``"exact"`` aliases
``"bruteforce"``.
"""
from __future__ import annotations

from repro_torch.anns.base import Retriever
from repro_torch.anns.params import BackendConfig, BackendSearchParams, NoSearchParams

_REGISTRY: dict[str, Retriever] = {}
_CONFIGS: dict[str, type[BackendConfig]] = {}
_PARAMS: dict[str, type[BackendSearchParams]] = {}
_ALIASES = {"exact": "bruteforce"}


def register(backend):
    """Class decorator: instantiate and register under ``cls.name``, with the
    backend's config namespace and search-params types."""
    inst = backend() if isinstance(backend, type) else backend
    name = inst.name
    if name in _REGISTRY:
        raise ValueError(f"backend {name!r} already registered")
    _REGISTRY[name] = inst
    _CONFIGS[name] = getattr(inst, "config_cls", BackendConfig)
    _PARAMS[name] = getattr(inst, "params_cls", NoSearchParams)
    return backend


def _ensure_builtin() -> None:
    # late import: the backend modules import this one to register
    from repro_torch.anns import backends as _  # noqa: F401


def canonical(name: str) -> str:
    return _ALIASES.get(name, name)


def get_backend(name: str) -> Retriever:
    _ensure_builtin()
    name = canonical(name)
    if name not in _REGISTRY:
        raise KeyError(f"unknown anns backend {name!r}; known: {list_backends()}")
    return _REGISTRY[name]


def get_config_cls(name: str) -> type[BackendConfig]:
    """Build-time config namespace class for a backend name."""
    get_backend(name)
    return _CONFIGS[canonical(name)]


def get_params_cls(name: str) -> type[BackendSearchParams]:
    """Query-time params type for a backend name."""
    get_backend(name)
    return _PARAMS[canonical(name)]


def list_backends() -> list[str]:
    _ensure_builtin()
    return sorted(_REGISTRY)

"""Serving API of the port: :class:`LemurRetriever`, its typed
:class:`SearchParams` and the corpus-sharded :class:`ShardedLemurRetriever`,
the :class:`CorruptIndexError` a rejected refresh raises and the
per-backend config namespaces (the JAX package's ``repro.retriever``
surface)."""
from repro_torch.anns.params import (
    BruteforceBackendConfig,
    DessertBackendConfig,
    IVFBackendConfig,
    IVFSearchParams,
    MuveraBackendConfig,
    NoSearchParams,
    TokenPruningBackendConfig,
    TokenPruningSearchParams,
)
from repro_torch.retriever.facade import CorruptIndexError, LemurRetriever
from repro_torch.retriever.params import SearchParams
from repro_torch.retriever.sharded import ShardedLemurRetriever

__all__ = [
    "CorruptIndexError",
    "LemurRetriever",
    "ShardedLemurRetriever",
    "SearchParams",
    "IVFSearchParams",
    "NoSearchParams",
    "TokenPruningSearchParams",
    "BruteforceBackendConfig",
    "IVFBackendConfig",
    "MuveraBackendConfig",
    "DessertBackendConfig",
    "TokenPruningBackendConfig",
]

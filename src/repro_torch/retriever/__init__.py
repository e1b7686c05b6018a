"""Serving API of the port: :class:`LemurRetriever`, its typed
:class:`SearchParams` and the corpus-sharded :class:`ShardedLemurRetriever`
and the :class:`CorruptIndexError` a rejected refresh raises (the JAX
package's ``repro.retriever`` surface)."""
from repro_torch.anns.params import (
    IVFBackendConfig,
    IVFSearchParams,
    NoSearchParams,
    TokenPruningSearchParams,
)
from repro_torch.retriever.facade import CorruptIndexError, LemurRetriever
from repro_torch.retriever.params import SearchParams
from repro_torch.retriever.sharded import ShardedLemurRetriever

__all__ = ["CorruptIndexError", "IVFBackendConfig", "IVFSearchParams", "LemurRetriever",
           "NoSearchParams", "SearchParams", "ShardedLemurRetriever",
           "TokenPruningSearchParams"]

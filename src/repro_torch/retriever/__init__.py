"""Serving API of the port: :class:`LemurRetriever` and its typed
:class:`SearchParams` (the JAX package's ``repro.retriever`` surface)."""
from repro_torch.anns.params import IVFBackendConfig, IVFSearchParams
from repro_torch.retriever.facade import LemurRetriever
from repro_torch.retriever.params import SearchParams

__all__ = ["IVFBackendConfig", "IVFSearchParams", "LemurRetriever", "SearchParams"]

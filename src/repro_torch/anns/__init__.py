"""First-stage ANNS layer (the JAX package's ``repro.anns`` surface).

The functional modules (``bruteforce``, ``ivf``, ``muvera``, ``dessert``,
``token_pruning``) hold the algorithms; :mod:`repro_torch.anns.base` defines
the ``Retriever`` protocol they are adapted to in
:mod:`repro_torch.anns.backends`; :mod:`repro_torch.anns.registry` maps names
to backends.  The names below resolve on first access: ``core.pages``
imports ``anns.quantization``, and ``anns.ivf`` imports ``core.pages``, so
importing them here eagerly would close that cycle.  ``kmeans`` stays the
module (``anns.kmeans.kmeans`` the function), as the port's modules import it.
"""
import importlib

_EXPORTS = {
    "Retriever": "base", "CorpusView": "base", "QueryBatch": "base",
    "get_backend": "registry", "list_backends": "registry",
    "mips_topk": "bruteforce",
    "IVFIndex": "ivf", "build_ivf": "ivf", "extend_ivf": "ivf", "search_ivf": "ivf",
    "sq8_quant": "quantization", "sq8_dequant": "quantization",
    "DessertConfig": "dessert", "build_dessert": "dessert", "extend_dessert": "dessert",
    "search_dessert": "dessert",
    "MuveraConfig": "muvera", "doc_fde": "muvera", "query_fde": "muvera",
    "TokenPruningIndex": "token_pruning", "build_token_pruning": "token_pruning",
    "extend_token_pruning": "token_pruning", "search_token_pruning": "token_pruning",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)

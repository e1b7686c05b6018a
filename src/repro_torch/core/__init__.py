"""The paper's primary contribution, LEMUR (the JAX package's ``repro.core``
surface): multi-vector search reduced to multi-output regression
(``model.py``) and inference under that model to single-vector MIPS in the
latent space (``indexer.py`` learns the W rows, ``index.py`` serves them).

The names below resolve on first access: ``core.pages`` imports
``anns.quantization``, whose package reaches ``core`` modules, so importing
them here eagerly would close that cycle.  Where the port's form differs
from JAX's the name still resolves: ψ is the ``nn.Module`` ``Psi``, so
``init_psi(generator, d, d_prime, *, device)`` returns one, and
``init_phi``, ``psi_apply``, ``pool_queries`` and ``train_phi`` take or
give the port's forms (``core/model.py``).
"""
import importlib

_EXPORTS = {
    "LemurConfig": "config",
    "LemurIndex": "index", "build_index": "index",
    "maxsim_pair": "maxsim", "maxsim_scores": "maxsim", "recall_at": "maxsim",
    "rerank": "maxsim", "token_maxsim": "maxsim", "true_topk": "maxsim",
    "init_psi": "model", "init_phi": "model", "pool_queries": "model",
    "psi_apply": "model", "train_phi": "model",
    "fit_output_layer_ols": "indexer", "make_training_tokens": "indexer",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)

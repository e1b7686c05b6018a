"""LEMUR on PyTorch and CUDA (Hopper): the serving port of ``src/repro``.

The JAX package ``repro`` is the reference this package is held against; the
two share no code.  Modules mirror ``repro``'s names (``anns/ivf.py``,
``core/pages.py``, ``kernels/gather_scan.py`` …), so each counterpart is
found under the same path.  Every kernel of the serving path is CUDA C++
for ``sm_90a`` under ``csrc/``, built at first use by
:mod:`repro_torch.kernels.build`.  Entry points default to ``device="cuda"``
and raise without a card; the plain PyTorch versions serve CPU tensors only,
which callers ask for with ``device="cpu"``.
"""
import torch

# Probe selection, the flat top-k' and k-means assignment are argmaxes over
# fp32 products; TF32 keeps about three decimal digits and would flip them
# against the fp32 reference.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

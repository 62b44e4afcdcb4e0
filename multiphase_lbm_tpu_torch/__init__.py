"""PyTorch + CUDA port of :mod:`multiphase_lbm_tpu`.

The JAX package beside this one is the reference: every module here keeps
its counterpart's name and public functions on the same ``(Q, y, x)``
layout, so a reader can hold one against the other.  Plain functions on
tensors are the oracle paths; the hot path runs hand-written CUDA kernels
(``csrc/``, built on first use by :mod:`.ops._build`).

Importing the package never touches CUDA: kernels are built and loaded
only when a CUDA tensor first reaches a kernel wrapper.
"""

__version__ = "0.1.0"

from .core import precision as _precision

_precision.pin_float32_matmul()

from .core import lattice, streaming, collision, eos  # noqa: E402,F401

"""reflexiv_tpu_torch: the assembler's single-k path in PyTorch + CUDA.

A port of ``reflexiv_tpu`` (JAX) for NVIDIA Hopper: the same module names,
formats and results, with plain PyTorch on tensors and the two counting
kernels (canonical k-mer extraction, radix sort) written by hand in CUDA
C++ under ``csrc/``. It never imports jax. Every public entry takes an
explicit ``device``.
"""

from .params import Params

__version__ = "0.2.0"

__all__ = ["Params", "__version__"]

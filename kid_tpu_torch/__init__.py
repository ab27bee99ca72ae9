"""kid_tpu_torch — the KiD/Thompson09 microphysics framework in PyTorch,
with the hot microphysics step as a hand-written CUDA kernel for Hopper.

A port of the ``kid_tpu`` JAX package (which stays the reference).  It
imports torch, numpy and scipy only.  Entry points run on the CUDA card
unless the caller passes ``device="cpu"``, where the plain PyTorch version
of every kernel runs instead.
"""
from .config import MIXED1, WARM1, MicroConfig

__version__ = "0.1.0"
__all__ = ["MicroConfig", "MIXED1", "WARM1", "__version__"]

"""Sorts the device activities of a profiler trace into four classes by
name.  Any name that is none of the first three is the port's own, so a
new hand-written CUDA or Triton kernel counts as the port's without an
edit here."""
from __future__ import annotations

NCCL = "nccl"
COPY = "copy"
TORCH = "torch"
OWN = "own"
CLASSES = (OWN, TORCH, COPY, NCCL)


def kernel_class(name: str) -> str:
    """``nccl`` (a name with 'nccl', any case), ``copy`` (a Memcpy or
    Memset activity, or the driver's ``memcpy...`` kernels that copy
    inside a CUDA graph), ``torch`` (a name with 'at::') or ``own``."""
    low = name.lower()
    if "nccl" in low:
        return NCCL
    if low.startswith(("memcpy", "memset")):
        return COPY
    if "at::" in name:
        return TORCH
    return OWN

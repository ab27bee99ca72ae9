"""Device selection shared by the entry points."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises for a CUDA device when no
    card is present (the caller must then ask for ``device="cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch version on the CPU")
    return dev


def check_on(t: torch.Tensor, device) -> None:
    """Raise unless tensor ``t`` lies on ``device``."""
    dev = resolve_device(device)
    if t.device.type != dev.type or (dev.index is not None
                                     and t.device.index != dev.index):
        raise ValueError(f"tensor on {t.device}, expected {dev}")

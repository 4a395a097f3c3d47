"""Device selection for the port's entry points.

Every entry point that creates tensors takes ``device=``.  ``None`` means
the card: the port is written for an NVIDIA GPU, and running it on the
CPU is an explicit choice (the CPU tests pass ``device="cpu"``).  There
is no silent fallback: without a GPU, ``None`` raises.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises if no GPU); otherwise ``torch.device``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev

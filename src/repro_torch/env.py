"""Device selection for the port's entry points.

Every entry point takes an explicit ``device``; the default is ``"cuda"``.
Asking for CUDA on a machine without a card raises instead of quietly
running on the CPU — a CPU run is only ever what the caller asked for.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "DTYPE"]

# the main path's working precision (torch's own default is float32)
DTYPE = torch.float64


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """A concrete ``torch.device``; raises when CUDA is asked for but absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r} (cuda or cpu)")
    return dev

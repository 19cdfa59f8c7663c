"""Device selection for the port's entry points.

Entry points default to the card. Asking for ``"cuda"`` where there is no
card raises instead of quietly running on the CPU; the CPU is used only when
the caller names it.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev

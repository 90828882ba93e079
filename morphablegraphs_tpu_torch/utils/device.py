"""The device an entry point runs on: the CUDA device unless the caller
names another, and an error, not a quiet move to the CPU, when there is
no card."""

from __future__ import annotations

import torch


def resolve(device=None, who: str = "this function") -> torch.device:
    """torch.device(device), "cuda" when device is None; raises
    RuntimeError for a CUDA device when none is available."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who} runs on a CUDA device and none is "
                           "available; pass device='cpu' to run on the CPU")
    return dev

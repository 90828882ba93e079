"""The device an entry point runs on: the CUDA device unless the caller
names another, and an error, not a quiet move to the CPU, when there is
no card.  In a process of a group (`parallel.launch`, `torchrun`) that
sets `LOCAL_RANK`, "cuda" names that rank's card."""

from __future__ import annotations

import os

import torch


def resolve(device=None, who: str = "this function") -> torch.device:
    """torch.device(device), "cuda" when device is None; a CUDA device
    without an index is card LOCAL_RANK (modulo the visible cards) when
    LOCAL_RANK is set.  Raises RuntimeError for a CUDA device when none
    is available."""
    dev = torch.device(device or "cuda")
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(f"{who} runs on a CUDA device and none is "
                           "available; pass device='cpu' to run on the CPU")
    local = os.environ.get("LOCAL_RANK")
    if dev.index is None and local is not None:
        dev = torch.device("cuda", int(local) % torch.cuda.device_count())
    return dev

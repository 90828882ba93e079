"""Small constants of the ops as tensors, each made once per (values,
dtype, device) and then shared.  A host constant built into a new CUDA
tensor at every call is a synchronising copy, and a CUDA graph cannot
capture one (`ops.cuda_graphs`); the cached tensor holds the same values,
so every caller computes the same numbers as with a fresh one."""

from __future__ import annotations

import contextlib
import functools

import torch


@functools.lru_cache(maxsize=None)
def constant(values, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """`values` (a number or nested tuples of numbers) as a tensor on
    `device`, the same object at every call with these arguments: callers
    never write into it.  Made outside inference mode, so that autograd may
    save it wherever it is used, and outside any torch.func transform
    (`plain`)."""
    with plain():
        return torch.tensor(values, dtype=dtype, device=device)


@contextlib.contextmanager
def plain():
    """A context in which a new tensor is a plain one, to be cached: outside
    inference mode, and outside any torch.func transform the caller runs
    under (a tensor made inside `jvp` is that level's wrapper, which keeps
    no storage once the transform returns)."""
    with torch.inference_mode(False), torch._C._DisableFuncTorch():
        yield

"""Profiling and tracing hooks (port of morphablegraphs_tpu.utils.profiling).

The reference has only wall-clock spans around synthesis
(motion_generator.py:124-147); `Timer` keeps those spans with counters,
`device_trace` records a torch.profiler trace of the host and, when a card
is present, of the CUDA device, and `annotate` labels a region inside it.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch


class Timer:
    """Named wall-clock spans + counters (reference's per-step timing and
    objective-evaluation accounting in one place)."""

    def __init__(self):
        self.spans: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans[name] = self.spans.get(name, 0.0) + time.perf_counter() - t0

    def count(self, name: str, n: int = 1):
        self.counts[name] = self.counts.get(name, 0) + n

    def report(self) -> str:
        lines = [f"{k}: {v:.4f}s" for k, v in sorted(self.spans.items())]
        lines += [f"{k}: {v}" for k, v in sorted(self.counts.items())]
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """A torch.profiler trace of the block, written into log_dir as a
    Chrome trace (TensorBoard's torch-tb-profiler reads the directory);
    the CUDA activity is recorded when a card is present.  No-op when
    log_dir is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def annotate(name: str):
    """A named range inside traces (torch.profiler.record_function)."""
    return torch.profiler.record_function(name)

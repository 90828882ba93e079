"""The traced run's record and what the per-layer readers share.

`record` turns a `torch.profiler` trace into a plain dict (JSON-able, so
that tests can hold a small recorded one):

* kernels: [name, start ns, duration ns, correlation id, linked id] of
  every device operation;
* launches: {correlation id: host ns} of the host events (torch ops and
  CUDA runtime calls), so a kernel is placed at the host time it was
  launched;
* ranges: [name, start ns, end ns] of the program's `walk.*` and
  `request.*` host ranges;
* window: [start ns, end ns] of the traced walks (the harness's own
  `portbench.window` range);
* the harness adds walks, frames, wall_per_walk_s (from the untraced
  window), shapes and b1 (the selection launches' counts)."""

from __future__ import annotations

import bisect

PREFIXES = ("walk.", "request.")
WINDOW = "portbench.window"


def record(prof) -> dict:
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    kernels, launches, ranges, window = [], {}, [], None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            if not name.startswith(PREFIXES) and name != WINDOW:
                kernels.append([name, e.start_ns(), e.duration_ns(),
                                e.correlation_id(),
                                e.linked_correlation_id()])
            continue
        if name == WINDOW:
            window = [e.start_ns(), e.end_ns()]
        elif name.startswith(PREFIXES):
            ranges.append([name, e.start_ns(), e.end_ns()])
        elif e.correlation_id():
            launches.setdefault(e.correlation_id(), e.start_ns())
    wanted = {k[3] for k in kernels} | {k[4] for k in kernels}
    return {"kernels": kernels, "ranges": sorted(ranges, key=lambda r: r[1]),
            "launches": {str(k): v for k, v in launches.items()
                         if k in wanted},
            "window": window}


def in_window(rec: dict) -> list:
    lo, hi = rec["window"]
    return [k for k in rec["kernels"] if lo <= k[1] <= hi]


def busy_ns(rec: dict) -> int:
    """Nanoseconds of the window in which some device operation ran (the
    union of their intervals)."""
    lo, hi = rec["window"]
    spans = sorted((max(k[1], lo), min(k[1] + k[2], hi))
                   for k in in_window(rec))
    busy, end = 0, lo
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def launch_ns(rec: dict, kernel) -> int | None:
    """The host time a kernel was launched: its own correlation id's host
    event, else the linked one's."""
    for key in (kernel[3], kernel[4]):
        t = rec["launches"].get(str(key))
        if key and t is not None:
            return t
    return None


def range_of(rec: dict, t) -> str | None:
    """The name of the host range open at host time t, if any."""
    if t is None:
        return None
    if "_starts" not in rec:
        rec["_starts"] = [r[1] for r in rec["ranges"]]
    i = bisect.bisect_right(rec["_starts"], t) - 1
    if i >= 0 and t < rec["ranges"][i][2]:
        return rec["ranges"][i][0]
    return None


def range_host_ms(rec: dict, name: str) -> float:
    """Host milliseconds inside ranges of this name."""
    return sum(r[2] - r[1] for r in rec["ranges"] if r[0] == name) / 1e6


def range_device_ms(rec: dict, name: str) -> float | None:
    """Device milliseconds of the kernels launched inside ranges of this
    name; None where no kernel could be placed at its launch."""
    placed, ms = False, 0.0
    for k in in_window(rec):
        t = launch_ns(rec, k)
        if t is not None:
            placed = True
            if range_of(rec, t) == name:
                ms += k[2] / 1e6
    return ms if placed else None


def placement(rec: dict) -> dict:
    """How many of the window's device operations could be placed at
    their launch, and in which host range -> {range name or "outside" or
    "unplaced": count}."""
    out = {}
    for k in in_window(rec):
        t = launch_ns(rec, k)
        where = "unplaced" if t is None else (range_of(rec, t) or "outside")
        out[where] = out.get(where, 0) + 1
    return out


def kernel_ms(rec: dict, marker: str) -> list:
    """Durations (ms) of the device operations whose name holds marker."""
    return [k[2] / 1e6 for k in in_window(rec) if marker in k[0]]


def breakdown(rec: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the device's idle
    time by the host range open when each gap began ("outside" where
    none), each list its `top` largest [name, seconds]."""
    ops = {}
    for k in in_window(rec):
        ops[k[0]] = ops.get(k[0], 0) + k[2]
    lo, hi = rec["window"]
    spans = sorted((k[1], k[1] + k[2]) for k in in_window(rec))
    gaps, end = {}, lo
    for s, e in spans + [(hi, hi)]:
        if s > end:
            where = range_of(rec, end) or "outside"
            gaps[where] = gaps.get(where, 0) + s - end
        end = max(end, e)
    return {"device_ops": [[n[:120], v / 1e9] for n, v in sorted(
                ops.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[n, v / 1e9] for n, v in sorted(
                gaps.items(), key=lambda kv: -kv[1])[:top]]}

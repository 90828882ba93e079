"""What the PFNN readers share: the program tracer's `pfnn.*` spans in the
profiled crowd walks, and the device time of the kernels launched inside
them whose name holds a marker.

The tracer keeps every span's host interval on `time.time_ns()`, the clock
of the trace's host events, so a kernel belongs to a span when the host
event that launched it (its correlation id's, `trace.launch_ns`) lies in
that span.  A frame step replayed as a CUDA graph has no `pfnn.net` span
of its own: its kernels are all launched from the one graph launch inside
`pfnn.frame`."""

from __future__ import annotations

import bisect

from . import program, trace

ENTRY = "pfnn_crowd"


def profiled_spans(snap: dict | None, name: str) -> list:
    """[start ns, end ns] of the `name` spans of the profiled `pfnn_crowd`
    walks, sorted."""
    if snap is None:
        return []
    roots = {r["id"] for r in snap["roots"]
             if r["name"] == ENTRY and r["profiled"]}
    return sorted([s[2], s[3]] for s in snap["spans"]
                  if s[1] == name and s[5] in roots)


def device_ms_in(rec: dict, spans: list, marker: str) -> float | None:
    """Device milliseconds of the window's kernels whose name holds marker
    launched inside spans; None where none was."""
    starts = [s[0] for s in spans]
    ms, found = 0.0, False
    for k in trace.in_window(rec):
        if marker not in k[0]:
            continue
        t = trace.launch_ns(rec, k)
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= spans[i][1]:
            ms += k[2] / 1e6
            found = True
    return ms if found else None


def net_spans(rec: dict) -> tuple:
    """(the spans that hold the network's kernels, how many frames they
    cover): the `pfnn.net` spans where the step ran eagerly, else the
    `pfnn.frame` spans."""
    snap = program.snapshot(rec)
    frames = profiled_spans(snap, "pfnn.frame")
    nets = profiled_spans(snap, "pfnn.net")
    return (nets, len(nets)) if nets else (frames, len(frames))

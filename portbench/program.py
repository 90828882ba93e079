"""What the program's own tracer (`morphablegraphs_tpu_torch.utils.
profiling`) holds in this process, for the readers of its spans and
counters.

The tracer keeps every walk's spans in memory: the walk is a root span
(`crowd`, `random_walk`) and its stages (`walk.*`) carry the root's id.
Roots that start while a torch.profiler records are marked `profiled` and
count their synchronising CUDA calls and the caching allocator's device
calls (`cuda.syncs`, `cuda.mallocs`).  The harness runs the warm walk, the
untraced window and then the traced walks in one process, so the roots
before the first profiled one, less the first (the warm walk), are the
window's walks.

`snapshot(rec)` is the tracer's snapshot, read once a record (a recorded
one stands under rec["program"]); a program without the tracer gives None,
and so does every reader then."""

from __future__ import annotations

import statistics

# the entry points' root spans, one per walk
ENTRIES = ("crowd", "random_walk")


def snapshot(rec: dict) -> dict | None:
    if "program" not in rec:
        try:
            from morphablegraphs_tpu_torch.utils import profiling
            read = getattr(profiling, "snapshot", None)
        except ImportError:
            read = None
        rec["program"] = read() if read is not None else None
    return rec["program"]


def _complete(snap: dict):
    """root -> whether the ring still holds all of its spans (the ring
    drops the spans that ended first)."""
    if not snap["dropped"] or not snap["spans"]:
        return lambda root: True
    oldest_end = snap["spans"][0][3]
    return lambda root: root["start_ns"] >= oldest_end


def window_roots(snap: dict | None, entry: str) -> list:
    """The untraced roots of `entry` before its first profiled one, less
    the first of all (the warm walk), whose spans the ring holds."""
    if snap is None:
        return []
    roots = sorted((r for r in snap["roots"] if r["name"] == entry),
                   key=lambda r: r["id"])
    traced = [r["id"] for r in roots if r["profiled"]]
    first_traced = traced[0] if traced else float("inf")
    complete = _complete(snap)
    return [r for r in roots[1:]
            if not r["profiled"] and r["id"] < first_traced and complete(r)]


def stage_host_ms(snap: dict | None, entry: str, stage: str) -> float | None:
    """The median over the window's walks of the host milliseconds inside
    a walk's `stage` spans; None without such walks."""
    roots = window_roots(snap, entry)
    if not roots:
        return None
    ns = {r["id"]: 0 for r in roots}
    for s in snap["spans"]:
        if s[1] == stage and s[5] in ns:
            ns[s[5]] += s[3] - s[2]
    return statistics.median(ns.values()) / 1e6


def traced_count(snap: dict | None, counter: str, walks) -> float | None:
    """An armed counter summed over the profiled roots of the entry points,
    over `walks`; None without such roots."""
    if snap is None or not walks:
        return None
    ids = {r["id"] for r in snap["roots"]
           if r["name"] in ENTRIES and r["profiled"] and r["armed"]}
    if not ids:
        return None
    total = sum((s[6] or {}).get(counter, 0) for s in snap["spans"]
                if s[5] in ids)
    return total / walks

"""What the program's tracer holds of the service's requests, for the
readers of the service cell (`program.py` reads the walks' roots).

Each request is a root span `serve.request` (the dispatcher's), and the
request path's stages are spans under it (`generate`, and per step
`request.plan`, `request.select`, `request.lm`, `request.emit`; per request
`request.convert`, `request.ik`) carrying its id.  The request path counts
its steps (`request.steps`) and, inside `request.ik`, its IK targets
(`request.ik.constraints`), in every request.  The harness runs the
warm-up requests, the untraced window and then the traced requests in one
process, so the roots before the first profiled one, less the first `warm`
(the driver's `shapes()["service"]["warm"]`), are the window's requests.

A request's length (5 to 20 steps here) sets its stages' time, so the
readers read per step (per IK target for the IK), never per request: a
window holds only 3 to 6 requests, and which ones a seed puts there would
move a per-request reading more than the layer does.  Every reader gives
None where the tracer holds nothing to read, so also for a program
without the tracer or without the counters."""

from __future__ import annotations

import statistics

ROOT = "serve.request"
STEPS, TARGETS = "request.steps", "request.ik.constraints"


def warm(rec: dict) -> int | None:
    return rec.get("shapes", {}).get("service", {}).get("warm")


def window_roots(snap: dict | None, n_warm: int | None) -> list:
    """The untraced request roots before the first profiled one, less the
    first n_warm, whose spans the ring still holds."""
    if snap is None or n_warm is None:
        return []
    roots = sorted((r for r in snap["roots"] if r["name"] == ROOT),
                   key=lambda r: r["id"])
    traced = [r["id"] for r in roots if r["profiled"]]
    first_traced = traced[0] if traced else float("inf")
    # the ring drops the spans that ended first
    oldest = snap["spans"][0][3] if snap["dropped"] and snap["spans"] \
        else None
    return [r for r in roots[n_warm:]
            if not r["profiled"] and r["id"] < first_traced
            and (oldest is None or r["start_ns"] >= oldest)]


def _counted(snap: dict, ids, counter: str) -> dict:
    """root id -> `counter` summed over its spans."""
    out = dict.fromkeys(ids, 0)
    for s in snap["spans"]:
        if s[5] in out:
            out[s[5]] += (s[6] or {}).get(counter, 0)
    return out


def step_host_ms(snap: dict | None, n_warm, stage: str,
                 per: str | None = None) -> float | None:
    """The median over the window's `stage` spans of each span's host
    milliseconds (divided by its own count of `per`, where given); None
    without such spans."""
    ids = {r["id"] for r in window_roots(snap, n_warm)}
    values = []
    for s in snap["spans"] if ids else ():
        if s[1] == stage and s[5] in ids:
            n = 1 if per is None else (s[6] or {}).get(per, 0)
            if n:
                values.append((s[3] - s[2]) / n)
    return statistics.median(values) / 1e6 if values else None


def edge_host_ms(snap: dict | None, n_warm) -> float | None:
    """The median over the window's requests of the root's host
    milliseconds outside its `generate` span (parsing, the events, the BVH
    export and the dispatch) over its steps; None without such
    requests."""
    roots = window_roots(snap, n_warm)
    if not roots:
        return None
    ids = [r["id"] for r in roots]
    gen = {i: 0 for i in ids}
    for s in snap["spans"]:
        if s[1] == "generate" and s[5] in gen:
            gen[s[5]] += s[3] - s[2]
    steps = _counted(snap, ids, STEPS)
    values = [(r["end_ns"] - r["start_ns"] - gen[r["id"]]) / steps[r["id"]]
              for r in roots if gen[r["id"]] and steps[r["id"]]]
    return statistics.median(values) / 1e6 if values else None


def window_counts(snap: dict | None, n_warm) -> dict | None:
    """{requests, steps, targets}: the window's requests, their steps and
    their IK targets; None without a request that counted its steps."""
    ids = [r["id"] for r in window_roots(snap, n_warm)]
    if not ids:
        return None
    steps = sum(_counted(snap, ids, STEPS).values())
    if not steps:
        return None
    return dict(requests=len(ids), steps=steps,
                targets=sum(_counted(snap, ids, TARGETS).values()))


def traced_per_step(snap: dict | None, counter: str) -> float | None:
    """An armed counter summed over the profiled request roots and their
    spans, over their steps; None without such roots."""
    if snap is None:
        return None
    ids = [r["id"] for r in snap["roots"]
           if r["name"] == ROOT and r["profiled"] and r["armed"]]
    steps = sum(_counted(snap, ids, STEPS).values())
    if not steps:
        return None
    return sum(_counted(snap, ids, counter).values()) / steps

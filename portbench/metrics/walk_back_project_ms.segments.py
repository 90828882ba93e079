"""Device milliseconds per walk of the kernels launched inside the
program's `walk.back_project` ranges of the random walks: the time warp
and the frame-emit kernel."""

from portbench import trace


def read(rec):
    if not any(r[0] == "walk.back_project" for r in rec["ranges"]):
        return None
    ms = trace.range_device_ms(rec, "walk.back_project")
    return None if ms is None else ms / rec["walks"]

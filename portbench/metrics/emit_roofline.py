"""The frame-emit kernel's share of its roofline: the least time a walk's
launches could take on an H100 (`counts.emit`, at each step's shape) over
their mean duration in the trace, in % (`emit_roofline.<cell kind>`)."""

from portbench import trace
from portbench.counts import emit


def read(rec):
    times = trace.kernel_ms(rec, "emit_frames_kernel")
    shapes = rec.get("shapes", {}).get("emit")
    if not times or not shapes:
        return None
    bound = sum(emit.bound_ms(**s) for s in shapes) / len(shapes)
    return 100.0 * bound / (sum(times) / len(times))

"""Kernel B1's share of its roofline: the least time its launches could
take on an H100 (`counts.b1`, on the inputs each traced launch was
given) over their mean duration in the trace, in %."""

from portbench import trace
from portbench.counts import b1


def read(rec):
    times = trace.kernel_ms(rec, "score_loco_kernel")
    if not times or not rec.get("b1"):
        return None
    bound = sum(b1.bound_ms(*launch) for launch in rec["b1"]) / len(rec["b1"])
    return 100.0 * bound / (sum(times) / len(times))

"""A whole request's share of the H100's float32 peak: the operations of
the untraced window's requests (`counts.request.flops` at their mean
steps and IK targets from the program's tracer, and the mean frames a
request answered) over the window's wall time per request times 67
TFLOP/s, in %."""

from portbench import program, service_program as sp
from portbench.counts import peaks, request


def read(rec):
    shapes = rec.get("shapes", {}).get("request")
    wall = rec.get("wall_per_walk_s")
    got = sp.window_counts(program.snapshot(rec), sp.warm(rec))
    if not shapes or not wall or got is None:
        return None
    n = got["requests"]
    ops = request.flops(steps=got["steps"] / n, ik=got["targets"] / n,
                        **shapes)
    return 100.0 * ops / (wall * peaks.FP32_FLOPS_PER_S)

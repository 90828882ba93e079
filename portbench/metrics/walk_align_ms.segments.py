"""Device milliseconds per walk of the kernels launched inside the
program's `walk.align` ranges: the random walks' chained boundary
transforms and their seam pass."""

from portbench import trace


def read(rec):
    if not any(r[0] == "walk.align" for r in rec["ranges"]):
        return None
    ms = trace.range_device_ms(rec, "walk.align")
    return None if ms is None else ms / rec["walks"]

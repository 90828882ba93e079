"""Host milliseconds per walk inside the program's `walk.select` ranges:
the crowd step's candidate ranking (the selection operator and kernel
B1)."""

from portbench import trace


def read(rec):
    if not any(r[0] == "walk.select" for r in rec["ranges"]):
        return None
    return trace.range_host_ms(rec, "walk.select") / rec["walks"]

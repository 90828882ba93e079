"""The caching allocator's device allocations (cudaMalloc) per traced walk,
counted by the program's tracer inside the profiled walks
(`cuda.mallocs`), `device_mallocs_per_walk.<cell kind>`."""

from portbench import program


def read(rec):
    return program.traced_count(program.snapshot(rec), "cuda.mallocs",
                                rec.get("walks"))

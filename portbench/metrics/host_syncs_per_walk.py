"""Synchronising CUDA calls per traced walk, counted by the program's
tracer inside the profiled walks (`cuda.syncs`; each one's call site is in
the tracer's `syncs`), `host_syncs_per_walk.<cell kind>`."""

from portbench import program


def read(rec):
    return program.traced_count(program.snapshot(rec), "cuda.syncs",
                                rec.get("walks"))

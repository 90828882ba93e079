"""Synchronising CUDA calls per step of the traced requests: the program
tracer's `cuda.syncs` inside the profiled `serve.request` roots over those
requests' steps (`request.steps`)."""

from portbench import program, service_program as sp


def read(rec):
    return sp.traced_per_step(program.snapshot(rec), "cuda.syncs")

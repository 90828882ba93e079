"""Replays of the request path's exact LM as one CUDA graph per step of
the traced requests: the program tracer's `request.lm.graph_replays`
inside the profiled `serve.request` roots over those requests' steps
(`request.steps`); 0 from a program that counts no replay."""

from portbench import program, service_program as sp


def read(rec):
    return sp.traced_per_step(program.snapshot(rec),
                              "request.lm.graph_replays")

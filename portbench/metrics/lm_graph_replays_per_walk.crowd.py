"""Replays of the crowd walk's LM stage as one CUDA graph per traced walk,
counted by the program's tracer inside the profiled walks' `walk.lm` spans
(`walk.lm.graph_replays`), `lm_graph_replays_per_walk.crowd`; 0 from a
program that counts none."""

from portbench import program


def read(rec):
    return program.traced_count(program.snapshot(rec),
                                "walk.lm.graph_replays", rec.get("walks"))

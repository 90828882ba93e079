"""Host milliseconds inside the `walk.lm` spans of one crowd walk of the
untraced window, the median over its walks, from the program's tracer
(the profiler-based `walk_lm_ms.crowd` reads the same spans ~2x
inflated)."""

from portbench import program


def read(rec):
    return program.stage_host_ms(program.snapshot(rec), "crowd", "walk.lm")

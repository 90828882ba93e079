"""Host milliseconds inside the `walk.align` span of one batch of random
walks of the untraced window, the median over its batches, from the
program's tracer: the seam pass's host time, waits included."""

from portbench import program


def read(rec):
    return program.stage_host_ms(program.snapshot(rec), "random_walk",
                                 "walk.align")

"""Host milliseconds of one step's `request.lm` span (the exact LM, its
waits included), the median over the steps of the untraced window's
requests after the warm-up, from the program's tracer."""

from portbench import program, service_program as sp


def read(rec):
    return sp.step_host_ms(program.snapshot(rec), sp.warm(rec), "request.lm")

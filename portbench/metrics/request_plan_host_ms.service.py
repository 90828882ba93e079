"""Host milliseconds of one step's `request.plan` span (the start node or
the transition), the median over the steps of the untraced window's
requests after the warm-up, from the program's tracer."""

from portbench import program, service_program as sp


def read(rec):
    return sp.step_host_ms(program.snapshot(rec), sp.warm(rec),
                           "request.plan")

"""Host milliseconds of rank 0's `crowd.gather` span (the sharded crowd's
output all_gathers), the median over the untraced window's walks; None
where the program records no such span."""

from portbench import program


def read(rec):
    return program.stage_host_ms(program.snapshot(rec), "crowd.gather",
                                 "crowd.gather")

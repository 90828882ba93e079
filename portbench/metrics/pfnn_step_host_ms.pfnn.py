"""Host milliseconds of one frame's step (the program's `pfnn.frame`
span), the median over the untraced window's walks of each walk's total
over its frames."""

from portbench import pfnn_program, program


def read(rec):
    shapes = rec.get("shapes", {}).get("pfnn")
    ms = program.stage_host_ms(program.snapshot(rec), pfnn_program.ENTRY,
                               "pfnn.frame")
    if not shapes or ms is None:
        return None
    return ms / shapes["frames"]

"""Host milliseconds of the keyframe IK and its blend per IK target: each
`request.ik` span of the untraced window's requests after the warm-up over
the targets it counted (`request.ik.constraints`), the median over the
window's requests that have keyframes (the action requests), from the
program's tracer."""

from portbench import program, service_program as sp


def read(rec):
    return sp.step_host_ms(program.snapshot(rec), sp.warm(rec), "request.ik",
                           per=sp.TARGETS)

"""Host milliseconds of the service's own part of a request (parsing, the
events, the BVH export, the dispatch: the `serve.request` root outside its
`generate` span) per step of the request, the median over the untraced
window's requests after the warm-up, from the program's tracer."""

from portbench import program, service_program as sp


def read(rec):
    return sp.edge_host_ms(program.snapshot(rec), sp.warm(rec))

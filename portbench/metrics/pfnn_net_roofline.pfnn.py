"""The PFNN's share of its roofline: the least time the three
phase-functioned layers of the traced walk's frames could take on an H100
(`counts.pfnn`, at the walk's shapes) over the device time of the layers'
matrix products, the GEMM kernels (`gemm` in the name) launched inside the
program's `pfnn.net` spans (or, where the frame step replays a CUDA graph,
its `pfnn.frame` spans), in %.  The controller's arithmetic around them
in the frame is not the layers' and is left out; the path query's small
products (K = 4), which cuBLAS also runs as GEMMs, are not told apart and
count with the layers' (about 2% of the frame's GEMM time on an H100), so
the share reads a little low, never high."""

from portbench import pfnn_program
from portbench.counts import pfnn

GEMM = "gemm"


def read(rec):
    shapes = rec.get("shapes", {}).get("pfnn")
    if not shapes:
        return None
    spans, frames = pfnn_program.net_spans(rec)
    ms = pfnn_program.device_ms_in(rec, spans, GEMM) if spans else None
    if not ms:
        return None
    bound = pfnn.net_bound_ms(shapes["n"], shapes["x"], shapes["h"],
                              shapes["y"], shapes["p"])
    return 100.0 * bound * frames / ms

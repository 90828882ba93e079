"""A whole crowd walk's share of the H100's float32 peak: the operations
one walk needs (`counts.walk.crowd_flops`, from its shapes and the rows
its selection launches read) over the untraced window's wall time per
walk times 67 TFLOP/s, in %."""

from portbench.counts import b1, peaks, walk


def read(rec):
    shapes = rec.get("shapes", {}).get("walk")
    wall = rec.get("wall_per_walk_s")
    if not shapes or not wall or not rec.get("b1"):
        return None
    b1_flops = sum(b1.count(*launch)[0] for launch in rec["b1"])
    flops = walk.crowd_flops(**shapes, b1_flops=b1_flops / rec["walks"])
    return 100.0 * flops / (wall * peaks.FP32_FLOPS_PER_S)

"""A whole batch of random walks' share of the H100's float32 peak: the
operations it needs (`counts.walk.segments_flops`, from its shapes) over
the untraced window's wall time per batch times 67 TFLOP/s, in %."""

from portbench.counts import peaks, walk


def read(rec):
    shapes = rec.get("shapes", {}).get("segments")
    wall = rec.get("wall_per_walk_s")
    if not shapes or not wall:
        return None
    flops = walk.segments_flops(**shapes)
    return 100.0 * flops / (wall * peaks.FP32_FLOPS_PER_S)

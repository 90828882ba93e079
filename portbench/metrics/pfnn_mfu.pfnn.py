"""A whole PFNN crowd walk's share of the H100's float32 peak: the
network's operations of one walk (`counts.pfnn.walk_flops`, every
character's every frame) over the untraced window's wall time per walk
times 67 TFLOP/s, in %."""

from portbench.counts import peaks, pfnn


def read(rec):
    shapes = rec.get("shapes", {}).get("pfnn")
    wall = rec.get("wall_per_walk_s")
    if not shapes or not wall:
        return None
    return 100.0 * pfnn.walk_flops(**shapes) / (wall
                                                 * peaks.FP32_FLOPS_PER_S)

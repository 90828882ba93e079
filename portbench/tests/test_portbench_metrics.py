"""Each per-layer reader on a small recorded trace, and the breakdown."""

import pytest

from portbench import harness, trace
from portbench.counts import emit, peaks

# [name, start ns, duration ns, correlation id, linked id]
RECORD = {
    "kernels": [["void score_loco_kernel<false, 4>(...)", 1000, 100, 11, 1],
                ["emit_frames_kernel", 1200, 50, 12, 0],
                ["elementwise_kernel", 1300, 200, 13, 2],
                ["elementwise_kernel", 1600, 100, 14, 3],
                ["elementwise_kernel", 2500, 100, 15, 4]],  # after the window
    "launches": {"11": 950, "12": 1150, "2": 1250, "3": 1550, "4": 2450},
    "ranges": [["walk.select", 900, 1000], ["walk.back_project", 1100, 1200],
               ["walk.lm", 1200, 1500], ["walk.align", 1500, 1700]],
    "window": [900, 1900], "walks": 2, "frames": 4000.0,
    "wall_per_walk_s": 0.5,
    "shapes": {"emit": [dict(c=1, t=2, k=1, m=1, nb=1, d=7, has_prev=False,
                             window=20)],
               "segments": dict(c=1, steps=1, k=1, k_t=1, l_dim=2, nb=1,
                                d=7, m=1, t=2, f=3, window=20)},
    "b1": [[1, 128, 25, 264, 48, 1000]],
}

EXPECTED = {
    "walk_lm_ms.crowd": 300 / 2 / 1e6,
    "walk_select_ms.crowd": 100 / 2 / 1e6,
    "walk_align_ms.segments": 100 / 2 / 1e6,
    "walk_back_project_ms.segments": 50 / 2 / 1e6,
    "device_idle.crowd": 100.0 * (1 - 450 / 1000),
    "device_idle.segments": 100.0 * (1 - 450 / 1000),
    "launches_per_kframe.crowd": 4 / 4.0,
    "launches_per_kframe.segments": 4 / 4.0,
    # 180 bytes (latents 1, eigen 7, mean 7, knots 5, ids 2, frame count 1,
    # times 2, clips 14, last frame 7: x4) over 3.35 TB/s, per 50 ns
    "emit_roofline.crowd": 100.0 * (180 / 3.35e12 * 1e3) / 5e-5,
    "emit_roofline.segments": 100.0 * (180 / 3.35e12 * 1e3) / 5e-5,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader(name):
    assert harness.reader(name)(dict(RECORD)) == pytest.approx(
        EXPECTED[name], rel=1e-9)


def test_roofline_and_mfu_readers():
    b1_share = harness.reader("b1_roofline")(dict(RECORD))
    c, n, k = 1, 128, 25
    flops = 9 * 1000 + c * n * 2 * (k + 1) * 60
    n_bytes = 4 * (19 * 8 * 26 + 128 * 25 + 264 * 5 + 48 + 128)
    want = max(flops / 67e12, n_bytes / 3.35e12) * 1e3 / 1e-4
    assert b1_share == pytest.approx(100.0 * want, rel=1e-9)
    assert harness.reader("walk_mfu.crowd")(dict(RECORD)) is None
    mfu = harness.reader("walk_mfu.segments")(dict(RECORD))
    # one step of one character: a draw (8), the warp (6 + 9 + 80), the
    # alignment (40 + 294 + 28) and the clip (14 + 2 * 86)
    assert mfu == pytest.approx(100.0 * 651 / (0.5 * peaks.FP32_FLOPS_PER_S),
                                rel=1e-9)
    assert emit.count(1, 2, 1, 1, 1, 7, False) == (186, 180)


def test_readers_find_nothing_to_read():
    empty = {"kernels": [], "launches": {}, "ranges": [], "window": [0, 1],
             "walks": 1, "frames": 0.0}
    for name in list(EXPECTED) + ["b1_roofline", "walk_mfu.crowd",
                                  "walk_mfu.segments"]:
        assert harness.reader(name)(dict(empty)) is None, name


def test_breakdown():
    out = trace.breakdown(dict(RECORD))
    assert out["device_ops"][0] == ["elementwise_kernel", 300 / 1e9]
    assert [n for n, _ in out["device_ops"]] == [
        "elementwise_kernel", "void score_loco_kernel<false, 4>(...)",
        "emit_frames_kernel"]
    assert dict(out["idle_gaps"]) == pytest.approx({
        "outside": 200e-9, "walk.select": 100e-9,
        "walk.back_project": 100e-9, "walk.align": 100e-9,
        "walk.lm": 50e-9})

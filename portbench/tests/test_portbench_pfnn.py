"""The PFNN cell's and the four-card crowd's readers and counts on small
recorded traces, and both cells at a tiny size through the harness on the
CPU (the four-card crowd over four gloo ranks)."""

import pytest

from portbench import harness
from portbench.counts import peaks, pfnn

import helpers

SHAPES = dict(n=2, frames=3, x=342, h=512, y=311, p=4)


def _span(sid, name, start, end, root):
    return [sid, name, start, end, root if sid != root else None, root, None]


# two walks: root 1 the warm walk, root 10 the window's, root 20 traced
PROGRAM = {
    "dropped": 0,
    "roots": [dict(id=1, name="pfnn_crowd", start_ns=0, end_ns=50,
                   profiled=False, armed=False),
              dict(id=10, name="pfnn_crowd", start_ns=100, end_ns=200,
                   profiled=False, armed=False),
              dict(id=20, name="pfnn_crowd", start_ns=1000, end_ns=2000,
                   profiled=True, armed=True),
              dict(id=30, name="crowd.gather", start_ns=3000, end_ns=3004,
                   profiled=False, armed=False),
              dict(id=31, name="crowd.gather", start_ns=3100, end_ns=3106,
                   profiled=False, armed=False),
              dict(id=32, name="crowd.gather", start_ns=3200, end_ns=3210,
                   profiled=False, armed=False)],
    "spans": [_span(2, "pfnn.frame", 10, 20, 1),
              _span(11, "pfnn.frame", 110, 130, 10),
              _span(12, "pfnn.frame", 130, 160, 10),
              _span(13, "pfnn.frame", 160, 170, 10),
              _span(21, "pfnn.frame", 1000, 1100, 20),
              _span(22, "pfnn.frame", 1100, 1200, 20),
              _span(23, "pfnn.frame", 1200, 1300, 20),
              _span(30, "crowd.gather", 3000, 3004, 30),
              _span(31, "crowd.gather", 3100, 3106, 31),
              _span(32, "crowd.gather", 3200, 3210, 32)],
}
RECORD = {
    # GEMMs launched in the traced frames (1050, 1150, 1250), one
    # elementwise kernel in the first (1060) and a GEMM outside them (1350)
    "kernels": [["sgemm", 1060, 400, 1, 0], ["sgemm", 1160, 400, 2, 0],
                ["sgemm", 1260, 400, 3, 0], ["sgemm", 1360, 100, 4, 0],
                ["elementwise_kernel", 1070, 300, 5, 0]],
    "launches": {"1": 1050, "2": 1150, "3": 1250, "4": 1350, "5": 1060},
    "ranges": [], "window": [1000, 2000], "walks": 1, "frames": 6.0,
    "wall_per_walk_s": 0.01, "shapes": {"pfnn": SHAPES},
    "program": PROGRAM,
}


def test_network_counts_at_published_widths():
    flops, n_bytes = pfnn.net(1, 342, 512, 311, 4)
    assert flops == 8 * (342 * 512 + 512 * 512 + 512 * 311) \
        + 12 * (512 + 512 + 311) == 4787860
    weights = 4 * (342 * 512 + 512 * 512 + 512 * 311) + 4 * (512 + 512
                                                              + 311)
    assert n_bytes == 4 * (weights + 342 + 512 + 512 + 512 + 512 + 311)
    # 4096 characters: compute-bound, 19.6 GFLOP over 67 TFLOP/s
    assert pfnn.net_bound_ms(4096, 342, 512, 311, 4) == pytest.approx(
        4096 * 4787860 / peaks.FP32_FLOPS_PER_S * 1e3)
    assert pfnn.walk_flops(**SHAPES) == 3 * 2 * 4787860


def test_roofline_reads_the_frames_kernels():
    """The frames' GEMMs alone: neither the controller's kernels in the
    frame nor a GEMM outside it."""
    want = 100.0 * pfnn.net_bound_ms(2, 342, 512, 311, 4) * 3 / (1200 / 1e6)
    got = harness.reader("pfnn_net_roofline.pfnn")(dict(RECORD))
    assert got == pytest.approx(want, rel=1e-12)


def test_roofline_prefers_net_spans():
    program = dict(PROGRAM, spans=PROGRAM["spans"] + [
        _span(40, "pfnn.net", 1045, 1070, 20)])
    got = harness.reader("pfnn_net_roofline.pfnn")(dict(RECORD,
                                                        program=program))
    want = 100.0 * pfnn.net_bound_ms(2, 342, 512, 311, 4) / (400 / 1e6)
    assert got == pytest.approx(want, rel=1e-12)


def test_step_host_ms_and_mfu():
    # the window's one walk: 60 ns over 3 frames
    assert harness.reader("pfnn_step_host_ms.pfnn")(dict(RECORD)) == \
        pytest.approx(60 / 3 / 1e6)
    mfu = harness.reader("pfnn_mfu.pfnn")(dict(RECORD))
    assert mfu == pytest.approx(100.0 * 6 * 4787860 / (
        0.01 * peaks.FP32_FLOPS_PER_S))


def test_gather_ms_and_idle():
    # the window's gathers after the first: 6 and 10 ns
    assert harness.reader("crowd_gather_ms.crowd4")(dict(RECORD)) == \
        pytest.approx(8 / 1e6)
    # busy from 1060 to 1660 of the window's 1000 ns
    assert harness.reader("device_idle.pfnn")(dict(RECORD)) == \
        pytest.approx(100.0 * (1 - 600 / 1000))


@pytest.mark.parametrize("name", ["pfnn_net_roofline.pfnn",
                                  "pfnn_step_host_ms.pfnn", "pfnn_mfu.pfnn",
                                  "crowd_gather_ms.crowd4"])
def test_readers_find_nothing_without_the_program(name):
    """A program without these spans (the parent's) reads None."""
    rec = dict(RECORD, program=None, shapes={})
    assert harness.reader(name)(rec) is None


def _tiny(cell, traffic, traced):
    spec = harness.cell_spec(helpers.bench(), cell)
    spec["traffic"] = dict(spec["traffic"], **traffic)
    helpers.torch.set_num_threads(2)
    return harness.run(cell, 3000000019, 0.05, traced, "cpu",
                       helpers.bench(), spec)


def test_pfnn_cell_runs_tiny():
    res = _tiny("pfnn_holden.crowd_paths",
                dict(characters=6, frames=20, judged=4), traced=True)
    assert res["correct"], res["checks"]
    assert {"pfnn_step_host_ms.pfnn", "pfnn_mfu.pfnn"} <= set(
        res["metrics"])


def test_four_rank_crowd_runs_tiny():
    res = _tiny("ref_walk.crowd_root_4card",
                dict(characters=8, steps=3, judged=4, ranks=4), traced=True)
    assert res["correct"], res["checks"]
    assert "crowd_gather_ms.crowd4" in res["metrics"]

"""Operation and byte counts against values worked out by hand."""

import pytest
import torch

from portbench.counts import b1, emit, peaks, walk


def test_b1_bound_at_the_crowd_shape():
    # bytes: 4 x (operator 1024*19*8*26 + latents 1024*128*25 + tables
    # 1024*264*5 + cfg 1024*48 + errors 1024*128) = 35,422,208; operations:
    # 9 a table row + 2*26 a coefficient of 60 frame rows per candidate.
    # At 432,495,040 rows read (chip_smoke's inputs) the bound is its
    # 0.0642 ms, set by the operations
    flops, n_bytes = b1.count(1024, 128, 25, 264, 48, 432_495_040)
    assert n_bytes == 35_422_208
    assert flops == 9 * 432_495_040 + 408_944_640
    assert b1.bound_ms(1024, 128, 25, 264, 48, 432_495_040) == \
        pytest.approx(0.0642, rel=1e-6)
    # with no row read the bytes bound it: 35,422,208 / 3.35e12 s
    assert b1.bound_ms(1024, 128, 25, 264, 48, 0) == pytest.approx(
        35_422_208 / 3.35e12 * 1e3)


def _table_case(x0: float):
    """One character, one candidate whose 16 trajectory points all sit at
    (x0, 0, 0); a table of 8 rows at x = 0..7, arcs 0..7."""
    mop = torch.zeros((1, 19 * 8, 26))
    for f in range(2, 18):
        mop[0, f * 8, 25] = x0
    table = torch.zeros((1, 8, 5))
    table[0, :, 0] = torch.arange(8.0)
    table[0, :, 3] = torch.arange(8.0)
    table[0, :, 4] = 1.0
    cfg = torch.zeros((1, 48))
    cfg[0, 4] = 1.0  # cos of the start heading (no previous clip)
    cfg[0, 22] = cfg[0, 24] = 1.0  # x and z constrained
    cfg[0, 28] = 7.0  # the path's end arc
    return mop, torch.zeros((1, 1, 25)), table, cfg


def test_b1_rows_read_follow_the_advancing_floor():
    # at x = 0 every search reads all 8 rows and stays at arc 0
    assert b1.rows_read(*_table_case(0.0)) == 16 * 8
    # at x = 3 the first reads 8 and moves the floor to arc 3; the other
    # 15 read the 5 rows at arcs 3..7
    assert b1.rows_read(*_table_case(3.0)) == 8 + 15 * 5


def test_emit_bound_at_the_cells_shapes():
    # clips 1024*160*79 + times 1024*160 + latents 1024*25 + node tables
    # 4*16*79*(25 + 1) + knots 4*20 + ids and counts 2*1024 + last frames
    # 1024*79, x4 = 53,389,120 B; the previous clips 1024*79*4 more
    flops, n_bytes = emit.count(1024, 160, 25, 4, 16, 79, True)
    assert n_bytes == 53_389_120 + 323_584
    assert emit.bound_ms(1024, 160, 25, 4, 16, 79, True) == pytest.approx(
        53_712_704 / 3.35e12 * 1e3)
    assert emit.bound_ms(1024, 160, 25, 4, 16, 79, True) == pytest.approx(
        0.0160, abs=1e-4)  # PERF.md's kernel table
    assert emit.count(8192, 160, 25, 4, 16, 79, False)[1] == 4 * (
        8192 * 25 + 4 * 16 * 79 * 25 + 4 * 16 * 79 + 4 * 20 + 2 * 8192
        + 8192 * 160 + 8192 * 160 * 79 + 8192 * 79)


def test_walk_counts():
    # one character, one step, one latent: see test_portbench_metrics
    assert walk.segments_flops(1, 1, 1, 1, 2, 1, 7, 1, 2, 3, 20) == 651
    crowd = walk.crowd_flops(c=1024, steps=8, n=128, k=25, l_dim=28,
                             n_comp=5, nb=16, d=79, m=4, t=160, g1=257,
                             lm_iters=3, b1_flops=0.0)
    # ~10 GFLOP a walk besides the selection: ~1e-3 of the fp32 peak
    # for a walk of a second, so the share reads far below 100%
    assert 1e9 < crowd < 1e11
    assert crowd / peaks.FP32_FLOPS_PER_S < 1e-3
